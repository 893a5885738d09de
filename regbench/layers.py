"""What the per-layer metrics (``metrics/*.py``) read from a traced run's
:class:`trace.Summary`: device and host time by the pipeline's stages, per
pair of the traced stretch.  Every reader returns None where its run has
no trace or the trace holds nothing of its layer."""
from __future__ import annotations

#: the stages of the registration core (descriptors/, match/, verify/,
#: refine/), by their ``plade.*`` ranges
CORE = ("plade.descriptors", "plade.match", "plade.cluster",
        "plade.consistency", "plade.penetration", "plade.overlap",
        "plade.rescore", "plade.icp")


def _per_pair(run, table: str, names) -> float | None:
    t = run.trace
    if t is None or not t.pairs:
        return None
    got = [getattr(t, table)[n] for n in names if n in getattr(t, table)]
    return sum(got) / t.pairs if got else None


def device_ms_per_pair(run, names) -> float | None:
    """Device milliseconds a pair of operations launched inside the
    ranges ``names``."""
    return _per_pair(run, "device_ms", names)


def wall_ms_per_pair(run, names) -> float | None:
    """Host milliseconds a pair inside the ranges ``names``."""
    return _per_pair(run, "wall_ms", names)


def host_syncs_per_pair(run) -> float | None:
    """Host reads of device values a pair, over the whole window."""
    t = run.trace
    return None if t is None or not t.window_pairs \
        else t.host_syncs / t.window_pairs


def idle_pct(run) -> float | None:
    """The share of the stretch in which the device ran nothing, averaged
    over the cards used."""
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_mean_s / t.window_s)


def roofline_pct(run, kind: str) -> float | None:
    """K1 (``kind`` "k1") or K2's share of its roofline: the least time
    its launches' live rows need at the card's peaks over the device time
    of the operations they launched."""
    t = run.trace
    if t is None or not t.kernel_least_s.get(kind):
        return None
    ms = t.device_ms.get(f"regbench.{kind}")
    return 100.0 * t.kernel_least_s[kind] / (ms / 1e3) if ms else None
