"""What the per-layer metrics of the program's own recorder
(``plade_tpu_torch.utils.timing``: spans and counters a call) read of a
run's window.

The window's calls are the last records of ``timing.calls()`` whose pairs
add up to the window's; the calls a profiler recorded (the traced
stretch) are left out, so what is read is the program at its untraced
speed.  Every reader returns None where the program has no recorder, the
records do not add up to the window, or they hold nothing of what it
reads; it never raises.
"""
from __future__ import annotations


def window_calls(run) -> list[dict] | None:
    """The records of the window's calls that no profiler recorded, or
    None."""
    try:
        from plade_tpu_torch.utils import timing
        records = timing.calls()
    except (ImportError, AttributeError):
        return None
    got, pairs = [], 0
    for rec in reversed(records):
        if pairs >= run.pairs:
            break
        got.append(rec)
        pairs += rec.get("pairs", 0)
    if not run.pairs or pairs != run.pairs:
        return None
    return [r for r in got if not r.get("profiled")] or None


def _per_pair(run, value) -> float | None:
    """The sum over the window's calls of ``value(record)`` (None where
    the record holds nothing of it) over their pairs."""
    recs = window_calls(run)
    if recs is None:
        return None
    got = [value(r) for r in recs]
    if all(v is None for v in got):
        return None
    return sum(v or 0 for v in got) / sum(r["pairs"] for r in recs)


def _span_ns(rec, names) -> int | None:
    spans = rec.get("spans", {})
    got = [spans[n]["total_ns"] for n in names if n in spans]
    return sum(got) if got else None


def span_ms_per_pair(run, names, less=()) -> float | None:
    """Host milliseconds a pair in the spans ``names``, less the time of
    the spans ``less`` (nested inside them)."""
    def value(rec):
        ns = _span_ns(rec, names)
        return None if ns is None else ns - (_span_ns(rec, less) or 0)
    v = _per_pair(run, value)
    return None if v is None else v / 1e6


def counter_per_pair(run, name) -> float | None:
    """The counter ``name`` a pair."""
    return _per_pair(run, lambda rec: rec.get("counters", {}).get(name))


def counter_pct(run, part, whole) -> float | None:
    """100 x the counter ``part`` over the counter ``whole``, summed over
    the window's calls."""
    recs = window_calls(run)
    if recs is None:
        return None
    p = sum(r.get("counters", {}).get(part, 0) for r in recs)
    w = sum(r.get("counters", {}).get(whole, 0) for r in recs)
    return 100.0 * p / w if w else None
