"""A bounded profiler stretch and its reduction to what the per-layer
metrics read.

:class:`Stretch` profiles a fixed number of calls (``torch.profiler``,
host and device activity) inside ``regbench.stretch``, writes the Chrome
trace to a temporary directory under ``TMPDIR``, reads it back and deletes
it.  :func:`summarize` reduces the events to a :class:`Summary`:

* the device's busy time: the union of its kernels', copies' and sets'
  intervals inside the stretch, per device (overlapping streams counted
  once);
* device time by host range: each device operation goes to the innermost
  ``plade.*`` (pipeline stage) and ``regbench.*`` (K1/K2 launch) range of
  the thread that launched it (matched by correlation id);
* host wall by range name, and kernel counts;
* the breakdown: the device operations that took most time, and the
  device's idle gaps by the ``plade.*`` range the host was in.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict

import torch

from . import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STRETCH = "regbench.stretch"
#: the ranges device time is attributed by: pipeline stages, K1/K2 launches
PREFIXES = ("plade.", "regbench.k")


@dataclasses.dataclass
class Summary:
    """What one traced stretch read."""
    pairs: int = 0
    window_s: float = 0.0
    busy_s: dict = dataclasses.field(default_factory=dict)  # device -> s
    device_ms: dict = dataclasses.field(default_factory=dict)  # range -> ms
    wall_ms: dict = dataclasses.field(default_factory=dict)    # range -> ms
    kernels: int = 0
    kernel_least_s: dict = dataclasses.field(default_factory=dict)
    host_syncs: int = 0         # over the whole window
    window_pairs: int = 0       # pairs of the whole window
    peak_bytes: int = 0         # over the whole window, the fullest card
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)

    @property
    def busy_mean_s(self) -> float:
        """Busy seconds averaged over the devices the stretch used."""
        return (sum(self.busy_s.values()) / len(self.busy_s)
                if self.busy_s else 0.0)


class Stretch:
    """``with Stretch() as s: ...`` profiles the block; ``s.events`` then
    holds the trace's complete events."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             **_all_threads())
        self._prof.__enter__()
        self._range = torch.profiler.record_function(STRETCH)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)
        self.wall_s = time.perf_counter() - self.t0
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        tmp = tempfile.mkdtemp(prefix="regbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f)["traceEvents"]
                               if e.get("ph") == "X"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return False


def _all_threads() -> dict:
    """The profiler option that records the ranges of every host thread
    (a mesh's shards run in threads of their own), where this PyTorch has
    it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _device_of(e) -> int:
    args = e.get("args", {})
    dev = args.get("device", e.get("pid", 0))
    try:
        return int(dev)
    except (TypeError, ValueError):
        return 0


class _Ranges:
    """The host ranges of one thread whose names start with one prefix
    (nested or disjoint), for innermost-range lookups."""

    def __init__(self, spans):
        self.spans = sorted(spans)          # (start, end, name)
        self.starts = [s for s, _, _ in self.spans]

    def innermost(self, ts: float):
        """The name of the latest-started range that holds ``ts``."""
        for k in range(bisect.bisect_right(self.starts, ts) - 1, -1, -1):
            start, end, name = self.spans[k]
            if end >= ts:
                return name
        return None


def summarize(events, live=(), top: int = 10) -> Summary:
    """Reduce a stretch's events (:attr:`Stretch.events`) and the K1/K2
    launches' live rows (``Capture.take_live``) to a :class:`Summary`
    (``pairs``, ``host_syncs``, ``window_pairs`` and ``peak_bytes`` are the
    caller's)."""
    stretch = [e for e in events if e.get("name") == STRETCH]
    if not stretch:
        raise RuntimeError("the trace holds no regbench.stretch range")
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    spans = defaultdict(list)
    wall = defaultdict(float)
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and (
                name.startswith("plade.") or name.startswith("regbench.")):
            s, d = float(e["ts"]), float(e["dur"])
            spans[e.get("tid")].append((s, s + d, name))
            if name != STRETCH:
                wall[name] += d / 1e3
    ranges = {(tid, p): _Ranges([x for x in v if x[2].startswith(p)])
              for tid, v in spans.items() for p in PREFIXES}
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
    busy = defaultdict(list)
    launches_by = defaultdict(lambda: defaultdict(int))   # device -> tid
    device_ms = defaultdict(float)
    by_name = defaultdict(float)
    kernels = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        a, b = max(s, lo), min(t, hi)
        if b <= a:
            continue
        busy[_device_of(e)].append((a, b))
        by_name[e.get("name", "?")] += (b - a) / 1e6
        kernels += e.get("cat") == "kernel"
        ts, tid = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        if ts is None:
            continue
        launches_by[_device_of(e)][tid] += 1
        for prefix in PREFIXES:
            r = ranges.get((tid, prefix))
            name = r.innermost(ts) if r is not None else None
            if name is not None:
                device_ms[name] += (b - a) / 1e3
    out = Summary(window_s=(hi - lo) / 1e6,
                  busy_s={d: yardstick.union_length(v) / 1e6
                          for d, v in busy.items()},
                  device_ms=dict(device_ms), wall_ms=dict(wall),
                  kernels=kernels)
    least = defaultdict(float)
    for kind, q, r in live:
        least[kind] += yardstick.least_seconds(
            *yardstick.launch_work(kind, q, r))
    out.kernel_least_s = dict(least)
    launcher = {d: max(c, key=c.get) for d, c in launches_by.items()}
    out.device_ops = sorted(([k[:160], v] for k, v in by_name.items()),
                            key=lambda x: -x[1])[:top]
    out.idle_gaps = _idle_by_range(busy, ranges, launcher, lo, hi, top)
    return out


def _idle_by_range(busy, ranges, launcher, lo, hi, top):
    """The devices' idle gaps inside [lo, hi], summed by the innermost
    ``plade.*`` range, at each gap's start, of the host thread that
    launched most of that device's work (a mesh's shard threads)."""
    idle = defaultdict(float)
    for device, intervals in busy.items():
        r = ranges.get((launcher.get(device), "plade."))
        for a, b in yardstick.gaps(intervals, lo, hi):
            name = r.innermost(a) if r is not None else None
            idle[name or "(host outside plade ranges)"] += (b - a) / 1e6
    return sorted(([k, v] for k, v in idle.items()),
                  key=lambda x: -x[1])[:top]
