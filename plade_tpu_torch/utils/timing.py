"""Stage timing and profiling hooks (``plade_tpu/utils/timing.py``).

The counterpart of the reference's ``StopWatch`` wall timers
(code/PLADE/util.cpp:1682-1765, used around every pipeline stage at
plade.cpp:72,542,577) and console progress bar (util.cpp:1651-1669).
Device work is asynchronous, so a stage timer that is to include it waits
for the cards of the stage's outputs (``torch.cuda.synchronize``) before it
stops the clock; ``torch.profiler`` traces give the kernel-level view.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Any

import torch

_records: dict[str, list[float]] = defaultdict(list)
#: stages may end in the threads of a mesh's shards
_lock = threading.Lock()


class StopWatch:
    """Wall timer with the reference's human-readable formatting
    (util.cpp:1736-1765)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def elapsed_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def time_string(self) -> str:
        s = self.elapsed_seconds()
        if s < 1e-3:
            return f"{s * 1e6:.0f} us"
        if s < 1.0:
            return f"{s * 1e3:.1f} ms"
        if s < 60.0:
            return f"{s:.2f} s"
        m, sec = divmod(s, 60.0)
        if m < 60:
            return f"{int(m)} m {sec:.1f} s"
        h, m = divmod(m, 60.0)
        return f"{int(h)} h {int(m)} m {sec:.0f} s"


def _cuda_devices(tree: Any) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, or lists,
    tuples, NamedTuples and dicts of them)."""
    if torch.is_tensor(tree):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree))
    return set()


@contextlib.contextmanager
def stage(name: str, *, sync: Any = None, verbose: bool = False):
    """Time a pipeline stage.  Before the clock stops, it waits for every
    card that holds a tensor of ``sync`` (or of ``out["sync"]``, set on the
    dict the block receives), so that the stage's device work is
    included."""
    w = StopWatch()
    out: dict[str, Any] = {}
    try:
        yield out
    finally:
        for device in _cuda_devices(out.get("sync", sync)):
            torch.cuda.synchronize(device)
        dt = w.elapsed_seconds()
        with _lock:
            _records[name].append(dt)
        if verbose:
            print(f"[plade] {name}: {w.time_string()}", flush=True)


def stage_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """Summary of recorded stage timings: {name: {count,total,mean,last}}."""
    with _lock:
        rep = {name: {"count": len(xs), "total": sum(xs),
                      "mean": sum(xs) / len(xs), "last": xs[-1]}
               for name, xs in _records.items()}
        if reset:
            _records.clear()
    return rep


def print_progress(fraction: float, width: int = 50):
    """Console progress bar (reference print_progress, util.cpp:1651-1669)."""
    fraction = min(max(fraction, 0.0), 1.0)
    n = int(fraction * width)
    bar = "#" * n + "-" * (width - n)
    print(f"\r[{bar}] {fraction * 100.0:5.1f}%", end="", flush=True)
    if fraction >= 1.0:
        print(flush=True)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """A ``torch.profiler`` trace around a block (CPU activity, and CUDA
    activity where a card is visible), written as a Chrome trace to
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
