"""Spans, counters and profiling hooks (``plade_tpu/utils/timing.py``).

The counterpart of the reference's ``StopWatch`` wall timers
(code/PLADE/util.cpp:1682-1765, used around every pipeline stage at
plade.cpp:72,542,577) and console progress bar (util.cpp:1651-1669), and
the port's one recorder of where the host spends its time:

* :class:`stage` is a span.  It adds its count, its duration and its self
  time (the duration less what its child spans in the same thread cover)
  to process-wide totals (:func:`stage_report`) and to the record of the
  call it belongs to.  Device work is asynchronous: a span measures the
  host, and waits for a card only when it is given ``sync``.
* :func:`call` opens the root span ``call`` of an outermost entry call
  (``register_array_pairs``, ``register_clouds``, ...).  Its record holds
  every span's count, total and self time and the call's counters
  (:func:`count`, :func:`host_read`); :func:`calls` returns the records of
  the last :data:`MAX_CALLS` calls.  A shard thread credits its spans to
  the call that started it (:func:`joined`).
* While a profiler records, every span is also a ``torch.profiler`` range:
  ``plade.<name>`` for the pipeline's stages (:data:`STAGES`, the ranges
  the benchmark attributes device time by) and ``plade:<name>`` for every
  other span, so that a stage's device time is never taken by a range
  nested inside it.  With no profiler no range is entered.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any

import torch
import torch.autograd.profiler as _autograd_profiler

#: the pipeline's stages, whose spans are the profiler ranges
#: ``plade.<name>``; every other span's range is ``plade:<name>``
STAGES = frozenset({"extract", "spacing", "prepare", "descriptors", "match",
                    "cluster", "consistency", "penetration", "overlap",
                    "rescore", "icp"})
#: the calls :func:`calls` keeps, the oldest dropped first
MAX_CALLS = 4096

#: spans end and counters count in the threads of a mesh's shards too
_lock = threading.Lock()
#: name -> [count, total ns, self ns, last ns], over the process
_totals: dict[str, list[int]] = {}
_calls: collections.deque = collections.deque(maxlen=MAX_CALLS)
_ids = itertools.count(1)


class _Thread(threading.local):
    top = None      # the innermost open span of this thread
    call = None     # the call this thread's spans are credited to


_here = _Thread()


def profiling() -> bool:
    """Whether a profiler records: PyTorch's process-wide flag, which
    ``torch.profiler`` sets in every mode (``_profiler_enabled`` alone
    reads False under ``profile_all_threads``), or the C++ profiler's
    state in this thread."""
    return _autograd_profiler._is_profiler_enabled \
        or torch._C._autograd._profiler_enabled()


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
        return _time_string(self.elapsed_seconds())


def _time_string(s: float) -> str:
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


class Call:
    """One outermost entry call: its spans (name -> [count, total ns, self
    ns, host reads made while the span was innermost]) and counters, added
    to by every thread that joins it."""
    __slots__ = ("id", "entry", "pairs", "profiled", "spans", "counters")

    def __init__(self, entry: str, pairs: int):
        self.id = next(_ids)
        self.entry = entry
        self.pairs = pairs
        self.profiled = profiling()
        self.spans: dict[str, list[int]] = {}
        self.counters: dict[str, int] = {}

    def record(self) -> dict:
        with _lock:
            return {"id": self.id, "entry": self.entry, "pairs": self.pairs,
                    "profiled": self.profiled,
                    "spans": {name: {"count": c, "total_ns": t,
                                     "self_ns": s, "host_reads": r}
                              for name, (c, t, s, r) in self.spans.items()},
                    "counters": dict(self.counters)}


class stage:
    """``with stage(name) as out:`` records a span (see the module).
    Before the clock stops, it waits for every card that holds a tensor
    of ``sync`` (or of ``out["sync"]``, set on the dict the block
    receives), so that the span's device work is included; ``verbose``
    prints the span's time."""
    __slots__ = ("name", "sync", "verbose", "out", "t0", "child", "parent",
                 "call", "range")

    def __init__(self, name: str, *, sync: Any = None,
                 verbose: bool = False):
        self.name = name
        self.sync = sync
        self.verbose = verbose

    def __enter__(self) -> dict:
        self.parent = _here.top
        _here.top = self
        self.call = _here.call
        self.child = 0
        self.range = None
        if profiling():
            prefix = "plade." if self.name in STAGES else "plade:"
            self.range = torch.profiler.record_function(prefix + self.name)
            self.range.__enter__()
        self.out = {}
        self.t0 = time.perf_counter_ns()
        return self.out

    def __exit__(self, *exc):
        try:
            sync = self.out.get("sync", self.sync)
            if sync is not None:
                for device in _cuda_devices(sync):
                    torch.cuda.synchronize(device)
        finally:
            dt = time.perf_counter_ns() - self.t0
            if self.range is not None:
                self.range.__exit__(*exc)
            _here.top = self.parent
            if self.parent is not None:
                self.parent.child += dt
            own = dt - self.child
            with _lock:
                t = _totals.get(self.name)
                if t is None:
                    t = _totals[self.name] = [0, 0, 0, 0]
                t[0] += 1
                t[1] += dt
                t[2] += own
                t[3] = dt
                if self.call is not None:
                    s = self.call.spans.get(self.name)
                    if s is None:
                        s = self.call.spans[self.name] = [0, 0, 0, 0]
                    s[0] += 1
                    s[1] += dt
                    s[2] += own
        if self.verbose:
            print(f"[plade] {self.name}: {_time_string(dt / 1e9)}",
                  flush=True)
        return False


@contextlib.contextmanager
def call(entry: str, pairs: int):
    """The root span ``call`` of entry ``entry`` registering ``pairs``
    pairs, and its record, appended to :func:`calls` when it ends (also
    when it raises).  Inside a call this thread already has open (an entry
    that calls another), it opens nothing."""
    if _here.call is not None:
        yield _here.call
        return
    c = Call(entry, pairs)
    _here.call = c
    try:
        with stage("call"):
            yield c
    finally:
        _here.call = None
        rec = c.record()
        with _lock:
            _calls.append(rec)


def current_call() -> Call | None:
    """The call this thread's spans are credited to, to hand to the
    threads it starts (:func:`joined`)."""
    return _here.call


@contextlib.contextmanager
def joined(c: Call | None):
    """Credit this thread's spans and counters to ``c`` (the call that
    started the thread; None credits them to none)."""
    prev = _here.call
    _here.call = c
    try:
        yield
    finally:
        _here.call = prev


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of this thread's call."""
    c = _here.call
    if c is not None:
        with _lock:
            c.counters[name] = c.counters.get(name, 0) + n


def host_read():
    """Count one read of a device value by the host: ``host_reads`` of
    this thread's call, and of its innermost span there."""
    c = _here.call
    if c is None:
        return
    top = _here.top
    with _lock:
        c.counters["host_reads"] = c.counters.get("host_reads", 0) + 1
        if top is not None:
            s = c.spans.get(top.name)
            if s is None:
                s = c.spans[top.name] = [0, 0, 0, 0]
            s[3] += 1


def calls() -> list[dict]:
    """The records of the last :data:`MAX_CALLS` calls, oldest first:
    ``id``, ``entry``, ``pairs``, ``profiled`` (a profiler recorded at the
    call's start), ``spans`` (name -> ``count``, ``total_ns``,
    ``self_ns``, ``host_reads``) and ``counters`` (name -> count)."""
    with _lock:
        return list(_calls)


def stage_report(reset: bool = False) -> dict[str, dict[str, float]]:
    """Every span's totals over the process, in seconds:
    {name: {count, total, mean, last, self}}."""
    with _lock:
        rep = {name: {"count": c, "total": t / 1e9, "mean": t / c / 1e9,
                      "last": last / 1e9, "self": s / 1e9}
               for name, (c, t, s, last) in _totals.items()}
        if reset:
            _totals.clear()
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
