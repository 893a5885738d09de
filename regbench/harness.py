"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the result line.

Everything a cell is made of is found by name from its own file:
``BENCHMARK.json`` names the cell's configuration (``configs/<name>.json``),
traffic mix (``traffic/<name>.json``) and metrics (``metrics/<name>.py``,
each with ``read(run)``); the cell's limits are ``limits/<cell>.json``.
The entry a mix drives is one of :data:`ENTRIES`, by the mix's ``entry``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import scenes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "plade_tpu")


class Refused(Exception):
    """A run that may print no result; ``code`` is its exit code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class Spec:
    """A cell and what it is made of."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_held(modules) -> list[str]:
    """The :data:`FORBIDDEN` top-level names among ``modules``, each
    module's top-level name (before its first dot) compared whole:
    ``plade_tpu_torch`` is not ``plade_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix, limits and metrics."""
    bench = _json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise Refused(2, f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in names)]
    return Spec(cell, _json(HERE / "configs" / f"{cell['config']}.json"),
                _json(HERE / "traffic" / f"{cell['traffic']}.json"),
                _json(HERE / "limits" / f"{workload}.json"), e2e, per_layer)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"regbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def derive_seed(*words: int) -> int:
    """A 31-bit seed from whole numbers (any size, not negative)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1)
    return int(state[0]) & 0x7FFFFFFF


# -- entries ----------------------------------------------------------------

class ArrayPairs:
    """``dist.mesh.register_array_pairs`` on a list of raw pairs, in
    lockstep ``batch_pairs`` at a time a shard: on ``device``, or with the
    mix's ``mesh`` on ``make_mesh`` over the cell's cards (``devices`` to
    name them otherwise).  No target/source swap."""
    swaps = False

    def __init__(self, cfg, traffic, chips, device, devices=None):
        from plade_tpu_torch.dist import mesh
        self.fn = mesh.register_array_pairs
        self.cfg = cfg
        self.batch_pairs = traffic["batch_pairs"]
        if traffic.get("mesh"):
            self.where = {"mesh": mesh.make_mesh(n_devices=chips,
                                                 devices=devices)}
        else:
            self.where = {"device": device}

    def __call__(self, pairs, seed):
        outs = self.fn([(p.tgt_points, p.tgt_normals, p.src_points,
                         p.src_normals) for p in pairs], self.cfg, seed,
                       batch_pairs=self.batch_pairs, **self.where)
        return [(np.asarray(o.transform), bool(o.success)) for o in outs]


class Clouds:
    """``pipeline.register_clouds`` on numpy arrays, one pair a call: the
    single mode of the command line without its file read.  A source at
    least ``swap_size_ratio`` times its target's size is swapped."""
    swaps = True

    def __init__(self, cfg, traffic, chips, device, devices=None):
        from plade_tpu_torch import pipeline
        self.fn = pipeline.register_clouds
        self.cfg = cfg
        self.device = device

    def __call__(self, pairs, seed):
        out = []
        for p in pairs:
            T, info = self.fn(p.tgt_points, p.tgt_normals, p.src_points,
                              p.src_normals, self.cfg, seed,
                              device=self.device)
            out.append((np.asarray(T), bool(info.get("success", False))))
        return out


ENTRIES = {"register_array_pairs": ArrayPairs, "register_clouds": Clouds}


# -- the stream of pairs ----------------------------------------------------

class Stream:
    """The pool's pairs in passes: position ``s`` is pool pair
    ``order[s % N]``, in the pool's order (``in_turn``) or in an order
    drawn from the run seed (``permuted``); call ``k`` takes the next
    ``per_call`` positions and registers with a seed drawn from the run
    seed and ``k`` (warm-up calls from a seed of their own)."""

    def __init__(self, pool_size: int, traffic: dict, seed: int):
        self.n = pool_size
        self.per_call = traffic["pairs_per_call"]
        self.seed = seed
        if traffic["order"] == "permuted":
            rng = np.random.default_rng(derive_seed(seed, 3))
            self.order = rng.permutation(pool_size).tolist()
        else:
            self.order = list(range(pool_size))

    def call(self, k: int) -> list[int]:
        lo = k * self.per_call
        return [self.order[s % self.n] for s in range(lo, lo + self.per_call)]

    def reg_seed(self, k: int, warmup: bool = False) -> int:
        return derive_seed(self.seed, 0 if warmup else 1, k)


@dataclasses.dataclass
class Run:
    """What a run measured: read by the metrics' ``read``."""
    setup_s: float = 0.0
    window_s: float = 0.0
    pairs: int = 0
    pair_latencies_s: list = dataclasses.field(default_factory=list)
    trace: object = None          # trace.Summary of a --trace 1 run


def _devices_used(traffic, chips, device) -> list[int]:
    """The indices of the cards a run uses: none for a run on the CPU."""
    import torch
    d = torch.device(device)
    if d.type != "cuda":
        return []
    return list(range(chips)) if traffic.get("mesh") else [d.index or 0]


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda:0", devices=None,
             check_fn=None):
    """Run cell ``spec`` for ``seconds`` from ``seed``; returns (result
    dict, check lines, :class:`Run`).  ``device`` places a one-device run
    and ``devices`` a mesh's shards (the CPU in the tests); ``check_fn``
    replaces :func:`check.check` (the readings of the limits)."""
    import torch

    from . import capture, check
    cap = capture.installed()
    from plade_tpu_torch.core import types
    from plade_tpu_torch.core.config import PladeConfig
    traffic, config = spec.traffic, spec.config
    chips = spec.cell["chips"]
    cfg = PladeConfig(**config["plade_config"])
    t_imports = time.perf_counter()
    pool = scenes.build_pool(config["pool"])
    t_pool = time.perf_counter()
    entry = ENTRIES[traffic["entry"]](cfg, traffic, chips, device, devices)
    stream = Stream(len(pool), traffic, seed)
    used = _devices_used(traffic, chips, device)

    def sync():
        for k in used:
            torch.cuda.synchronize(k)

    for k in range(traffic["warmup_calls"]):
        entry([pool[i] for i in stream.call(k)], stream.reg_seed(k, True))
    cap.take_spacing()
    sync()
    run = Run(setup_s=time.perf_counter() - t_start)
    print(f"[regbench] set-up {run.setup_s:.3f} s: imports "
          f"{t_imports - t_start:.3f}, pairs {t_pool - t_imports:.3f}, "
          f"warm-up {t_start + run.setup_s - t_pool:.3f}", file=sys.stderr)

    check_call = int(np.random.default_rng(derive_seed(seed, 2)).integers(
        traffic["check_calls"]))
    trace_from = traffic["trace_from_call"]
    trace_end = trace_from + traffic["trace_calls"]
    least_calls = max(check_call + 1, trace_end if trace else 0)
    for k in used:
        torch.cuda.reset_peak_memory_stats(k)
    types.HOST_SYNCS["count"] = 0
    records, spacings, stretch, live, error = [], [], None, [], None
    captured = False
    t0 = time.perf_counter()
    k = 0
    while True:
        if trace and k == trace_from:
            from .trace import Stretch
            stretch = Stretch().__enter__()
            stretch_pairs = run.pairs
        idx = stream.call(k)
        # from the drawn call on, until a call has launched K1 or K2
        cap.armed = k >= check_call and not captured
        cap.tracing = stretch is not None and k < trace_end
        ta = time.perf_counter()
        try:
            outs = entry([pool[i] for i in idx], stream.reg_seed(k))
        except Exception:       # a pair that raised is a failed pair
            if error is None:
                error = traceback.format_exc()
            outs = [None] * len(idx)
        tb = time.perf_counter()
        cap.armed = cap.tracing = False
        captured = captured or bool(cap.launches)
        # an answer short of its pairs leaves the rest unanswered
        outs = (list(outs) + [None] * len(idx))[:len(idx)]
        records += list(zip(idx, outs))
        spacings.append((idx, cap.take_spacing()))
        if len(idx) == 1:
            run.pair_latencies_s.append(tb - ta)
        run.pairs += len(idx)
        k += 1
        if stretch is not None and k == trace_end:
            stretch.__exit__(None, None, None)
            stretch_pairs = run.pairs - stretch_pairs
            live = cap.take_live()
        if tb - t0 >= seconds and k >= least_calls:
            break
    run.window_s = tb - t0
    host_syncs = types.HOST_SYNCS["count"]
    peak = max((torch.cuda.max_memory_allocated(d) for d in used),
               default=0)
    held = forbidden_held(sys.modules)
    if held:
        raise Refused(4, f"the run holds the modules {held} after its "
                         "window")
    if error is not None:
        print(f"[regbench] a call raised:\n{error}", file=sys.stderr)

    launches = cap.take_launches()
    if stretch is not None:
        from .trace import summarize
        s = summarize(stretch.events, live)
        del stretch
        s.pairs, s.host_syncs, s.window_pairs = stretch_pairs, host_syncs, \
            run.pairs
        s.peak_bytes = peak
        s.busy_s.update({d: 0.0 for d in used if d not in s.busy_s})
        run.trace = s
        for name, table in (("device", s.device_ms), ("host", s.wall_ms)):
            print(f"[regbench] stretch of {s.pairs} pairs, {name} ms by "
                  f"range: {json.dumps(table)}", file=sys.stderr)
    ref_device = f"cuda:{used[0]}" if used else "cpu"
    lines = (check_fn or check.check)(
        records, spacings, launches, pool, config, spec.limits, seed,
        ref_device, entry.swaps)

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(records)
    failed = sum(check.failed(out) for _, out in records)
    dev = {"platform": "gpu" if used else "cpu",
           "kind": torch.cuda.get_device_name(used[0]) if used else "cpu",
           "count": len(used), "memory_peak_bytes": int(peak)}
    result = {"correct": all(ok for *_, ok in lines),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_mean_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim, _ in lines}
    return result, lines, run
