"""Smoke run of the PyTorch/CUDA port (``plade_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--parent DIR]

(``--mesh-worker RANK WORLD ADDR DIR`` runs one rank of phase (p)'s
2-process world; the script starts those itself.)

Phases, in order; any failed check exits non-zero.  On the card each pass
of extraction is a replay of its CUDA graph, which calls no Python
wrapper: every phase reads K3's launches as counted at each replay, once
a pass, and the phases that need K3's inputs or lanes take them from one
more run with extraction's eager loop (``eager_k3_calls``), whose
extractions must be the main path's bits:

(a) build the CUDA kernels from ``plade_tpu_torch/csrc``;
(b) hold each kernel against its plain PyTorch version on the card, bit
    for bit: K2 (d2 and argmin) and K1 at the main path's shapes (K2
    131072 x 16384 and, for the final ICP, 16384 x 16384, K1 131072 x 16384
    and 262144 x 16384) and at edge
    shapes (ragged Q and T, Q = 1, T = 1, and small Q against 200000
    references, the finest reference split), with BIG-padded rows, a query
    whose normal disagrees with every reference normal (+inf row) and a
    copy of one reference in every reference slice (the lowest index must
    win across the kernels' atomic merge); time each at the main shapes
    beside its plain version, its bound and, for K2, the yardstick
    ``torch.cdist(q, r).min(dim=1)``; the same for the batched main path's
    shapes with a pair axis of 8 (K2 8 x 131072 x 16384 and 8 x 16384 x
    16384, K1 8 x 131072 x 16384 and 8 x 262144 x 16384: one launch for
    all pairs, each pair also bit for bit its own unbatched launch; the
    library yardstick ``cdist`` + ``min`` pair by pair); K4 (the spacing's
    top-k) bit for bit at the spacing's shapes in the benchmark's cells
    (8 x 10000 x 131072, 8 x 10000 x 65536, 1 x 10000 x 65536, the queries
    strided samples of BIG-padded clouds as ``average_spacing`` draws them)
    at k = 1, 6 and 16, the spacing through it, one launch a call, each
    shape timed at k = 6 beside its plain version, the yardstick
    ``torch.cdist`` + ``torch.topk`` in the plain version's blocks, its
    bound, its issue ceiling and its registers (ptxas); K5 (the
    penetration walk) on the tests of real registrations
    (``WALK_CELLS``: the first 8 pool pairs of ``resso60k`` and of
    ``tls131k`` in one lockstep batch each, ``resso60k``'s first through
    ``register_clouds``), each run one ``run_tests`` call and one launch
    with the counts reset before it, its verdicts and each test's four
    counts bit for bit the plain walk's, no host read, timed beside the
    plain walk, with its bound over the live tests' live points and its
    registers.  With
    ``--parent DIR`` (a checkout of
    the parent tree), also build DIR's ``csrc/nn.cu`` and ``csrc/cc.cu``
    and time its K1/K2/K3 against this tree's in turns on the same inputs
    (same bits required).  K3 (close + connected-component labelling) bit
    for bit at 256 rounds: at G = 32, 48 and 128 on L = 6 and at G = 64 on
    L = 6 and 12, on random occupancies, an empty and a full grid and a
    serpentine grid that 256 rounds do not converge; K3' at L = 1; each
    timed as calls queued back to back, with the rounds its lanes
    need, its bound and its chain bound (the slowest lane's rounds on one
    SM at the SM clock nvidia-smi reads under it, and at the rate of
    K3's packed 16-bit minimum that a probe measures on one SM);
(c) register a synthetic room (two disjoint halves of 96k points, the
    source moved by a known rigid transform, planes labelled from the
    generator planes) with ``register_with_planes`` at the default
    ``PladeConfig``: one warm-up, then three timed runs; the kernel launch
    counts and host syncs are those of the first timed run;
(d) profile one more registration of that scene: device time per
    pipeline stage, kernels launched, the device's busy share;
(e) register a small scene on the card and on the CPU (plain kernel
    versions) and require the same result; extract its clouds' planes on
    the card and on the CPU from the same random draws and require the
    same planes;
(f) register the room of (c) from raw points with ``register_clouds`` at
    the default ``PladeConfig`` (plane extraction on the card): one
    warm-up, then three timed runs; the first timed run's extraction
    rounds and selected planes per cloud against the 12 planes of the
    scene, its kernel launches (K3 once per extraction round, K4 once at
    its spacing's shape) and host syncs, pose error and counters, the live downsampled points of both
    clouds and the rounds K3's lanes needed; then one call without
    ``device=``, which must launch the kernels (the default is the card);
    K3 on the grids of that run's launches: bit for bit against the plain
    version (and the parent's), each launch timed, both bounds, and with
    ``--parent`` the launches' sum in turns;
(g) write the scene as PLY files and require ``register_files`` to give
    the transform of ``register_clouds``;
(h) profile one ``register_clouds`` (its stage table has ``plade.extract``);
(i) the device step ``register_pair_device`` (both clouds extracted in
    lockstep, K3 at L = 12) on the scene of (c) at the default
    ``PladeConfig``: one warm-up, then three timed runs; the first timed
    run's extraction must equal (f)'s (plane counts, rounds, coefficients
    within 1e-4) and its transform (f)'s within 1e-4; pose error, counters,
    K3 launches (one per lockstep round, each at L = 12), host syncs and
    peak memory beside ``register_clouds``'; one profiled step (stage table
    and kernels per pair); K3 on the grids of that run's launches, as in
    (f);
(j) the step with ``enable_icp``: K2 launched 21 times at 16384 x 16384
    (the final ICP) after the rescore's 4, pose error and counters;
(k) the step with a line-confidence cull that drops part of the source's
    lines, the step with the degraded descriptor families (the cluster
    prefix widened to hold every hypothesis), and
    ``register_clouds`` with a pinned support: each within the pose limits,
    counters 0;
(l) ``dist.mesh.register_array_pairs`` on 4 distinct synthetic scan pairs
    (``make_scan_sequence`` at the settings of ``bench.py``'s batch pairs):
    every pair succeeds, in one lockstep batch (K2 4 launches, K3 one a
    lockstep round over 4 x 2 x 6 lanes);
(m) the command line at the default ``PladeConfig``: ``python -m
    plade_tpu_torch.cli T.ply S.ply OUT --profile DIR`` as a subprocess
    without ``--device`` on the room of (c) (exit 0, the result within the
    pose limits and within 1e-4 of (g)'s, K1, K2 and K3 kernel events in
    the trace), once more without ``--profile`` (the start-up cost), then
    ``cli.main`` in this process: single, ``--icp``, batch over the scan
    pairs of (l) sequentially and with ``--device-batch`` (one lockstep
    batch: K2 4 launches, K3 at L = 48), ``--device-batch --profile DIR``
    (the trace holds every ``plade.*`` range of the step and one kernel
    event for each counted K1/K2/K3 launch), and ``view`` to PLY and HTML,
    each within the pose limits with its launches counted;
(n) scene mode: 5 scans (``make_scan_sequence(rng(2000))`` at (l)'s
    settings with step 1.4), ``scene DIR OUT --loop-stride 2`` with
    ``--device-batch`` (its 7 pairs in one lockstep batch: K2 4 launches,
    K3 at L = 84) and sequentially: every scan's pose within the limits of
    the ground truth, and the pose graph solved on the card and on the CPU
    within 1e-4;
(o) ``dist.mesh.register_batch`` on the 8 pairs of ``bench.py``'s batch
    (pair 0 the room of (c), pairs 1-7 ``make_scan_sequence(rng(1000 +
    b))`` at (l)'s settings) at B = 8, 4, 2 and pair after pair (B = 1),
    one warm-up and three timed runs each, each fenced by a host read:
    every pair within the pose limits, each pair's transform within 1e-4
    of its B = 1 result with the same success; the wall per pair and the
    peak memory at each B, kernels and host syncs a batch, K1/K2/K3
    launches with their shapes (K2 4 launches at 8 x 131072 x 16384, K1
    over 8 pairs, K4 once at 8 x 10000 x the padded rows, K3 once a
    lockstep round at L = 96), the stage table of
    one profiled B = 8 batch (its ``plade.spacing`` range's kernels: K4,
    no product, sort or ``torch.topk``), K3 on that run's grids as in (f),
    and an
    ``enable_icp`` batch (K2 21 times at 8 x 16384 x 16384);
(p) pairs over a pairs axis (``dist/mesh.py``, ``dist/multihost.py``) on
    (o)'s 8 pairs.  Reproducibility: one B = 8 batch twice gives the same
    bits at every stage's outputs (and, for comparison, where two runs
    with the float scatter-sums as atomic ``index_add_`` first differ).
    ``register_array_pairs`` on a mesh of two shards on cuda:0 (4 pairs a
    shard in lockstep, each in a thread and on a stream of its own; each
    shard's K1/K2 launches told apart by stream, each shard's stream
    holding its pass graph): the bits of (o)'s B =
    4 batches, every pair within 1e-4 of its B = 1 transform in (o), the
    wall per pair and peak memory beside (o)'s B = 8 and 4;
    ``register_batch`` on ``make_mesh()`` (every visible card): the bits of
    (o)'s ``device="cuda"`` result; a 2-process world on the card (this
    script started twice with ``--mesh-worker RANK WORLD ADDR DIR``, ranks
    holding 5 and 3 pairs, ``initialize`` -> ``global_mesh`` ->
    ``local_batch_to_global`` -> ``register_batch``, each worker under a
    time limit) whose every rank gathers all 8 results within 1e-4 of
    (o)'s; ``utils.timing.stage`` around device work no host read waits
    for: with ``sync=`` it covers the work's CUDA events, without it not.
(q) the ``intra`` axis (``dist/intra.py``): ``split_queries`` with the
    kernels over ``["cuda:0"] * 2`` and ``* 3`` (K1 at 131072 x 16384 and
    8 x 131072 x 16384, K2 at 131072 x 16384 and 16384 x 16384, the
    spacing's top-k and ``average_spacing`` at (o)'s B = 8 shape), each bit
    for bit the unsplit call, one launch a part, timed beside it;
    ``register_batch`` on (o)'s 8 pairs over ``make_mesh(devices=["cuda:0"]
    * 2, intra=2)`` (one group: the bits of (o)'s B = 8) and ``* 4,
    intra=2`` (two groups: the bits of (o)'s B = 4 batches), each with the
    wall per pair, peak memory, host syncs (those of (o)) and the K1/K2/K3
    launches by group thread and stream (extraction's graph on home's
    stream, every K1/K2 pass in two parts, one on home's stream); the one
    group with ``enable_icp``: the bits of (o)'s ``enable_icp`` batch, K2
    twice (o)'s.
(r) the evaluation suite (``python -m plade_tpu_torch.tools.run_eval``'s
    work, in this process): its 8 scenes of 60000-point scans, 41
    consecutive pairs x 3 repeats (seed ``1000 * rep``, odd repeats in
    reverse pair order), each scene one lockstep batch through
    ``evaluate_scene(device_batch=True)`` at the default ``PladeConfig()``:
    per scene the recall of each repeat, RMSE, s/pair, peak memory, the
    K1/K2/K3 launches with K1/K2's shapes and the truncation
    counters summed over its pairs (each failed pair and each nonzero
    counter printed); fails on an exception, a kernel not launched in a
    scene, a transform not finite, or an overall recall below the reference
    binary's (``REF_EVAL.json``, 0.561).  Every pair's result goes to
    ``chiprun_out/eval_smoke.{md,json}``.  Then K1/K2 at the shapes of the
    suite's largest batch (``floor_long``, 7 pairs) as in (b) and K3 on the
    grids of its first repeat as in (f).  The script's time before and
    after (r) is printed.

The last lines are the kernels' JSON line (one row per kernel and main-path
shape; each row's ``launches`` counts its path's run and
``launches_by_path`` every path's; the batched rows (``"path":
"register_batch"``) count their shape's launches in (o)'s B = 8 run (the
final ICP's in its ``enable_icp`` batch), the ``"eval_suite"`` rows their
shape's launches in (r) (K3's: all of (r)'s), K4's rows (at the
benchmark's spacing shapes) their shape's launches in their path's run,
(o)'s or (f)'s, 0 where that run's clouds pad to another size; K5's rows
the launches of their own pool pairs' run in (b); the rows of chip_smoke's own K3
grids lie on no path: ``"path": null``, ``"launches": 0``), the card's
name and power limit from nvidia-smi, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
import penetration_pools  # noqa: E402
import spacing_clouds  # noqa: E402

#: the card's published peaks (NVIDIA H100 SXM data sheet): fp32 outside
#: the tensor cores, and device memory.  A kernel's bound is the larger of
#: its operations and its bytes (inputs read once, outputs written once)
#: over these.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
#: the main path's K1/K2 shapes (Q, T) at the default PladeConfig: K2 in
#: the rescore ICP (16 modes x 8192 subsampled source points) and, with
#: ``enable_icp``, in the final ICP (the 16384 downsampled source points),
#: K1 in overlap phase 2 (8 x 16384) and in the rescore (16 x 16384),
#: against the 16384 downsampled target points
K2_SHAPES = ((131072, 16384), (16384, 16384))
#: the final ICP's K2 launches: ``PladeConfig.icp_iters`` + 1
ICP_SHAPE = (16384, 16384)
K1_SHAPES = ((131072, 16384), (262144, 16384))
#: pairs of a lockstep batch in (o) (``bench.py``'s B) and the batched main
#: path's (P, Q, T): K2 in the rescore ICP and, with ``enable_icp``, the
#: final ICP; K1 in overlap phase 2 and the rescore
BATCH = 8
K2_BATCH_SHAPES = ((BATCH, 131072, 16384), (BATCH, 16384, 16384))
K1_BATCH_SHAPES = ((BATCH, 131072, 16384), (BATCH, 262144, 16384))
#: edge shapes, held bit for bit too: ragged Q and T, one query, one
#: reference, and small Q against many references (the finest reference
#: split, with a duplicate of reference 5 in every slice)
EDGE_SHAPES = ((131071, 16383), (1, 16384), (131072, 1), (1, 1),
               (1000, 200000))
#: floating-point operations a (query, reference) pair: K2 3 subtractions,
#: 3 products, 2 additions; K1 those and the 3-term normal dot
K2_FLOP = 8
K1_FLOP = 13
#: the kernel a counted launch runs (a part of its name in a trace), by
#: its key in ``kernels/build.LAUNCHES``
KERNEL_NAMES = {"nearest_neighbor": "nn_kernel",
                "oriented_min_dist_sq": "oriented_kernel",
                "close_and_label_lanes": "close_label_kernel",
                "topk_dist_sq": "topk_kernel",
                "penetration_walk": "walk_kernel"}
#: K4's shapes (P, rows a cloud, live rows of each cloud, path): the
#: spacing's 10000 samples of each source cloud against its rows in the
#: benchmark's cells (``spacing_clouds.BENCH_CLOUDS``), with the entry
#: whose run here counts its launches
TOPK_SHAPES = tuple((*c, path) for c, path in zip(
    spacing_clouds.BENCH_CLOUDS,
    ("register_batch", "register_batch", "register_clouds")))
#: K4 a distance: floating-point operations (the dot as a product and two
#: fused multiply-adds, the doubling as a fused multiply-add with |q|^2,
#: the add of |r|^2) and thread-instructions (those 5, the compare with
#: the k-th smallest, and a quarter of the branch a reference that a
#: thread takes for its 4 queries; ``csrc/knn.cu``)
K4_FLOP = 8
K4_ISSUE = 6.25
#: K5's cells (regbench configuration, pairs, the entry its cell runs):
#: the two batch cells' lockstep batches of 8 pool pairs and the single
#: cell's first pool pair
WALK_CELLS = (("resso60k", BATCH, "register_array_pairs"),
              ("tls131k", BATCH, "register_array_pairs"),
              ("resso60k", 1, "register_clouds"))
#: K5 a (sample, point) distance: floating-point operations (the dot as a
#: product and two fused multiply-adds, the doubling as a fused
#: multiply-add with |p|^2, the add of |s|^2; ``csrc/penetration.cu``); a
#: live test needs S (n1 + n2) of them over its planes' live points
K5_FLOP = 8
#: integer operations a cell of a K3 round (the 4 minima of the separable
#: 3 x 3 min: two down the column, two along the row; the closed-mask
#: select is not counted), and a cell of the close (4 ORs, 4 ANDs, 1 OR)
K3_ROUND_OPS = 4
K3_CLOSE_OPS = 9
#: most instructions one SM issues a clock (4 schedulers x one warp of 32)
SM_ISSUE = 128
#: a probe of the rate of K3's packed minimum (``min.u16x2``, two 16-bit
#: minima an instruction) on one SM: 1024 threads run independent chains
#: and thread 0 counts the clocks (clock64) between two barriers around them
VMIN2_PROBE = r'''
#include <cuda_runtime.h>
constexpr int kChains = 8, kUnroll = 16;
__global__ void probe(unsigned* out, long long* clocks, int n) {
  unsigned a[kChains];
  for (int j = 0; j < kChains; ++j) a[j] = threadIdx.x * 0x10001u + j;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < kChains; ++j)
        asm volatile("min.u16x2 %0, %0, %1;"
                     : "+r"(a[j]) : "r"(a[(j + 1) % kChains]));
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned x = 0;
  for (int j = 0; j < kChains; ++j) x ^= a[j];
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) clocks[0] = t1 - t0;
}
// min.u16x2 a clock on the SM that ran the block, after n x 128 per thread
extern "C" double plade_vmin2_rate(unsigned* out, long long* clocks, int n,
                                   int threads) {
  probe<<<1, threads>>>(out, clocks, n);
  long long c = 0;
  if (cudaMemcpy(&c, clocks, sizeof c, cudaMemcpyDeviceToHost) !=
      cudaSuccess || c <= 0)
    return -1.0;
  return static_cast<double>(threads) * n * kUnroll * kChains / c;
}
'''
NORMAL_COS = 0.7071067811865476
ROT_TOL_DEG = 1.0
TRANS_TOL = 0.05
#: an extracted plane matches a generator plane within this angle and
#: offset
PLANE_TOL_DEG = 1.0
PLANE_TOL_D = 0.02
#: register_files against register_clouds on the same points
FILES_TOL_DEG = 0.01
FILES_TOL_T = 1e-4


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warm: int = 3) -> float:
    """Median over ``reps`` of one call's device time, in ms, after ``warm``
    untimed calls (the first calls after other work read slower)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Device time of one call of ``fn``, in ms: ``reps`` calls queued
    behind a spinning kernel, so that the device runs them back to back
    whatever the host's enqueue time (as long as a short kernel), timed by
    events over the batch, which adds the device's gap between launches;
    the median of ``batches``."""
    fn()
    times = []
    for _ in range(batches):
        # a batch that the device drained (a host stall outlasted the spin)
        # is run again behind a longer spin
        for spin in (5_000_000, 20_000_000, 80_000_000):  # 2.5, 10, 40 ms
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(reps):
                fn()
            drained = torch.cuda.current_stream().query()
            end.record()
            torch.cuda.synchronize()
            if not drained:
                break
        else:
            fail("queued_ms: the device ran dry while the host enqueued, "
                 "three times in a row")
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def sm_clock_under(fn, seconds: float = 1.5) -> str:
    """nvidia-smi's SM clock and power draw read halfway through
    ``seconds`` of back-to-back calls of ``fn``."""
    import threading
    reading = []

    def read():
        time.sleep(seconds / 2)
        reading.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())

    reader = threading.Thread(target=read)
    reader.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or reader.is_alive():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    reader.join()
    return reading[0]


def bound(ops: float, nbytes: float):
    """(least time in ms, what sets it) for ``ops`` operations and
    ``nbytes`` bytes at the card's peaks."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_inputs(Q: int, T: int, seed: int = 0, device: str = "cuda"):
    """Points in a 4 m room-sized box; reference normals within ~25 deg of
    +z so that query 3, whose normal is -z, passes no gate.  Reference 5 is
    duplicated at 10-19 and at 7 + 512 k (a copy in every reference slice
    of the kernels' split) and queries 0-3 sit on it: ties that the lowest
    index must win, also across slices.  The last 512 references and 256
    queries are BIG padding (zero reference normals).  Drawn at least
    1024 x 1024 and cut to (Q, T)."""
    n, m = max(Q, 1024), max(T, 1024)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(n, 3, device=device, generator=g) * 4.0 - 2.0
    r = torch.rand(m, 3, device=device, generator=g) * 4.0 - 2.0
    qn = torch.nn.functional.normalize(
        torch.randn(n, 3, device=device, generator=g), dim=1)
    rn = torch.nn.functional.normalize(
        torch.randn(m, 3, device=device, generator=g).clamp(-3, 3) * 0.15
        + torch.tensor([0.0, 0.0, 1.0], device=device), dim=1)
    r[10:20] = r[5]
    r[7:m - 512:512] = r[5]
    q[0:4] = r[5]
    qn[0:3] = torch.tensor([0.0, 0.0, 1.0], device=device)   # gates pass
    qn[3] = torch.tensor([0.0, 0.0, -1.0], device=device)     # none passes
    r[m - 512:] = 1.0e8
    rn[m - 512:] = 0.0
    q[n - 256:] = 1.0e8
    return (q[:Q].contiguous(), qn[:Q].contiguous(), r[:T].contiguous(),
            rn[:T].contiguous())


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, equal entries (+inf included) counting 0."""
    return torch.where(a == b, 0.0, (a - b).abs()).max().item()


def nn_exact(nn, Q, T, q, qn, r, rn):
    """K2 and K1 against their plain versions, bit for bit (d2 and
    argmin); the tie rows 0-3 must take reference 5 and row 3's gate must
    fail.  Returns the largest |d2 - plain d2| of K2 and of K1."""
    d, i = nn.nearest_neighbor(q, r)
    o = nn.oriented_min_dist_sq(q, qn, r, rn, NORMAL_COS)
    torch.cuda.synchronize()
    dp, ip = nn.nearest_neighbor_plain(q, r)
    op = nn.oriented_min_dist_sq_plain(q, qn, r, rn, NORMAL_COS)
    slices = (f"{nn.reference_slices(Q, T)} (K2) / "
              f"{nn.reference_slices(Q, T, oriented=True)} (K1)")
    if not (torch.equal(d, dp) and torch.equal(i, ip)):
        fail(f"[b] K2 Q={Q} T={T} ({slices} slices): d2 equal "
             f"{torch.equal(d, dp)}, argmin equal {torch.equal(i, ip)}")
    if not torch.equal(o, op):
        fail(f"[b] K1 Q={Q} T={T} ({slices} slices): d2 differs from the "
             "plain version")
    if T > 19 and not (i[0:4] == 5).all():
        fail(f"[b] K2 tie rule broken: {i[0:4].tolist()}")
    if Q > 3 and torch.isfinite(o[3]):
        fail("[b] K1: a query no gate passes got a finite d2")
    print(f"[b] Q={Q} T={T}: {slices} reference slices; K2 d2 and argmin "
          f"and K1 d2 bit-identical to the plain versions; K1 +inf rows "
          f"{int(torch.isinf(o).sum())}", flush=True)
    return max_abs_diff(d, dp), max_abs_diff(o, op)


def check_kernels(nn):
    """(b) K2 and K1: exact at the main path's shapes and the edge shapes;
    kernel, plain and library times and the bound at the main shapes.
    Returns (rows of the kernels' JSON line, the inputs per shape)."""
    rows, inputs, errs = [], {}, {}
    for Q, T in sorted(set(K2_SHAPES + K1_SHAPES + EDGE_SHAPES)):
        inputs[(Q, T)] = kernel_inputs(Q, T)
        errs[(Q, T)] = nn_exact(nn, Q, T, *inputs[(Q, T)])
    for Q, T in K2_SHAPES:
        q, _, r, _ = inputs[(Q, T)]
        ms = cuda_ms(lambda: nn.nearest_neighbor(q, r))
        plain_ms = cuda_ms(lambda: nn.nearest_neighbor_plain(q, r))
        # yardstick only: the port never calls cdist (it writes the (Q, T)
        # matrix, 4 Q T bytes)
        library_ms = cuda_ms(lambda: torch.cdist(q, r).min(dim=1))
        bound_ms, bound_by = bound(K2_FLOP * Q * T, 12 * (Q + T) + 8 * Q)
        print(f"[b] K2 nearest_neighbor Q={Q} T={T}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, cdist+min {library_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of it); SM clock, power under "
              "the kernel: "
              f"{sm_clock_under(lambda: nn.nearest_neighbor(q, r))}",
              flush=True)
        rows.append({"name": "nearest_neighbor", "route": "cuda",
                     "source": "plade_tpu_torch/csrc/nn.cu",
                     "replaces": "plade_tpu/kernels/nn.py:87",
                     "shape": f"{Q}x{T}", "max_abs_err": errs[(Q, T)][0],
                     "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    for Q, T in K1_SHAPES:
        q, qn, r, rn = inputs[(Q, T)]
        ms = cuda_ms(lambda: nn.oriented_min_dist_sq(q, qn, r, rn,
                                                     NORMAL_COS))
        plain_ms = cuda_ms(lambda: nn.oriented_min_dist_sq_plain(
            q, qn, r, rn, NORMAL_COS))
        bound_ms, bound_by = bound(K1_FLOP * Q * T, 24 * (Q + T) + 4 * Q)
        print(f"[b] K1 oriented_min_dist_sq Q={Q} T={T}: kernel {ms:.4f} ms,"
              f" plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f}% of it); no single "
              "PyTorch call computes the gated minimum", flush=True)
        rows.append({"name": "oriented_min_dist_sq", "route": "cuda",
                     "source": "plade_tpu_torch/csrc/nn.cu",
                     "replaces": "plade_tpu/kernels/nn.py:182",
                     "shape": f"{Q}x{T}", "max_abs_err": errs[(Q, T)][1],
                     "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    return rows, inputs


def ptxas_registers(report: str, kernel: str) -> dict:
    """{entry function: (registers, spill stores, spill loads)} from an
    ``nvcc -Xptxas -v`` report, for the functions whose mangled name holds
    ``kernel``."""
    found, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[current] = (None, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            spills = found.get(current, (None, None, None))
            found[current] = (int(m.group(1)),) + spills[1:]
            current = None
    return found


def library_topk(queries, refs, k: int):
    """The yardstick for K4: ``torch.cdist`` (distances, not squared) and
    ``torch.topk`` in the plain version's blocks of queries."""
    from plade_tpu_torch.knn import bruteforce
    block = bruteforce.topk_block(queries, refs)
    return torch.cat([torch.topk(torch.cdist(queries[..., s:s + block, :],
                                             refs), k, dim=-1,
                                 largest=False).values
                      for s in range(0, queries.shape[-2], block)], dim=-2)


def check_topk(nn, report: str):
    """(b) K4 at ``TOPK_SHAPES``: bit for bit the plain version at k = 1, 6
    and ``nn.TOPK_MAX_K``, one launch a call, and ``average_spacing``
    through it the plain top-k's spacing; at k = 6 its time beside the
    plain version's, the yardstick's, its bound and its issue ceiling (at
    the SM clock nvidia-smi reads under it); its registers from the
    build's ptxas ``report``.  Returns the rows of the kernels' JSON
    line, without ``launches``: :func:`main` takes each row's from its
    path's run at its shape."""
    from plade_tpu_torch.kernels import build
    from plade_tpu_torch.knn import bruteforce
    plain_passes = bruteforce.ONE_DEVICE._replace(
        topk_dist_sq=bruteforce.topk_dist_sq_plain)
    registers = ptxas_registers(report, "topk_kernel")
    print(f"[b] K4 topk_kernel instances (registers, spill stores, spill "
          f"loads): {registers}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for P, N, live, path in TOPK_SHAPES:
        pts, mask, q = spacing_clouds.spacing_inputs(P, N, live)
        Q = q.shape[-2]
        shape = f"{P}x{Q}x{N}"
        for k in (1, 6, nn.TOPK_MAX_K):
            before = nn.LAUNCHES["topk_dist_sq"]
            got = nn.topk_dist_sq(q, pts, k)
            torch.cuda.synchronize()
            launches = nn.LAUNCHES["topk_dist_sq"] - before
            want = bruteforce.topk_dist_sq_plain(q, pts, k)
            if not torch.equal(got, want) or launches != 1:
                diff = got != want
                fail(f"[b] K4 {shape} k={k}: {int(diff.sum())} values differ "
                     f"from the plain version (largest gap "
                     f"{max_abs_diff(got, want):.3e}), {launches} launches")
        sp = bruteforce.average_spacing(pts, mask, 6, Q)
        sp_plain = bruteforce.average_spacing(pts, mask, 6, Q, plain_passes)
        if not torch.equal(sp, sp_plain):
            fail(f"[b] K4 {shape}: the spacing differs from the plain top-k's")
        slice_ = build.library().plade_topk_slice(P, Q, N, 6)
        ms = cuda_ms(lambda: nn.topk_dist_sq(q, pts, 6))
        plain_ms = cuda_ms(lambda: bruteforce.topk_dist_sq_plain(q, pts, 6),
                           reps=3, warm=1)
        library_ms = cuda_ms(lambda: library_topk(q, pts, 6), reps=3, warm=1)
        work = P * Q * N
        bound_ms, bound_by = bound(K4_FLOP * work,
                                   P * (16 * (Q + N) + 4 * 6 * Q))
        clock = sm_clock_mhz(lambda: nn.topk_dist_sq(q, pts, 6))
        issue_ms = K4_ISSUE * work / (SM_ISSUE * sms * clock * 1e6) * 1e3
        print(f"[b] K4 topk_dist_sq {shape} (live rows {list(live)}), k = 1, "
              f"6, {nn.TOPK_MAX_K}: bit-identical to the plain version, one "
              f"launch a call, the spacing too; {-(-N // slice_)} reference "
              f"slices of {slice_}; k = 6: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, cdist+topk {library_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% of "
              f"it), issue ceiling {issue_ms:.4f} ms at {clock:.0f} MHz "
              f"({100 * issue_ms / ms:.1f}% of it)", flush=True)
        rows.append({"name": "topk_dist_sq", "route": "cuda",
                     "source": "plade_tpu_torch/csrc/knn.cu",
                     "replaces": None, "shape": shape, "path": path,
                     "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "issue_ms": issue_ms,
                     "library_ms": library_ms, "registers": registers})
        del pts, mask, q, got, want
    return rows


def check_walk(report: str):
    """(b) K5 on the penetration tests of real registrations at
    ``WALK_CELLS``: counts reset, the pool pairs registered through the
    cell's entry, whose run must make one ``run_tests`` call and one K5
    launch; that call's verdicts and, through the test-only entry, each
    test's four counts bit for bit the plain two-tier walk's on the same
    CUDA tensors; one launch and no host read again; K5's time beside the
    plain walk's and its bound over the live tests' live points; its
    registers from the build's ptxas ``report``.  Returns the rows of the
    kernels' JSON line, each with its run's ``launches``."""
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.core.ops import lift, per_pair
    from plade_tpu_torch.kernels import penetration as walk
    from plade_tpu_torch.kernels.build import LAUNCHES
    from plade_tpu_torch.verify import penetration
    registers = ptxas_registers(report, "walk_kernel")
    print(f"[b] K5 walk_kernel (registers, spill stores, spill loads): "
          f"{registers}", flush=True)
    rows = []
    for config, B, path in WALK_CELLS:
        reset_counts()
        seen, launches = penetration_pools.pool_walk(config, B, path)
        if len(seen) != 1 or launches != 1 \
                or LAUNCHES["penetration_walk"] != 1:
            fail(f"[b] K5 {config} B={B} through {path}: {len(seen)} "
                 f"run_tests calls, {launches} K5 launches")
        args, kw, got = seen[0]
        want = penetration.run_tests_plain(*args, **kw)
        if not torch.equal(got, want):
            fail(f"[b] K5 {config} B={B}: {int((got != want).sum())} "
                 "verdicts differ from the plain walk's")
        if args[1].dim() == 3:
            args = lift(args)
        tests, R, t, spts, scnt, tpts, tcnt, scoef, tcoef = args
        S = kw["n_samples"]
        radius = per_pair(kw["search_radius"], B, "cuda")
        min_d = per_pair(kw["min_distance"], B, "cuda")
        kernel_args = (tests, R, t, spts, scnt, tpts, tcnt, scoef, tcoef,
                       radius, min_d, kw["min_points"], kw["max_ratio"], S)
        verdict, counts = walk.penetration_walk_counts(*kernel_args)
        plain = penetration.plain_counts(
            tests, R, t, spts, scnt, tpts, tcnt, scoef, tcoef,
            kw["search_radius"], kw["min_distance"], S)
        if not torch.equal(verdict.reshape(got.shape), got) \
                or not torch.equal(counts, plain):
            fail(f"[b] K5 {config} B={B}: {int((counts != plain).sum())} "
                 "counts differ from the plain walk's")
        torch.cuda.synchronize()
        syncs = ptypes.HOST_SYNCS["count"]
        again = walk.penetration_walk(*kernel_args)
        torch.cuda.synchronize()
        if LAUNCHES["penetration_walk"] != 3 \
                or ptypes.HOST_SYNCS["count"] != syncs \
                or not torch.equal(again.reshape(got.shape), got):
            fail(f"[b] K5 {config} B={B}: {LAUNCHES['penetration_walk']} "
                 "launches of three calls, or a host read, or other bits")
        ms = cuda_ms(lambda: walk.penetration_walk(*kernel_args))
        plain_ms = cuda_ms(lambda: penetration.run_tests_plain(*seen[0][0],
                                                               **kw),
                           reps=3, warm=1)
        v = tests.valid
        n1 = torch.gather(scnt, 1, tests.src.long())
        n2 = torch.gather(tcnt, 1, tests.tgt.long())
        live_tests = int(v.sum())
        live_points = int(((n1 + n2) * v).sum())
        small = int((v & (n1 <= 512) & (n2 <= 512)).sum())
        # every live sample against every live point of each live test's
        # two planes; the points read once, the verdicts written once
        bound_ms, bound_by = bound(K5_FLOP * S * live_points,
                                   12 * int(scnt.sum() + tcnt.sum())
                                   + v.numel())
        shape = f"{B}x{v.shape[1]}"
        print(f"[b] K5 penetration_walk {config} {shape} tests through "
              f"{path}: one run_tests call, one launch, no host read; "
              f"verdicts and counts bit-identical to the plain walk's; "
              f"{live_tests} live tests ({small} in the small tier, "
              f"{live_points / max(live_tests, 1):.0f} live points a test, "
              f"largest plane {int(torch.maximum(n1, n2)[v].max())}), "
              f"{int(got.sum())} penetrable; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of it)", flush=True)
        rows.append({"name": "penetration_walk", "route": "cuda",
                     "source": "plade_tpu_torch/csrc/penetration.cu",
                     "replaces": None, "shape": shape, "config": config,
                     "path": path, "launches": launches,
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "live_tests": live_tests, "live_points": live_points,
                     "samples": S, "registers": registers})
        del seen, args, kw, got, want, tests, R, t, spts, tpts, counts, plain
        del verdict, again, kernel_args
    return rows


def batch_inputs(P: int, Q: int, T: int):
    """``kernel_inputs`` of P pairs (pair p from seed p: every pair has its
    own tie rows and copies of its reference 5 in every slice), stacked on
    a leading pair axis."""
    per = [kernel_inputs(Q, T, seed=p) for p in range(P)]
    return tuple(torch.stack([x[k] for x in per]).contiguous()
                 for k in range(4))


def check_batched_kernels(nn, k2_shapes=K2_BATCH_SHAPES,
                          k1_shapes=K1_BATCH_SHAPES, path="register_batch",
                          tag="[b]"):
    """(b) K2 and K1 with the pair axis at the batched main path's shapes
    (or at ``k2_shapes`` / ``k1_shapes`` of ``path``): one launch over all
    pairs, bit for bit (d2 and argmin) against the batched plain version
    and against each pair's unbatched launch, the tie rule within each
    pair; the kernel, plain and library times (the yardstick ``cdist`` +
    ``min`` pair by pair: one (P, Q, T) matrix would not fit) and the
    bound (P times one pair's).  Returns the rows of the kernels' JSON
    line (``"path": path``)."""
    rows = []
    k2_shapes, k1_shapes = set(k2_shapes), set(k1_shapes)
    for P, Q, T in sorted(k2_shapes | k1_shapes):
        q, qn, r, rn = batch_inputs(P, Q, T)
        d, i = nn.nearest_neighbor(q, r)
        o = nn.oriented_min_dist_sq(q, qn, r, rn, NORMAL_COS)
        torch.cuda.synchronize()
        dp, ip = nn.nearest_neighbor_plain(q, r)
        op = nn.oriented_min_dist_sq_plain(q, qn, r, rn, NORMAL_COS)
        slices = (f"{nn.reference_slices(Q, T, pairs=P)} (K2) / "
                  f"{nn.reference_slices(Q, T, True, pairs=P)} (K1)")
        if not (torch.equal(d, dp) and torch.equal(i, ip)
                and torch.equal(o, op)):
            fail(f"{tag} batched K1/K2 P={P} Q={Q} T={T} ({slices} slices) "
                 "differ from the plain versions")
        for p in range(P):
            d1, i1 = nn.nearest_neighbor(q[p], r[p])
            o1 = nn.oriented_min_dist_sq(q[p], qn[p], r[p], rn[p],
                                         NORMAL_COS)
            if not (torch.equal(d[p], d1) and torch.equal(i[p], i1)
                    and torch.equal(o[p], o1)):
                fail(f"{tag} batched K1/K2 P={P} Q={Q} T={T}: pair {p} "
                     "differs from its unbatched launch")
        if not (i[:, 0:4] == 5).all() or not torch.isinf(o[:, 3]).all():
            fail(f"{tag} batched K1/K2 P={P} Q={Q} T={T}: tie rule or gate "
                 "broken")
        print(f"{tag} P={P} Q={Q} T={T}: {slices} reference slices (one pair "
              f"alone: {nn.reference_slices(Q, T)} / "
              f"{nn.reference_slices(Q, T, True)}); batched K2 d2 and argmin "
              "and K1 d2 bit-identical to the batched plain versions and to "
              "each pair's unbatched launch", flush=True)
        shape = f"{P}x{Q}x{T}"
        if (P, Q, T) in k2_shapes:
            ms = cuda_ms(lambda: nn.nearest_neighbor(q, r))
            plain_ms = cuda_ms(lambda: nn.nearest_neighbor_plain(q, r),
                               reps=1, warm=1)
            library_ms = cuda_ms(lambda: [torch.cdist(q[p], r[p]).min(dim=1)
                                          for p in range(P)], reps=3)
            bound_ms, bound_by = bound(P * K2_FLOP * Q * T,
                                       P * (12 * (Q + T) + 8 * Q))
            print(f"{tag} K2 nearest_neighbor P={P} Q={Q} T={T}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.3f} ms, cdist+min pair by "
                  f"pair {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}, {100 * bound_ms / ms:.1f}% of it)",
                  flush=True)
            rows.append({"name": "nearest_neighbor", "route": "cuda",
                         "source": "plade_tpu_torch/csrc/nn.cu",
                         "replaces": "plade_tpu/kernels/nn.py:87",
                         "shape": shape, "path": path,
                         "max_abs_err": max_abs_diff(d, dp), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms})
        if (P, Q, T) in k1_shapes:
            ms = cuda_ms(lambda: nn.oriented_min_dist_sq(q, qn, r, rn,
                                                         NORMAL_COS))
            plain_ms = cuda_ms(lambda: nn.oriented_min_dist_sq_plain(
                q, qn, r, rn, NORMAL_COS), reps=1, warm=1)
            bound_ms, bound_by = bound(P * K1_FLOP * Q * T,
                                       P * (24 * (Q + T) + 4 * Q))
            print(f"{tag} K1 oriented_min_dist_sq P={P} Q={Q} T={T}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}, "
                  f"{100 * bound_ms / ms:.1f}% of it)", flush=True)
            rows.append({"name": "oriented_min_dist_sq", "route": "cuda",
                         "source": "plade_tpu_torch/csrc/nn.cu",
                         "replaces": "plade_tpu/kernels/nn.py:182",
                         "shape": shape, "path": path,
                         "max_abs_err": max_abs_diff(o, op), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None})
        del q, qn, r, rn, d, i, o, dp, ip, op
    for row in rows:
        if path == "register_batch" and row["name"] == "nearest_neighbor" \
                and row["shape"] == "x".join(map(str, K2_BATCH_SHAPES[1])):
            row["option"] = "enable_icp"
    return rows


def parent_libraries(parent: Path):
    """The parent tree's ``csrc/nn.cu`` and ``csrc/cc.cu`` built with this
    tree's flags into libraries of their own (one nvcc each, in parallel),
    with their entry points' signatures (the first port's K2 takes no key
    scratch; the pair axis came later).  Returns (nn library, (whether K2
    takes keys, whether K1/K2 take a pair count), cc library)."""
    import ctypes

    from plade_tpu_torch.kernels import build
    libs = {name: build.BUILD_DIR / f"libparent_{name}.so"
            for name in ("nn", "cc")}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    build._run([[build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                 str(lib), str(parent / "plade_tpu_torch" / "csrc" /
                               f"{name}.cu")]
                for name, lib in libs.items()])
    dll = ctypes.CDLL(str(libs["nn"]))
    P, I = ctypes.c_void_p, ctypes.c_int
    keys = hasattr(dll, "plade_nn_ref_slices")
    # the pair axis (a P argument before Q) came with plade_nn_abi
    pairs = [I] if hasattr(dll, "plade_nn_abi") else []
    dll.plade_nearest_neighbor.argtypes = \
        [P, P, P, P] + ([P] if keys else []) + pairs + [I, I, P]
    dll.plade_oriented_min_dist_sq.argtypes = \
        [P, P, P, P, ctypes.c_float, P] + pairs + [I, I, P]
    cc_dll = ctypes.CDLL(str(libs["cc"]))
    cc_dll.plade_close_and_label.argtypes = [P, P, I, I, I, P]
    return dll, (keys, bool(pairs)), cc_dll


def parent_k3(cc_dll):
    """The parent's K3 as a function of (occ, iters), like
    ``close_and_label_lanes`` (counts no launch)."""
    def run(occ, iters):
        out = torch.empty_like(occ)
        err = cc_dll.plade_close_and_label(
            occ.data_ptr(), out.data_ptr(), occ.shape[0], occ.shape[1],
            iters, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"parent K3 launch failed: {err}")
        return out
    return run


def bare_nn(dll, keys: bool, pairs: bool):
    """K2 and K1 of a kernel library called straight through ``ctypes``
    (one pair, no input checks, no device context; counts no launch), for
    the turns of :func:`compare_parent`: parent and change are timed
    through the same thin call, so only the kernels differ."""
    one = [1] if pairs else []

    def k2(q, r):
        Q = q.shape[0]
        d = torch.empty(Q, device="cuda")
        i = torch.empty(Q, dtype=torch.int32, device="cuda")
        extra = [torch.empty(Q, dtype=torch.int64, device="cuda")
                 .data_ptr()] if keys else []
        err = dll.plade_nearest_neighbor(
            q.data_ptr(), r.data_ptr(), d.data_ptr(), i.data_ptr(), *extra,
            *one, Q, r.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"bare K2 launch failed: {err}")
        return d, i

    def k1(q, qn, r, rn):
        d = torch.empty(q.shape[0], device="cuda")
        err = dll.plade_oriented_min_dist_sq(
            q.data_ptr(), qn.data_ptr(), r.data_ptr(), rn.data_ptr(),
            NORMAL_COS, d.data_ptr(), *one, q.shape[0], r.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"bare K1 launch failed: {err}")
        return d

    return k2, k1


def compare_parent(nn, dll, keys, rows, inputs):
    """The parent's K1/K2 (``dll``) against this tree's, on the inputs of
    (b), both called through :func:`bare_nn`: the same bits (and this
    tree's wrapper's), and each shape timed in turns parent, change,
    change, parent.  Adds ``parent_ms`` and ``change_bare_ms`` (the two
    medians of each) to the rows."""
    from plade_tpu_torch.kernels.build import library
    old_k2, old_k1 = bare_nn(dll, *keys)
    new_k2, new_k1 = bare_nn(library(), True, True)
    for row in rows:
        if row.get("path") == "register_batch":
            continue
        Q, T = map(int, row["shape"].split("x"))
        q, qn, r, rn = inputs[(Q, T)]
        if row["name"] == "nearest_neighbor":
            old = lambda: old_k2(q, r)                       # noqa: E731
            new = lambda: new_k2(q, r)                       # noqa: E731
            wrapped = nn.nearest_neighbor(q, r)
        else:
            old = lambda: old_k1(q, qn, r, rn)               # noqa: E731
            new = lambda: new_k1(q, qn, r, rn)               # noqa: E731
            wrapped = nn.oriented_min_dist_sq(q, qn, r, rn, NORMAL_COS)
        a, b = old(), new()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(a, b, wrapped)) \
            if isinstance(a, tuple) else (torch.equal(a, b)
                                          and torch.equal(a, wrapped))
        if not same:
            fail(f"[b] parent and change differ: {row['name']} Q={Q} T={T}")
        turns = [cuda_ms(f, 9) for f in (old, new, new, old)]
        row["parent_ms"] = [turns[0], turns[3]]
        row["change_bare_ms"] = [turns[1], turns[2]]
        print(f"[b] {row['name']} Q={Q} T={T}, parent vs change in turns, "
              f"both through a bare ctypes call: parent {turns[0]:.4f}, "
              f"change {turns[1]:.4f}, change {turns[2]:.4f}, parent "
              f"{turns[3]:.4f} ms (same bits); through the wrapper (ms) "
              f"{row['ms']:.4f}", flush=True)


def generator_labels(points, gen_planes, max_planes):
    """Label each point with the nearest generator plane within 0.01 (-1
    for none); labels are renumbered by size, descending, and cut to
    ``max_planes``.  Returns (point_plane (N,) int32, number of planes)."""
    n = np.stack([np.asarray(p[0], np.float64) for p in gen_planes])
    d = np.array([p[1] for p in gen_planes], np.float64)
    dist = np.abs(points.astype(np.float64) @ n.T + d)      # (N, G)
    lab = np.argmin(dist, axis=1)
    lab[dist[np.arange(len(lab)), lab] > 0.01] = -1
    sizes = np.bincount(lab[lab >= 0], minlength=len(gen_planes))
    order = np.argsort(-sizes, kind="stable")
    order = order[sizes[order] > 0][:max_planes]
    point_plane = np.full(points.shape[0], -1, np.int32)
    for k, g in enumerate(order):
        point_plane[lab == g] = k
    return point_plane, len(order)


def fit_planes(points, normals, point_plane, count, max_planes, PlaneSet):
    """PlaneSet of labelled points: each label refit by PCA and oriented to
    its points' mean normal, padded to ``max_planes``."""
    coeffs = np.zeros((max_planes, 4), np.float32)
    sizes = np.zeros(max_planes, np.int32)
    for k in range(count):
        sel = point_plane == k
        p = points[sel].astype(np.float64)
        c = p.mean(0)
        _, v = np.linalg.eigh(np.cov((p - c).T))
        nk = v[:, 0]
        if nk @ normals[sel].mean(0) < 0:
            nk = -nk
        coeffs[k] = (*nk, -nk @ c)
        sizes[k] = sel.sum()
    return PlaneSet(coeffs=coeffs, sizes=sizes, count=np.int32(count),
                    point_plane=point_plane)


def make_scene(n_per_plane, seed, PlaneSet, max_planes, syn):
    """A room split into two disjoint random halves, the source half moved
    by a known rigid transform, each half with planes labelled from the
    generator planes (in the world frame) and refit in its own frame.
    Returns (target points, normals, source points, normals, target
    planes, source planes, R, t, generator planes)."""
    rng = np.random.default_rng(seed)
    pts, nrm, gen = syn.make_room(rng, n_per_plane=n_per_plane, noise=0.002,
                                  extra_planes=6, normal_noise_deg=2.0)
    perm = rng.permutation(pts.shape[0])
    half = pts.shape[0] // 2
    ti, si = perm[:half], perm[half:]
    R, t = syn.random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = syn.transform_cloud(pts[si], nrm[si], R.T, -R.T @ t)
    tgt_planes = fit_planes(pts[ti], nrm[ti],
                            *generator_labels(pts[ti], gen, max_planes),
                            max_planes, PlaneSet)
    src_planes = fit_planes(spts, snrm,
                            *generator_labels(pts[si], gen, max_planes),
                            max_planes, PlaneSet)
    return (pts[ti], nrm[ti], spts, snrm, tgt_planes, src_planes, R, t,
            gen)


def pose_errors(T, R, t):
    """(rotation error in degrees, translation error) of T against (R, t).
    The angle comes from ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), which
    resolves small angles in float32 where the trace form's arccos does
    not (it bottoms out near 0.03 deg)."""
    d = np.linalg.norm(T[:3, :3].astype(np.float64) - R)
    rot = math.degrees(2.0 * math.asin(min(1.0, d / (2.0 * math.sqrt(2.0)))))
    return rot, float(np.linalg.norm(T[:3, 3] - t))


def check_result(tag, T, info):
    if T.shape != (4, 4) or not np.isfinite(T).all():
        fail(f"{tag}: transform not a finite 4x4: {T}")
    for key in ("score", "overlap"):
        if not math.isfinite(info[key]):
            fail(f"{tag}: {key} not finite")
    if not info.get("success"):
        fail(f"{tag}: registration failed: {info}")


def profile_stages(run, tag="[d]", kernels_of=None):
    """One profiled call of ``run``: device time per pipeline stage (the
    ``plade.*`` profiler ranges; a range entered several times sums),
    kernels launched, and the device's busy share of the wall time.
    Kernels are attributed to the stage whose host range encloses their
    launch (matched by correlation id in the exported trace).  Returns
    {stage: (host ms, device ms, kernels)}, and with ``kernels_of`` (a
    stage) also {kernel name: launches} of that stage under the key
    "(kernels of STAGE)", printed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("plade."))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    per_stage = {}
    for start, end, name in stages:
        per_stage.setdefault(name, [0.0, 0, 0.0])[2] += end - start
    other = [0.0, 0]
    names = {}
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        slot, stage = other, None
        for start, end, name in stages:
            if ts is not None and start <= ts <= end:
                slot, stage = per_stage[name], name
                break
        slot[0] += e["dur"]
        slot[1] += e.get("cat") == "kernel"
        if stage == kernels_of and e.get("cat") == "kernel":
            names[e["name"][:120]] = names.get(e["name"][:120], 0) + 1
    busy_us = sum(e["dur"] for e in device)
    print(f"{tag} profiled registration: wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"kernels {sum(e.get('cat') == 'kernel' for e in device)}",
          flush=True)
    for kernel in KERNEL_NAMES.values():
        durs = [e["dur"] for e in device if kernel in e["name"]]
        if durs:
            print(f"{tag} {kernel}: {len(durs)} launches, "
                  f"{sum(durs) / 1e3:.3f} ms device, longest "
                  f"{max(durs) / 1e3:.3f} ms", flush=True)
    print(f"{tag} stage            host ms   device ms  kernels", flush=True)
    for name, (dev_us, n, host_us) in per_stage.items():
        print(f"{tag} {name:<18}{host_us / 1e3:8.2f}  {dev_us / 1e3:9.2f}  "
              f"{n:7d}", flush=True)
    print(f"{tag} {'(outside)':<18}{'':8}  {other[0] / 1e3:9.2f}  "
          f"{other[1]:7d}", flush=True)
    if busy_us <= 0:
        fail("profiler saw no device time")
    table = {name: (host_us / 1e3, dev_us / 1e3, n)
             for name, (dev_us, n, host_us) in per_stage.items()}
    table["(total)"] = (wall_us / 1e3, busy_us / 1e3,
                        sum(e.get("cat") == "kernel" for e in device))
    if kernels_of is not None:
        print(f"{tag} {kernels_of} kernels: {names}", flush=True)
        table[f"(kernels of {kernels_of})"] = names
    return table


def serpentine(G: int) -> torch.Tensor:
    """(G, G) int32 occupancy of one winding component: full rows every 4
    rows (3 empty rows between them stay open under the close), joined at
    alternating ends.  Its path is about G * G / 4 cells long, so 256
    propagation rounds do not converge it at G = 64."""
    occ = torch.zeros((G, G), dtype=torch.int32)
    for k, r in enumerate(range(0, G, 4)):
        occ[r] = 1
        if r + 4 < G:
            occ[r + 1:r + 4, G - 1 if k % 2 == 0 else 0] = 1
    return occ


def cc_grids(L: int, G: int, seed: int) -> torch.Tensor:
    """(L, G, G) int32 occupancy counts on the card: the serpentine, an
    empty and a full grid, then random counts (0-3) at densities spread
    over 0.05-0.6."""
    g = torch.Generator().manual_seed(seed)
    dens = torch.linspace(0.05, 0.6, L - 3)
    rand = (torch.rand((L - 3, G, G), generator=g) < dens[:, None, None]) \
        .to(torch.int32) * torch.randint(1, 4, (L - 3, G, G), generator=g,
                                         dtype=torch.int32)
    fixed = torch.stack([serpentine(G),
                         torch.zeros((G, G), dtype=torch.int32),
                         torch.ones((G, G), dtype=torch.int32)])
    return torch.cat([fixed, rand]).cuda().contiguous()


def k3_rounds(cc, occ: torch.Tensor, iters: int) -> torch.Tensor:
    """(L,) rounds K3 runs on each lane of ``occ``: up to and including the
    first round that changes no label, at most ``iters`` (the kernel's
    early stop), found by stepping the plain version's round."""
    L, G, _ = occ.shape
    inf = G * G
    lab = cc.close_and_label_lanes_plain(occ, 0)
    closed = lab < inf
    rounds = torch.full((L,), iters, dtype=torch.int64)
    done = torch.zeros((L,), dtype=torch.bool)
    for it in range(1, iters + 1):
        m = torch.minimum(lab, torch.minimum(cc._shift(lab, 1, 0, inf),
                                             cc._shift(lab, -1, 0, inf)))
        m = torch.minimum(m, torch.minimum(cc._shift(m, 0, 1, inf),
                                           cc._shift(m, 0, -1, inf)))
        nxt = torch.where(closed, m, inf)
        still = (nxt == lab).flatten(1).all(1).cpu()
        rounds[still & ~done] = it
        done |= still
        lab = nxt
        if done.all():
            break
    return rounds


def k3_bound(occ: torch.Tensor, rounds: torch.Tensor):
    """K3's bound for ``occ`` with ``rounds`` per lane: every cell of a lane
    is closed once and visited by each round the lane runs (a chain of
    rounds on one SM per lane, which this count does not see)."""
    L, G, _ = occ.shape
    ops = G * G * (K3_CLOSE_OPS * L + K3_ROUND_OPS * int(rounds.sum()))
    return bound(ops, 2 * 4 * L * G * G)


def k3_chain_bound(launches, clock_mhz: float, per_clock: float) -> float:
    """K3's least time on one SM per lane, in ms, for ``launches`` of
    (occ, rounds per lane): each launch takes its slowest lane's rounds of
    G * G cells x K3_ROUND_OPS, plus the close, at one SM's ``per_clock``
    cell operations a clock at ``clock_mhz``."""
    ops = sum(occ.shape[1] ** 2 * (K3_ROUND_OPS * int(rounds.max())
                                   + K3_CLOSE_OPS)
              for occ, rounds in launches)
    return ops / (per_clock * clock_mhz * 1e6) * 1e3


def cell_ops_per_clock() -> float:
    """Cell minima one SM takes a clock: twice the rate of ``min.u16x2``
    that ``VMIN2_PROBE`` measures on the card.  Fails if the rate exceeds
    the SM's issue ceiling (the probe's minima were not all issued)."""
    import ctypes

    from plade_tpu_torch.kernels import build
    src = build.BUILD_DIR / "vmin2_probe.cu"
    lib = build.BUILD_DIR / "libvmin2_probe.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(VMIN2_PROBE)
    build._run([[build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                 str(lib), str(src)]])
    dll = ctypes.CDLL(str(lib))
    dll.plade_vmin2_rate.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int]
    dll.plade_vmin2_rate.restype = ctypes.c_double
    threads = 1024
    out = torch.empty(threads, dtype=torch.int32, device="cuda")
    clocks = torch.zeros(1, dtype=torch.int64, device="cuda")
    rates = [dll.plade_vmin2_rate(out.data_ptr(), clocks.data_ptr(), 4096,
                                  threads) for _ in range(4)]
    rate = statistics.median(rates[1:])
    print(f"[b] min.u16x2 on one SM: {rate:.2f} a clock (runs "
          f"{[round(r, 2) for r in rates]}; issue ceiling {SM_ISSUE}), so "
          f"{2 * rate:.2f} cell minima a clock", flush=True)
    if not 0 < rate <= SM_ISSUE * 1.01:
        fail(f"min.u16x2 probe: {rate} a clock is outside (0, {SM_ISSUE}]")
    return 2 * rate


def sm_clock_mhz(fn) -> float:
    """The SM clock in MHz that nvidia-smi reads during back-to-back calls
    of ``fn`` (printed with the power draw)."""
    reading = sm_clock_under(fn)
    print(f"    SM clock, power under it: {reading}", flush=True)
    return float(reading.split()[0])


def k3_turns(fns, grids):
    """Device time of the launches ``fn(occ, iters)`` over ``grids`` (a
    list of (occ, iters)), summed, for each ``fn`` in turn."""
    return [sum(queued_ms(lambda: fn(occ, iters), 9) for occ, iters in grids)
            for fn in fns]


def check_cc(cc, per_clock: float, old_k3=None):
    """K3 and K3' against the plain version, bit for bit (integers), at
    G = 32, 48 and 128 (the generic instance) on L = 6 and at G = 64 on
    L = 6 and 12; times, rounds, both bounds (the chain bound at
    ``per_clock`` cell operations a clock) and, with ``old_k3`` (the
    parent's K3), the same bits and times in turns at G = 64, L = 6.
    Returns the rows of the kernels' JSON line."""
    iters = 256
    for G in (32, 48, 128):
        occ = cc_grids(6, G, seed=G)
        lab = cc.close_and_label_lanes(occ, iters)
        torch.cuda.synchronize()
        if not torch.equal(lab, cc.close_and_label_lanes_plain(occ, iters)):
            fail(f"close_and_label_lanes L=6 G={G} differs from the plain "
                 "version")
        print(f"[b] K3 close_and_label_lanes L=6 G={G} iters={iters}: "
              "bit-identical to the plain version", flush=True)
    G = 64
    rows = []
    for L in (6, 12):
        occ = cc_grids(L, G, seed=L)
        lab = cc.close_and_label_lanes(occ, iters)
        torch.cuda.synchronize()
        plain = cc.close_and_label_lanes_plain(occ, iters)
        if not torch.equal(lab, plain):
            bad = (lab != plain).reshape(L, -1).any(1).nonzero().flatten()
            fail(f"close_and_label_lanes L={L}: lanes {bad.tolist()} differ "
                 "from the plain version")
        # the serpentine lane must be unconverged at 256 rounds, and its
        # converged labels must agree too
        long_k = cc.close_and_label_lanes(occ[:1], G * G)
        long_p = cc.close_and_label_lanes_plain(occ[:1], 2 * G * G // 3)
        if torch.equal(long_k, lab[:1]):
            fail("serpentine grid converged within 256 rounds")
        if not torch.equal(long_k, long_p):
            fail("serpentine grid: converged labels differ")
        if not (lab[1] == G * G).all() or not (lab[2] == 0).all():
            fail("empty / full grid labels wrong")
        print(f"[b] K3 close_and_label_lanes L={L} G={G} iters={iters}: "
              f"bit-identical to the plain version on {L} lanes "
              f"(serpentine unconverged, empty, full, random); "
              "components in lane 5: "
              f"{int((torch.unique(lab[5]) < G * G).sum())}",
              flush=True)
        if L == 6:
            ms = queued_ms(lambda: cc.close_and_label_lanes(occ, iters))
            plain_ms = cuda_ms(
                lambda: cc.close_and_label_lanes_plain(occ, iters))
            rounds = k3_rounds(cc, occ, iters)
            bound_ms, bound_by = k3_bound(occ, rounds)
            clock = sm_clock_mhz(lambda: cc.close_and_label_lanes(occ, iters))
            chain_ms = k3_chain_bound([(occ, rounds)], clock, per_clock)
            print(f"[b] K3 L=6: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                  f"rounds per lane {rounds.tolist()}, "
                  f"{ms * 1e3 / int(rounds.max()):.4f} us a round of the "
                  f"slowest lane; bound {bound_ms:.6f} ms ({bound_by}), "
                  f"chain bound {chain_ms:.6f} ms at {clock:.0f} MHz",
                  flush=True)
            rows.append({"name": "close_and_label_lanes", "route": "cuda",
                         "source": "plade_tpu_torch/csrc/cc.cu",
                         "replaces": "plade_tpu/kernels/cc.py:105",
                         "shape": f"{L}x{G}x{G}",
                         "max_abs_err": (lab - plain).abs().max().item(),
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "chain_bound_ms": chain_ms, "sm_clock_mhz": clock,
                         "cell_ops_per_clock": per_clock,
                         "rounds": int(rounds.max()), "library_ms": None,
                         "path": None})
            if old_k3 is not None:
                if not torch.equal(old_k3(occ, iters), lab):
                    fail("[b] K3: parent and change differ")
                new_k3 = cc.close_and_label_lanes
                turns = k3_turns([old_k3, new_k3, new_k3, old_k3],
                                 [(occ, iters)])
                rows[-1]["parent_ms"] = [turns[0], turns[3]]
                print(f"[b] K3 L=6, parent vs change in turns: parent "
                      f"{turns[0]:.4f}, change {turns[1]:.4f}, change "
                      f"{turns[2]:.4f}, parent {turns[3]:.4f} ms (same bits)",
                      flush=True)
    occ1 = cc_grids(4, G, seed=1)[3]
    lab1 = cc.close_and_label(occ1, iters)
    torch.cuda.synchronize()
    plain1 = cc.close_and_label_lanes_plain(occ1[None], iters)[0]
    if not torch.equal(lab1, plain1):
        fail("close_and_label (L=1) differs from the plain version")
    ms = queued_ms(lambda: cc.close_and_label(occ1, iters))
    plain_ms = cuda_ms(lambda: cc.close_and_label_lanes_plain(occ1[None],
                                                              iters))
    rounds = k3_rounds(cc, occ1[None], iters)
    bound_ms, bound_by = k3_bound(occ1[None], rounds)
    chain_ms = k3_chain_bound([(occ1[None], rounds)], clock, per_clock)
    print(f"[b] K3' close_and_label L=1: bit-identical; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, {int(rounds[0])} rounds, bound "
          f"{bound_ms:.6f} ms ({bound_by}), chain bound {chain_ms:.6f} ms at "
          f"{clock:.0f} MHz", flush=True)
    rows.append({"name": "close_and_label", "route": "cuda",
                 "source": "plade_tpu_torch/csrc/cc.cu",
                 "replaces": "plade_tpu/kernels/cc.py:126",
                 "shape": f"1x{G}x{G}",
                 "max_abs_err": (lab1 - plain1).abs().max().item(),
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "chain_bound_ms": chain_ms,
                 "sm_clock_mhz": clock, "cell_ops_per_clock": per_clock,
                 "rounds": int(rounds[0]),
                 "library_ms": None, "path": None})
    return rows


def k3_main_path(cc, grids, per_clock: float, old_k3=None, tag="[f]"):
    """K3 on the grids of the main path's launches (``grids``: (occ,
    iters) of each launch of a timed ``register_clouds``): bit for bit
    against the plain version (and the parent's K3), the time of each
    launch and their sum, the rounds, both bounds (the chain bound at
    ``per_clock`` cell operations a clock), and with ``old_k3`` the sum
    timed in turns.  Returns the row of the kernels' JSON line."""
    lane_rounds = []
    err = 0
    for occ, iters in grids:
        lab = cc.close_and_label_lanes(occ, iters)
        torch.cuda.synchronize()
        plain = cc.close_and_label_lanes_plain(occ, iters)
        err = max(err, (lab - plain).abs().max().item())
        if not torch.equal(lab, plain):
            fail(f"{tag} K3 differs from the plain version on a main-path "
                 "grid")
        if old_k3 is not None and not torch.equal(old_k3(occ, iters), lab):
            fail(f"{tag} K3: parent and change differ on a main-path grid")
        lane_rounds.append(k3_rounds(cc, occ, iters))
    launch_ms = [queued_ms(lambda: cc.close_and_label_lanes(occ, iters))
                 for occ, iters in grids]
    plain_ms = sum(cuda_ms(lambda: cc.close_and_label_lanes_plain(occ, iters))
                   for occ, iters in grids)
    bound_ms, bound_by = k3_bound(torch.cat([o for o, _ in grids]),
                                  torch.cat(lane_rounds))
    slowest = max(zip(lane_rounds, grids), key=lambda x: int(x[0].max()))[1]
    clock = sm_clock_mhz(lambda: cc.close_and_label_lanes(*slowest))
    chain_ms = k3_chain_bound(
        [(o, r) for (o, _), r in zip(grids, lane_rounds)], clock,
        per_clock)
    print(f"{tag} K3 on the main path: {len(grids)} launches, lanes x grid "
          f"{[tuple(o.shape) for o, _ in grids]}, rounds per lane "
          f"{[r.tolist() for r in lane_rounds]}; bit-identical to the plain "
          f"version; kernel ms per launch "
          f"{[round(t, 4) for t in launch_ms]}, sum {sum(launch_ms):.4f} ms, "
          f"plain {plain_ms:.3f} ms; bound of all launches {bound_ms:.6f} ms "
          f"({bound_by}), chain bound {chain_ms:.6f} ms at {clock:.0f} MHz",
          flush=True)
    L, G, _ = grids[0][0].shape
    row = {"name": "close_and_label_lanes", "route": "cuda",
           "source": "plade_tpu_torch/csrc/cc.cu",
           "replaces": "plade_tpu/kernels/cc.py:105",
           "shape": f"main path: {len(grids)} launches of {L}x{G}x{G}",
           "max_abs_err": err, "ms": sum(launch_ms), "launch_ms": launch_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "chain_bound_ms": chain_ms, "sm_clock_mhz": clock,
           "cell_ops_per_clock": per_clock,
           "rounds": [int(r.max()) for r in lane_rounds], "library_ms": None}
    if old_k3 is not None:
        new_k3 = cc.close_and_label_lanes
        turns = k3_turns([old_k3, new_k3, new_k3, old_k3], grids)
        row["parent_ms"] = [turns[0], turns[3]]
        print(f"{tag} K3 main-path launches summed, parent vs change in "
              "turns: "
              f"parent {turns[0]:.4f}, change {turns[1]:.4f}, change "
              f"{turns[2]:.4f}, parent {turns[3]:.4f} ms (same bits)",
              flush=True)
    return row


def extract_card_vs_cpu(pts, nrm, cfg, side):
    """Extract one cloud's planes on the card and on the CPU from the same
    draws (a CPU generator's, copied to the device each round) and require
    the same outcome, to the tolerances of the CPU parity tests against the
    reference: equal plane count and rounds, coefficients within 1e-4,
    sizes within max(2, 0.1%)."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.extract import ransac

    pad = pipeline._pad_size(pts.shape[0], maximum=cfg.max_points)
    S_cell = cfg.ransac_candidates_per_round // 2
    n_draw = -(-pad // max(cfg.ransac_score_subset, cfg.ransac_draw_subset))
    out = []
    for device in ("cuda", "cpu"):
        host_draws = ransac.generator_draws(
            torch.Generator().manual_seed(11), pad, S_cell, n_draw)

        def draws(state, device=device, host_draws=host_draws):
            host = state._replace(level_probs=state.level_probs.cpu())
            return tuple(x.to(device) for x in host_draws(host))

        cloud = ptypes.pad_cloud(pts, nrm, pad, device)
        planes, stats = ransac._cached_extractor(cfg, pad)(
            cloud.points, cloud.normals, cloud.count,
            cfg.ransac_min_allowed_support, draws=draws)
        out.append((int(planes.count), int(stats.rounds),
                    planes.coeffs.cpu().numpy(), planes.sizes.cpu().numpy()))
    (n_g, r_g, c_g, s_g), (n_c, r_c, c_c, s_c) = out
    coeff_diff = float(np.abs(c_g[:n_c] - c_c[:n_c]).max()) \
        if n_g == n_c else float("inf")
    size_ok = n_g == n_c and bool(
        (np.abs(s_g[:n_c] - s_c[:n_c]) <= np.maximum(2, 0.001 * s_c[:n_c]))
        .all())
    print(f"[e] {side} extraction on the same draws, card vs CPU: planes "
          f"{n_g} vs {n_c}, rounds {r_g} vs {r_c}, max coefficient diff "
          f"{coeff_diff:.3e}, sizes {'agree' if size_ok else 'differ'}",
          flush=True)
    if n_g != n_c or r_g != r_c or coeff_diff > 1e-4 or not size_ok:
        fail(f"[e] {side}: extraction differs between card and CPU")


def true_planes(gen, n_faces=6, half_size=2.0):
    """The scene's planes in the world frame.  ``make_room`` records each
    room face from its first point's normal, which carries that point's
    normal noise (2 deg here); the faces are axis-aligned at ``half_size``
    with inward normals, so their normals are rounded to the axis.  The
    interior planes are recorded exactly.  Returns (normals (G, 3), d (G,))
    in float64."""
    gn = np.stack([np.asarray(p[0], np.float64) for p in gen])
    gd = np.array([p[1] for p in gen], np.float64)
    gn[:n_faces] = np.round(gn[:n_faces])
    gd[:n_faces] = half_size
    return gn, gd


def plane_matches(planes, gen, R, t):
    """(count, G) bool: plane k of ``planes`` matches true plane g of the
    scene (moved into the cloud's frame by (R, t): the cloud is
    R^T (world - t)) within PLANE_TOL_DEG and PLANE_TOL_D, up to sign."""
    count = int(planes.count)
    coeffs = planes.coeffs[:count].cpu().double().numpy()
    gn, gd = true_planes(gen)
    gn_c = gn @ R.astype(np.float64)                  # rows R^T n
    gd_c = gd + gn @ t.astype(np.float64)
    dots = coeffs[:, :3] @ gn_c.T                      # (count, G)
    dd = np.abs(coeffs[:, 3:4] * np.sign(dots) - gd_c[None, :])
    return (np.abs(dots) >= math.cos(math.radians(PLANE_TOL_DEG))) \
        & (dd <= PLANE_TOL_D)


@contextlib.contextmanager
def recorded_extractions(ransac):
    """Records (planes, stats) of every extraction ``ransac.auto_extract``
    runs inside the ``with`` block, in call order, by wrapping the
    extractor it looks up; the extraction itself is untouched."""
    real = ransac._cached_extractor
    seen = []

    def wrapped(cfg, num_points):
        fn = real(cfg, num_points)

        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out)
            return out
        return run

    ransac._cached_extractor = wrapped
    try:
        yield seen
    finally:
        ransac._cached_extractor = real


@contextlib.contextmanager
def recorded_calls(module, name, keep):
    """Records ``keep(args, out)`` of every call of ``module.name`` made
    inside the ``with`` block, in call order; the call is untouched."""
    real = getattr(module, name)
    seen = []

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(keep(args, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def eager_k3_calls(keep):
    """A labelled eager run: inside the block extraction runs its eager
    loop, as on the CPU, whose every pass calls K3's wrapper, and
    ``keep(args, out)`` of each K3 call is recorded in call order.  On the
    card's main path a pass is a replay of extraction's CUDA graph, which
    calls no wrapper; so K3's inputs and lanes come from such a run, and
    each section that takes them holds the run's extractions, bit for bit,
    to its main-path run's on the same generators."""
    from plade_tpu_torch.extract import ransac
    real = ransac._use_graph
    ransac._use_graph = lambda points: False
    try:
        with recorded_calls(ransac, "close_and_label_lanes", keep) as seen:
            yield seen
    finally:
        ransac._use_graph = real


@contextlib.contextmanager
def extraction_counts():
    """The extraction counters (``extract.*``: passes, cloud-passes,
    frozen, graph replays and captures) of the work inside the block, read
    from one recorder call around it; the entries inside, and their shard
    threads, join that call."""
    from plade_tpu_torch.utils import timing
    counts = {}
    with timing.call("chip_smoke", 0) as c:
        yield counts
    counts.update({k: v for k, v in c.counters.items()
                   if k.startswith("extract.")})


def check_graph_passes(tag, k3, counts, clouds, problems):
    """The main path's extraction on the card (``counts``: one
    :func:`extraction_counts`): K3 launched (credited at each replay) once
    a lockstep pass, every pass captured or replayed from extraction's
    CUDA graph, each over ``clouds`` clouds (None: any).  Adds what fails
    to ``problems``; returns the passes."""
    rounds = counts.get("extract.rounds", 0)
    graph = counts.get("extract.graph_rounds", 0) \
        + counts.get("extract.graph_captures", 0)
    if not rounds or k3 != rounds or graph != rounds or (
            clouds is not None
            and counts.get("extract.cloud_rounds") != clouds * rounds):
        problems.append(f"{tag} K3 {k3} launches, extraction counters "
                        f"{counts}: not one launch a graph pass over "
                        f"{clouds} clouds")
    return rounds


def same_bits(a, b) -> bool:
    """Whether two (planes, stats) pairs, or transforms, are the same
    bits."""
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def kernel_calls(name, keep):
    """Records ``keep(tensors, None)`` of every call of the K1, K2 or K4
    wrapper ``name`` (``kernels.nn``) made inside the ``with`` block, in
    call order, where the wrapper checks its tensors: K2's and K4's
    (queries, refs), K1's (queries, qnormals, refs, rnormals).  Every caller's pass ends
    there, whatever object handed it down; the call is untouched."""
    from plade_tpu_torch.kernels import nn
    real = nn._check
    seen = []

    def checked(kernel, *tensors):
        if kernel == name:
            seen.append(keep(tensors, None))
        return real(kernel, *tensors)

    nn._check = checked
    try:
        yield seen
    finally:
        nn._check = real


def k4_shape(a, out):
    """(P, Q, T) of a K4 call's (queries, refs), for :func:`kernel_calls`:
    P = 1 for a call without a cloud axis."""
    return (a[0][..., 0, 0].numel(), a[0].shape[-2], a[1].shape[-2])


def shape_counts(name, shapes, into=None):
    """``into`` (a new dict by default) with each of ``shapes`` counted
    under (``name``, its ``PxQxT`` string), the key of the kernels' rows."""
    into = {} if into is None else into
    for shape in shapes:
        key = (name, "x".join(map(str, shape)))
        into[key] = into.get(key, 0) + 1
    return into


def check_register_clouds(tp, tn, sp, sn, R, t, gen, cfg, device):
    """(f) ``register_clouds`` on the raw clouds: one warm-up, three timed
    runs; its one lockstep extraction of both clouds, rounds and selected
    planes per cloud against the scene's planes; pose error, counters, kernel launches (returned) and
    host syncs of the first timed run, whose extractions are the ones
    checked.  (g) ``register_files`` on the same clouds written as PLY must
    give the same transform.  K3's inputs come from one more run with
    extraction on its eager loop (:func:`eager_k3_calls`), whose
    extractions and transform must be the first timed run's bits.  Returns
    a dict: that run's ``launches``, its K4 launches by shape
    (``by_shape``, :func:`shape_counts`), the (occ, iters) of each K3
    launch (``k3_grids``), its ``extractions`` ((planes, stats) per
    cloud), its transform ``T``, (g)'s transform ``files_T``, and the
    ``walls``."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.extract import ransac
    from plade_tpu_torch.io.ply import write_ply
    from plade_tpu_torch.kernels import nn
    from plade_tpu_torch.pipeline import register_clouds, register_files

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    T, info = register_clouds(tp, tn, sp, sn, cfg, seed=0,
                              device=device)                 # warm-up
    walls = []
    for run in range(3):
        if run == 0:
            reset_counts()
        # the first timed run also keeps each prepared cloud's live
        # downsampled count (device tensors: no sync)
        with recorded_extractions(ransac) as seen, \
                recorded_calls(pipeline, "prepare_cloud",
                               lambda a, out: out.ds.count) as ds_counts, \
                kernel_calls("topk_dist_sq", k4_shape) as k4_shapes, \
                extraction_counts() as counts:
            sync()
            t0 = time.perf_counter()
            T, info = register_clouds(tp, tn, sp, sn, cfg, seed=0,
                                      device=device)
            sync()
            walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = dict(nn.LAUNCHES)
            syncs = ptypes.HOST_SYNCS["count"]
            first_seen = seen
            live = [int(c) for cs in ds_counts for c in cs.reshape(-1)]
            first_counts, first_T = counts, T
            first_k4 = k4_shapes
    # K3's inputs: the same registration with extraction's eager loop
    with eager_k3_calls(lambda a, out: (a[0].clone(), a[1])) as k3_grids, \
            recorded_extractions(ransac) as eager:
        T_eager, _ = register_clouds(tp, tn, sp, sn, cfg, seed=0,
                                     device=device)
    if not same_bits(eager, first_seen) or not same_bits(T_eager, first_T):
        fail("[f] the eager loop's extractions or transform differ from "
             "the main path's")
    check_result("[f]", T, info)
    print(f"[f] K4 (P, Q, T) of the first timed run: {first_k4}", flush=True)
    if len(first_k4) != 1 or launches["topk_dist_sq"] != 1:
        fail(f"[f] K4 calls {first_k4}, launches {launches}: not one "
             "spacing through K4")
    if info["swapped"] or len(first_seen) != 1 \
            or first_seen[0][1].rounds.shape != (2,):
        fail(f"[f] {len(first_seen)} extraction calls (swapped "
             f"{info['swapped']}), expected one over target and source")
    # (planes, stats) per cloud, target then source
    extractions = [tuple(type(x)(*(f[c] for f in x)) for x in first_seen[0])
                   for c in range(2)]
    frames = ((np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
              (R, t))
    rounds = []
    for (planes, stats), (Rf, tf), side, key in zip(
            extractions, frames, ("target", "source"),
            ("tgt_planes", "src_planes")):
        sel = ransac.select_planes_device(planes, cfg)
        n_sel = int(sel.count)
        # every scene plane extracted; every selected plane one of them,
        # each a different one
        found = plane_matches(planes, gen, Rf, tf).any(0)
        ok_sel = plane_matches(sel, gen, Rf, tf)
        rounds.append(int(stats.rounds))
        print(f"[f] {side}: {int(stats.rounds)} extraction rounds, "
              f"{int(planes.count)} planes extracted ({int(found.sum())} of "
              f"the {len(gen)} scene planes within {PLANE_TOL_DEG} deg / "
              f"{PLANE_TOL_D}), {n_sel} selected, sizes "
              f"{sel.sizes[:n_sel].tolist()}", flush=True)
        if not found.all():
            fail(f"[f] {side}: scene planes "
                 f"{np.flatnonzero(~found).tolist()} not extracted")
        if not ok_sel.any(1).all() or (ok_sel.sum(0) > 1).any():
            fail(f"[f] {side}: selected planes do not match distinct scene "
                 "planes")
        if n_sel < cfg.min_planes:
            fail(f"[f] {side}: {n_sel} planes selected < {cfg.min_planes}")
        if n_sel != info[key]:
            fail(f"[f] {side}: {n_sel} selected planes, {info[key]} in "
                 "register_clouds' info")
    rot, trans = pose_errors(T, R, t)
    print(f"[f] register_clouds: rotation error {rot:.6f} deg, translation "
          f"error {trans:.6f}, matched_planes {info['matched_planes']}, "
          f"score {info['score']:.6f}, overlap {info['overlap']:.6f}",
          flush=True)
    print(f"[f] counters: match_saturated {info['match_saturated']}, "
          f"pen_overflow {info['pen_overflow']}, cluster_truncated "
          f"{info['cluster_truncated']}", flush=True)
    print(f"[f] launches per registration: {launches}; host syncs {syncs}; "
          f"wall per pair (median of 3) {statistics.median(walls) * 1e3:.1f}"
          f" ms, runs {[round(w * 1e3, 1) for w in walls]} ms", flush=True)
    print(f"[f] live downsampled points (target, source): {live} of "
          f"max_ds_points {cfg.max_ds_points} (the K1/K2 rows past them are "
          "padding)", flush=True)
    if rot >= ROT_TOL_DEG or trans >= TRANS_TOL:
        fail(f"[f] pose error {rot} deg / {trans} beyond {ROT_TOL_DEG} / "
             f"{TRANS_TOL}")
    for key in ("match_saturated", "pen_overflow", "cluster_truncated"):
        if info[key] != 0:
            fail(f"[f] {key} = {info[key]}")
    print(f"[f] extraction counters {first_counts}; the eager loop: "
          f"{len(k3_grids)} K3 calls, the main path's extractions and "
          "transform bit for bit", flush=True)
    if torch.device(device).type == "cuda":
        # one K3 launch per lockstep round of both clouds, every round on
        # the graph, and one K3 call per round of the eager loop
        problems = []
        if check_graph_passes("[f]", launches["close_and_label_lanes"],
                              first_counts, 2, problems) != max(rounds) \
                or len(k3_grids) != max(rounds):
            problems.append(f"[f] {len(k3_grids)} eager K3 calls, rounds "
                            f"{rounds}")
        if problems:
            fail("; ".join(problems))
        if launches["oriented_min_dist_sq"] < 2 \
                or launches["nearest_neighbor"] < 4:
            fail(f"[f] kernel launches {launches} below K1 >= 2, K2 >= 4")

    if torch.device(device).type == "cuda":
        # the entry point's default device is the card
        reset_counts()
        Td, info_d = register_clouds(tp, tn, sp, sn, cfg, seed=0)
        default_launches = dict(nn.LAUNCHES)
        check_result("[f] default device", Td, info_d)
        drot, dtrans = pose_errors(Td, T[:3, :3].astype(np.float64), T[:3, 3])
        print(f"[f] register_clouds without device=: launches "
              f"{default_launches}, rotation diff {drot:.6f} deg, "
              f"translation diff {dtrans:.3e} from device=\"cuda\"",
              flush=True)
        if min(default_launches.values()) < 1:
            fail(f"[f] register_clouds without device= launched "
                 f"{default_launches}: not on the card")
        if drot >= FILES_TOL_DEG or dtrans >= FILES_TOL_T:
            fail("[f] register_clouds without device= disagrees")

    # (g) register_files on the same clouds written as PLY
    with tempfile.TemporaryDirectory() as tmp:
        tgt_file, src_file = Path(tmp) / "target.ply", Path(tmp) / "source.ply"
        write_ply(str(tgt_file), tp, tn)
        write_ply(str(src_file), sp, sn)
        Tf, info_f = register_files(str(tgt_file), str(src_file), cfg,
                                    seed=0, device=device)
    check_result("[g]", Tf, info_f)
    drot, dtrans = pose_errors(Tf, T[:3, :3].astype(np.float64), T[:3, 3])
    print(f"[g] register_files vs register_clouds: rotation diff "
          f"{drot:.6f} deg, translation diff {dtrans:.3e}", flush=True)
    if drot >= FILES_TOL_DEG or dtrans >= FILES_TOL_T:
        fail("[g] register_files disagrees with register_clouds")
    return dict(launches=launches,
                by_shape=shape_counts("topk_dist_sq", first_k4),
                k3_grids=k3_grids, extractions=extractions, T=T, files_T=Tf,
                walls=walls)


def reset_counts():
    """Set every kernel's launch count and the host-sync count to 0."""
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.kernels import nn
    for k in nn.LAUNCHES:
        nn.LAUNCHES[k] = 0
    ptypes.HOST_SYNCS["count"] = 0


def check_counters(tag, res, problems):
    """The three truncation counters of a ``RegistrationResult``, printed;
    a non-zero one is added to ``problems``."""
    counts = {k: int(getattr(res, k)) for k in
              ("match_saturated", "pen_overflow", "cluster_truncated")}
    print(f"{tag} counters: {counts}", flush=True)
    problems += [f"{tag} {k} = {v}" for k, v in counts.items() if v]


def check_pose(tag, T, R, t, problems):
    """Pose error of T against (R, t), printed; beyond the limits it is
    added to ``problems``.  Returns (rotation deg, translation)."""
    rot, trans = pose_errors(T, R, t)
    print(f"{tag} rotation error {rot:.6f} deg, translation error "
          f"{trans:.6f}", flush=True)
    if not (rot < ROT_TOL_DEG and trans < TRANS_TOL):
        problems.append(f"{tag} pose error {rot} deg / {trans} beyond "
                        f"{ROT_TOL_DEG} / {TRANS_TOL}")
    return rot, trans


def same_planes(tag, a, b):
    """Plane sets ``a`` and ``b`` of one cloud: equal counts, coefficients
    within 1e-4 and sizes within max(2, 0.1%) (the tolerances of (e));
    fails otherwise.  Returns the largest coefficient difference."""
    n = int(a.count)
    if int(b.count) != n:
        fail(f"{tag} {n} planes against {int(b.count)}")
    ca, cb = a.coeffs[:n].cpu().numpy(), b.coeffs[:n].cpu().numpy()
    sa, sb = a.sizes[:n].cpu().numpy(), b.sizes[:n].cpu().numpy()
    diff = float(np.abs(ca - cb).max()) if n else 0.0
    if diff > 1e-4 or (np.abs(sa - sb) > np.maximum(2, 0.001 * sb)).any():
        fail(f"{tag} planes differ: coefficients by {diff:.3e}, sizes "
             f"{sa.tolist()} vs {sb.tolist()}")
    return diff


def check_device_step(scene, cfg, clouds_run, clouds_table):
    """(i) the device step on the scene of (c) at ``cfg``: one warm-up and
    three timed runs; the first timed run's extraction against (f)'s
    (``clouds_run``), its transform within 1e-4 of (f)'s, pose error,
    counters, K3 launches (one per lockstep round, each over 2 x 6 lanes:
    the lanes, and ``k3_grids``, from one more run with extraction's eager
    loop, :func:`eager_k3_calls`, which must give the first run's bits),
    K1/K2 launches, host syncs, wall and peak memory beside
    ``register_clouds``', and one profiled step (its kernels beside
    ``clouds_table``'s, (h)).  Returns a dict: the padded clouds, the
    ``launches``, the K3 grids of the first timed run (``k3_grids``), that
    run's prepared clouds with their ``dsd`` (``prepared``: one
    ``prepare_cloud`` call over both clouds, leading axis (target,
    source)), its host syncs, the profiled step's kernels and the wall."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.extract import ransac
    from plade_tpu_torch.kernels import nn
    tp, tn, sp, sn, R, t = scene
    pad = pipeline._pad_size(max(tp.shape[0], sp.shape[0]),
                             maximum=cfg.max_points)
    tgt = ptypes.pad_cloud(tp, tn, pad, "cuda")
    src = ptypes.pad_cloud(sp, sn, pad, "cuda")
    step = pipeline.register_pair_device(cfg, pad)       # the card: default
    step(tgt, src, 0)                                    # warm-up
    torch.cuda.synchronize()
    walls = []
    for run in range(3):
        if run == 0:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
        with recorded_extractions(ransac) as seen, \
                recorded_calls(pipeline, "prepare_cloud",
                               lambda a, out: (out, a[2])) as preps, \
                extraction_counts() as counts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(tgt, src, 0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = dict(nn.LAUNCHES)
            syncs = ptypes.HOST_SYNCS["count"]
            peak = torch.cuda.max_memory_allocated()
            first, first_seen, first_counts, prepared = res, seen, counts, \
                preps
    res, seen = first, first_seen
    if len(seen) != 1:
        fail(f"[i] {len(seen)} extraction calls, expected one lockstep call")
    (planes, stats), = seen
    rounds = stats.rounds.tolist()
    # K3's inputs and lanes: the same step with extraction's eager loop
    with eager_k3_calls(lambda a, out: (a[0].clone(), a[1])) as k3_grids, \
            recorded_extractions(ransac) as eager:
        res_eager = step(tgt, src, 0)
    lanes = [int(o.shape[0]) for o, _ in k3_grids]
    print(f"[i] register_pair_device: lockstep extraction rounds (target, "
          f"source) {rounds}, planes extracted "
          f"{planes.count.tolist()}; K3 launches "
          f"{launches['close_and_label_lanes']}, extraction counters "
          f"{first_counts}; the eager loop: {len(k3_grids)} K3 calls over "
          f"lanes {sorted(set(lanes))}", flush=True)
    problems = []
    check_graph_passes("[i]", launches["close_and_label_lanes"],
                       first_counts, 2, problems)
    if len(k3_grids) != max(rounds) or set(lanes) != \
            {2 * cfg.ransac_exact_lanes}:
        problems.append(f"[i] eager K3 calls {lanes}: not one per lockstep "
                        f"round ({max(rounds)}) at L = "
                        f"{2 * cfg.ransac_exact_lanes}")
    if not same_bits(eager, seen) \
            or not same_bits(res_eager.transform, res.transform):
        problems.append("[i] the eager loop's extraction or transform "
                        "differs from the main path's")
    if problems:
        fail("; ".join(problems))
    diffs = []
    for c, (side, (p1, s1)) in enumerate(zip(("target", "source"),
                                             clouds_run["extractions"])):
        pc = ptypes.PlaneSet(*(x[c] for x in planes))
        diffs.append(same_planes(f"[i] {side} vs (f):", pc, p1))
        if int(stats.rounds[c]) != int(s1.rounds):
            fail(f"[i] {side}: {int(stats.rounds[c])} rounds, (f) "
                 f"{int(s1.rounds)}")
    T = res.transform.cpu().numpy()
    dT = float(np.abs(T - clouds_run["T"]).max())
    print(f"[i] extraction equals register_clouds' (f): coefficient "
          f"differences {diffs}, rounds equal; transform differs from (f)'s "
          f"by {dT:.3e} at most", flush=True)
    if dT >= 1e-4 or not bool(res.success):
        fail(f"[i] step: success {bool(res.success)}, transform differs from "
             f"register_clouds' by {dT}")
    problems = []
    check_pose("[i]", T, R, t, problems)
    check_counters("[i]", res, problems)
    if problems:
        fail("; ".join(problems))
    if launches["oriented_min_dist_sq"] < 2 or launches["nearest_neighbor"] \
            < 4:
        fail(f"[i] kernel launches {launches} below K1 >= 2, K2 >= 4")
    torch.cuda.reset_peak_memory_stats()
    from plade_tpu_torch.pipeline import register_clouds
    register_clouds(tp, tn, sp, sn, cfg, seed=0)
    torch.cuda.synchronize()
    clouds_peak = torch.cuda.max_memory_allocated()
    print(f"[i] launches per pair {launches} (register_clouds "
          f"{clouds_run['launches']}); host syncs {syncs}; wall per pair "
          f"(median of 3) {statistics.median(walls) * 1e3:.1f} ms, runs "
          f"{[round(w * 1e3, 1) for w in walls]} ms; register_clouds in this "
          f"call {statistics.median(clouds_run['walls']) * 1e3:.1f} ms, runs "
          f"{[round(w * 1e3, 1) for w in clouds_run['walls']]} ms; peak "
          f"memory {peak / 2**20:.1f} MiB (register_clouds "
          f"{clouds_peak / 2**20:.1f} MiB)", flush=True)
    table = profile_stages(lambda: step(tgt, src, 0), tag="[i]")
    print(f"[i] kernels per pair: step {table['(total)'][2]}, "
          f"register_clouds {clouds_table['(total)'][2]} ((h)); extraction "
          f"{table['plade.extract'][2]} vs "
          f"{clouds_table['plade.extract'][2]}", flush=True)
    return dict(clouds=(tgt, src), pad=pad, launches=launches,
                k3_grids=k3_grids, prepared=prepared, syncs=syncs,
                kernels=table["(total)"][2],
                wall=statistics.median(walls))


def check_options(scene, cfg, step_run):
    """(j) the step with ``enable_icp``, (k) with a line-confidence cull and
    with the degraded families, and ``register_clouds`` with a pinned
    support, on the scene of (c).  Each is run once with the counts at 0;
    pose error and counters are held to (c)'s limits.  Returns (launches by
    path, the final ICP's K2 launches at ``ICP_SHAPE``)."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.kernels import nn
    tp, tn, sp, sn, R, t = scene
    tgt, src = step_run["clouds"]
    pad = step_run["pad"]
    problems, paths = [], {}

    # (j) the final ICP: the rescore's 4 K2 launches, then icp_iters + 1
    cfg_icp = dataclasses.replace(cfg, enable_icp=True)
    reset_counts()
    with kernel_calls("nearest_neighbor",
                      lambda a, out: (a[0].shape[-2],
                                      a[1].shape[-2])) as shapes:
        res = pipeline.register_pair_device(cfg_icp, pad)(tgt, src, 0)
        torch.cuda.synchronize()
    paths["enable_icp"] = dict(nn.LAUNCHES)
    at_shape = sum(s == ICP_SHAPE for s in shapes)
    print(f"[j] enable_icp: launches {paths['enable_icp']}, K2 at "
          f"{ICP_SHAPE[0]}x{ICP_SHAPE[1]}: {at_shape} (icp_iters "
          f"{cfg.icp_iters} + 1), shapes {sorted(set(shapes))}", flush=True)
    if at_shape != cfg.icp_iters + 1 or \
            paths["enable_icp"]["nearest_neighbor"] != len(shapes):
        problems.append(f"[j] K2 launches {shapes}")
    check_pose("[j]", res.transform.cpu().numpy(), R, t, problems)
    check_counters("[j]", res, problems)
    if not bool(res.success):
        problems.append("[j] registration failed")

    # (k) line confidence: a threshold at the 30% quantile of the source's
    # line confidences in (i), so that the cull drops part of its lines
    from plade_tpu_torch.core.ops import tree_map
    (both, dsd2), = step_run["prepared"]
    prep, dsd = tree_map(lambda x: x[1], both), dsd2[1]
    n_lines = int(prep.lines.count)
    conf = pipeline._line_confidence(prep.lines, prep.geom, dsd, cfg)
    thresh = float(torch.quantile(conf[:n_lines], 0.3))
    cfg_lc = dataclasses.replace(cfg, min_line_confidence=thresh)
    reset_counts()
    with recorded_calls(pipeline, "prepare_cloud",
                        lambda a, out: out.lines.count) as kept:
        res = pipeline.register_pair_device(cfg_lc, pad)(tgt, src, 0)
        torch.cuda.synchronize()
    paths["min_line_confidence"] = dict(nn.LAUNCHES)
    kept = [int(k) for c in kept for k in c.reshape(-1)]
    print(f"[k] min_line_confidence {thresh:.4g}: lines kept (target, "
          f"source) {kept}, source lines without the cull {n_lines}; "
          f"launches {paths['min_line_confidence']}", flush=True)
    if not kept[1] < n_lines:
        problems.append(f"[k] the cull kept all {n_lines} source lines")
    check_pose("[k] line confidence:", res.transform.cpu().numpy(), R, t,
               problems)
    check_counters("[k] line confidence:", res, problems)

    # the degraded families add up to 2 x max_degraded_matches hypotheses
    # behind the 2-2 ones; on this scene the default 8192-row cluster
    # prefix drops ~10.8k of them (cluster_truncated), so the prefix covers
    # the whole stitched buffer
    cfg_deg = dataclasses.replace(
        cfg, enable_degraded_families=True,
        max_cluster_hypotheses=cfg.max_matches + 2 * cfg.max_degraded_matches)
    reset_counts()
    res = pipeline.register_pair_device(cfg_deg, pad)(tgt, src, 0)
    torch.cuda.synchronize()
    paths["enable_degraded_families"] = dict(nn.LAUNCHES)
    print(f"[k] enable_degraded_families: success {bool(res.success)}, "
          f"matched planes {int(res.matched_planes)}, score "
          f"{float(res.score):.6f}; launches "
          f"{paths['enable_degraded_families']}", flush=True)
    check_pose("[k] degraded families:", res.transform.cpu().numpy(), R, t,
               problems)
    check_counters("[k] degraded families:", res, problems)

    reset_counts()
    T, info = pipeline.register_clouds(tp, tn, sp, sn, cfg, seed=0,
                                       ransac_min_support=2000)
    paths["ransac_min_support"] = dict(nn.LAUNCHES)
    print(f"[k] register_clouds(ransac_min_support=2000): planes "
          f"{info.get('tgt_planes')} / {info.get('src_planes')}, success "
          f"{info.get('success')}; launches {paths['ransac_min_support']}",
          flush=True)
    check_pose("[k] pinned support:", T, R, t, problems)
    counts = {k: info.get(k) for k in ("match_saturated", "pen_overflow",
                                       "cluster_truncated")}
    print(f"[k] pinned support: counters {counts}", flush=True)
    problems += [f"[k] pinned {k} = {v}" for k, v in counts.items() if v]
    for path, counts in paths.items():
        if min(counts.values()) < 1:
            problems.append(f"{path}: a kernel was not launched: {counts}")
    if problems:
        fail("; ".join(problems))
    return paths, at_shape


#: the start-up of a CLI process before it registers: ``import torch``, the
#: port's CLI modules, then the CUDA context; prints the three times
STARTUP_PROBE = (
    "import time; t0 = time.perf_counter(); import torch; "
    "t1 = time.perf_counter(); import plade_tpu_torch.cli.main, "
    "plade_tpu_torch.pipeline; t2 = time.perf_counter(); "
    "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
    "print(t1 - t0, t2 - t1, time.perf_counter() - t2)")
#: the settings of ``bench.py``'s batch pairs (bench.py:84-89), as
#: ``make_scan_sequence`` keywords; phase (n) changes only ``step``
SCAN_SETTINGS = dict(overlap_radius=3.4, step=2.0, n_rooms=3,
                     n_per_plane=9000, noise=0.02, size=4.0, extra_planes=3,
                     normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)


def scan_pairs(cfg, count: int = 4):
    """The distinct synthetic scan pairs of (l) (4) and (o) (7):
    ``make_scan_sequence`` at ``SCAN_SETTINGS`` from rng 1000 + b, b =
    1..count.  Returns (pairs of (target points, normals, source points,
    normals), ground truth 4x4 target-from-source transforms)."""
    from plade_tpu_torch.io.synthetic import make_scan_sequence
    pairs, truth = [], []
    for b in range(1, count + 1):
        scans, poses = make_scan_sequence(
            np.random.default_rng(1000 + b), n_scans=2,
            n_points=min(cfg.max_points, 100000), **SCAN_SETTINGS)
        pairs.append((*scans[0], *scans[1]))
        truth.append(np.linalg.inv(poses[0]) @ poses[1])
    return pairs, truth


def check_array_pairs(cfg):
    """(l) ``register_array_pairs`` on 4 distinct synthetic scan pairs at
    the settings of ``bench.py``'s batch pairs: every pair succeeds; pose
    errors against the scans' ground truth are printed; the pairs run in
    one lockstep batch (K2 4 launches, K3 one a lockstep pass over 4 x 2
    clouds).  Returns the run's launches."""
    from plade_tpu_torch.dist.mesh import register_array_pairs
    from plade_tpu_torch.kernels import nn
    pairs, truth = scan_pairs(cfg)
    reset_counts()
    t0 = time.perf_counter()
    with extraction_counts() as counts:
        outs = register_array_pairs(pairs, cfg, seed=0)
    wall = time.perf_counter() - t0
    launches = dict(nn.LAUNCHES)
    check_lockstep("[l]", launches, counts, len(pairs), cfg)
    for i, (o, gt) in enumerate(zip(outs, truth)):
        rot, trans = pose_errors(o.transform, gt[:3, :3], gt[:3, 3])
        print(f"[l] pair {i}: {pairs[i][0].shape[0]} / "
              f"{pairs[i][2].shape[0]} points, success {o.success}, score "
              f"{o.score:.6f}, matched planes {o.matched_planes}, rotation "
              f"error {rot:.4f} deg, translation error {trans:.4f}, "
              f"counters {o.match_saturated}/{o.pen_overflow}/"
              f"{o.cluster_truncated}", flush=True)
    print(f"[l] register_array_pairs: {len(outs)} pairs in {wall:.2f} s; "
          f"launches {launches}", flush=True)
    if len(outs) != 4 or not all(o.success for o in outs):
        fail(f"[l] pairs failed: {[o.success for o in outs]}")
    if min(launches.values()) < 1:
        fail(f"[l] a kernel was not launched: {launches}")
    return launches


def check_lockstep(tag, launches, counts, pairs: int, cfg):
    """The launches of one lockstep batch of ``pairs`` pairs (``counts``:
    its :func:`extraction_counts`): K2 once a pass of the rescore ICP
    (``rescore_icp_iters`` + 1) and K3 once a lockstep pass of
    extraction's graph over every cloud (2 x pairs); fails otherwise."""
    k2 = cfg.rescore_icp_iters + 1
    print(f"{tag} one lockstep batch of {pairs} pairs: K2 "
          f"{launches['nearest_neighbor']} launches (expected {k2}), K1 "
          f"{launches['oriented_min_dist_sq']}, K3 "
          f"{launches['close_and_label_lanes']}; extraction counters "
          f"{counts} (expected {2 * pairs} clouds a pass)", flush=True)
    problems = []
    check_graph_passes(tag, launches["close_and_label_lanes"], counts,
                       2 * pairs, problems)
    if launches["nearest_neighbor"] != k2 or problems:
        fail(f"{tag} not one lockstep batch: launches {launches}; "
             + "; ".join(problems))


def result_matrices(path: str, count: int):
    """The ``count`` (target, source, 4x4) blocks of a CLI result file,
    read with the port's viewer reader; fails if one does not parse."""
    from plade_tpu_torch.cli.viewer import _parse_results
    blocks = [_parse_results(path, k) for k in range(count)]
    if any(b is None for b in blocks) or _parse_results(path, count):
        fail(f"{path}: not {count} parsable result blocks")
    return blocks


def run_cli(tag, argv, problems):
    """``plade_tpu_torch.cli.main(argv)`` in this process with the counts
    at 0; a non-zero exit is added to ``problems``.  Returns (launches,
    wall seconds)."""
    from plade_tpu_torch.cli.main import main as cli_main
    from plade_tpu_torch.kernels import nn
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        problems.append(f"{tag} exit code {rc}")
    return dict(nn.LAUNCHES), wall


#: the ``plade.*`` ranges of the device step (``utils.timing.stage``)
STEP_STAGES = ("extract", "spacing", "prepare", "descriptors", "match",
               "cluster", "consistency", "penetration", "overlap", "rescore")


def profiled_batch(tmp: Path, pairs_file: Path, problems):
    """(m) ``--device-batch --profile DIR`` in this process, the counts at
    0: the trace holds every ``plade.*`` range of the device step and one
    kernel event for each counted K1, K2 and K3 launch."""
    trace = tmp / "trace_batch"
    launches, wall = run_cli(
        "[m] --device-batch --profile",
        [str(pairs_file), str(tmp / "profiled_batch.txt"), "--device-batch",
         "--profile", str(trace)], problems)
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("plade.")}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(name in e for e in kernels)
             for k, name in KERNEL_NAMES.items()}
    missing = sorted(f"plade.{s}" for s in STEP_STAGES
                     if f"plade.{s}" not in ranges)
    print(f"[m] --device-batch --profile: {wall:.3f} s; ranges "
          f"{sorted(ranges)}; kernel events {found} of launches {launches}",
          flush=True)
    if missing or found != launches:
        problems.append(f"[m] --device-batch trace: missing ranges "
                        f"{missing}, kernel events {found} of launches "
                        f"{launches}")


def check_cli(scene, files_T, cfg):
    """(m) the command line on the card at the default ``PladeConfig``.
    A subprocess ``python -m plade_tpu_torch.cli T.ply S.ply OUT --profile
    DIR`` (no ``--device``) on the room of (c): exit 0, its matrix within
    the pose limits and within 1e-4 of (g)'s ``register_files`` transform
    ``files_T``, and its trace holding K1, K2 and K3 kernel events; the same
    without ``--profile``, for the start-up cost.  Then ``main`` in this
    process, each run with the counts at 0: single, ``--icp``, batch over
    the scan pairs of (l) sequentially and with ``--device-batch`` (every
    pair within the limits), ``--device-batch --profile`` (its trace,
    :func:`profiled_batch`), and ``view`` to PLY and to HTML.  Returns the
    launches by path."""
    import os

    import plade_tpu_torch
    from plade_tpu_torch.io.ply import read_ply, write_ply
    tp, tn, sp, sn, R, t = scene
    root = Path(plade_tpu_torch.__file__).resolve().parent.parent
    card = gpu_info()
    problems, paths = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tgt, src = str(tmp / "target.ply"), str(tmp / "source.ply")
        write_ply(tgt, tp, tn)
        write_ply(src, sp, sn)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        sub = {}
        for mode, extra in (("profiled", ["--profile", str(tmp / "trace")]),
                            ("plain", [])):
            out = tmp / f"sub_{mode}.txt"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "plade_tpu_torch.cli", tgt, src,
                 str(out)] + extra, cwd=root, env=env, capture_output=True,
                text=True, timeout=600)
            sub[mode] = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"[m] python -m plade_tpu_torch.cli ({mode}) exited "
                     f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                     f"{proc.stderr[-3000:]}")
            (_, _, T), = result_matrices(str(out), 1)
            dT = float(np.abs(T - files_T).max())
            rot, trans = check_pose(f"[m] subprocess ({mode})", T, R, t,
                                    problems)
            print(f"[m] subprocess `python -m plade_tpu_torch.cli` "
                  f"({mode}, no --device): exit 0 in {sub[mode]:.2f} s; "
                  f"rotation error {rot:.6f} deg, translation error "
                  f"{trans:.6f}; differs from (g)'s register_files by "
                  f"{dT:.3e} at most", flush=True)
            if dT >= 1e-4:
                problems.append(f"[m] subprocess ({mode}) transform differs "
                                f"from register_files' by {dT}")
        # what a process pays before it registers: the interpreter, the
        # imports and the CUDA context (timed inside and around it)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", STARTUP_PROBE], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        sub["startup"] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"[m] start-up probe exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        inside = [float(x) for x in proc.stdout.split()]
        events = json.loads((tmp / "trace" / "trace.json").read_text())[
            "traceEvents"]
        from plade_tpu_torch.io import native
        print(f"[m] native PLY reader (plade_tpu_torch/native, built by make "
              f"at first use): {'built' if native.available() else 'absent'}"
              "; without it the numpy reader reads", flush=True)
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        found = {k: sum(k in name for name in kernels)
                 for k in KERNEL_NAMES.values()}
        print(f"[m] --profile trace: {len(events)} events, {len(kernels)} "
              f"kernel events; K2 nn_kernel {found['nn_kernel']}, K1 "
              f"oriented_kernel {found['oriented_kernel']}, K3 "
              f"close_label_kernel {found['close_label_kernel']}, K4 "
              f"topk_kernel {found['topk_kernel']}", flush=True)
        if min(found.values()) < 1:
            problems.append(f"[m] trace lacks a kernel: {found}")

        # in this process: the counts count
        single = str(tmp / "single.txt")
        paths["cli_single"], w_single = run_cli("[m] single",
                                                [tgt, src, single], problems)
        (_, _, T), = result_matrices(single, 1)
        rot, trans = check_pose("[m] single", T, R, t, problems)
        print(f"[m] single: {w_single:.3f} s a pair, rotation error "
              f"{rot:.6f} deg, translation error {trans:.6f}; launches "
              f"{paths['cli_single']}; subprocess start-up cost "
              f"{sub['plain'] - w_single:.2f} s (plain subprocess wall "
              f"{sub['plain']:.2f} s minus this): a process that imports "
              f"and makes the CUDA context takes {sub['startup']:.2f} s "
              f"(inside it: import torch {inside[0]:.2f} s, the port "
              f"{inside[1]:.2f} s, the context {inside[2]:.2f} s), the "
              f"rest {sub['plain'] - w_single - sub['startup']:.2f} s is "
              f"the first registration's extra over a warm one; --profile "
              f"adds {sub['profiled'] - sub['plain']:.2f} s; {card}",
              flush=True)
        c = paths["cli_single"]
        if c["oriented_min_dist_sq"] < 2 or c["nearest_neighbor"] < 4 \
                or c["close_and_label_lanes"] < 1:
            problems.append(f"[m] single launches {c} below K1 >= 2, "
                            "K2 >= 4, K3 >= 1")
        icp = str(tmp / "icp.txt")
        paths["cli_icp"], w_icp = run_cli("[m] --icp",
                                          [tgt, src, icp, "--icp"], problems)
        (_, _, T), = result_matrices(icp, 1)
        rot, trans = check_pose("[m] --icp", T, R, t, problems)
        print(f"[m] --icp: {w_icp:.3f} s a pair, rotation error {rot:.6f} "
              f"deg, translation error {trans:.6f}; launches "
              f"{paths['cli_icp']}; {card}", flush=True)
        if paths["cli_icp"]["nearest_neighbor"] < 25:
            problems.append(f"[m] --icp K2 launches {paths['cli_icp']} < 25")

        # batch: the scan pairs of (l) as PLY files
        pairs, truth = scan_pairs(cfg)
        pairs_file = tmp / "pairs.txt"
        names = []
        for i, (a, an, b, bn) in enumerate(pairs):
            for side, (p, n) in (("t", (a, an)), ("s", (b, bn))):
                names.append(str(tmp / f"pair{i}_{side}.ply"))
                write_ply(names[-1], p, n)
        pairs_file.write_text("\n".join(names) + "\n")
        for path, extra in (("cli_batch", []),
                            ("cli_device_batch", ["--device-batch"])):
            out = str(tmp / f"{path}.txt")
            with extraction_counts() as counts:
                paths[path], wall = run_cli(f"[m] {path}",
                                            [str(pairs_file), out] + extra,
                                            problems)
            if extra:
                check_lockstep("[m] --device-batch", paths[path], counts,
                               len(pairs), cfg)
            errs = []
            for k, ((_, _, T), gt) in enumerate(
                    zip(result_matrices(out, len(pairs)), truth)):
                errs.append(check_pose(f"[m] {path} pair {k}:", T,
                                       gt[:3, :3], gt[:3, 3], problems))
            print(f"[m] batch{' --device-batch' if extra else ''}: "
                  f"{len(pairs)} pairs, {wall / len(pairs):.3f} s a pair; "
                  "pose errors (deg, translation) "
                  f"{[(round(r, 4), round(e, 5)) for r, e in errs]}; "
                  f"launches {paths[path]}; {card}", flush=True)
        profiled_batch(tmp, pairs_file, problems)

        # view: the single result as registered PLYs and as HTML
        prefix, html = str(tmp / "view"), str(tmp / "view.html")
        run_cli("[m] view PLY", ["view", single, prefix], problems)
        run_cli("[m] view HTML", ["view", single, html], problems)
        tv, _ = read_ply(prefix + "_target.ply")
        sv, _ = read_ply(prefix + "_source_registered.ply")
        gap = float(np.abs(sv - (sp @ R.T + t)).max())
        print(f"[m] view: {tv.shape[0]} + {sv.shape[0]} points as PLY (the "
              f"registered source within {gap:.2e} of the true pose's), "
              f"HTML {Path(html).stat().st_size} bytes", flush=True)
        if tv.shape != tp.shape or sv.shape != sp.shape or gap > 0.05:
            problems.append(f"[m] view PLY: shapes {tv.shape} {sv.shape}, "
                            f"gap {gap}")
    for path, counts in paths.items():
        if min(counts.values()) < 1:
            problems.append(f"[m] {path}: a kernel was not launched: "
                            f"{counts}")
    if problems:
        fail("; ".join(problems))
    return paths


def check_scene(cfg):
    """(n) scene mode on the card: 5 scans (``make_scan_sequence(rng(2000),
    n_scans=5, n_points=100000)`` at ``SCAN_SETTINGS`` with step 1.4),
    ``scene DIR OUT --loop-stride 2`` with ``--device-batch`` and
    sequentially (4 + 3 pairs each): every pair succeeds, every scan's pose
    within the limits of the ground truth rebased on scan 0, and
    ``posegraph.synchronize`` on the run's edges on the card and on the CPU
    within 1e-4.  Returns the launches by path."""
    from plade_tpu_torch.dist import posegraph
    from plade_tpu_torch.io.synthetic import make_scan_sequence, write_scene
    n = 5
    scans, poses = make_scan_sequence(
        np.random.default_rng(2000), n_scans=n,
        n_points=min(cfg.max_points, 100000),
        **dict(SCAN_SETTINGS, step=1.4))
    problems, paths = [], {}
    card = gpu_info()
    with tempfile.TemporaryDirectory() as tmp:
        d = write_scene(str(Path(tmp) / "scene"), scans, poses)
        for path, extra in (("cli_scene", ["--device-batch"]),
                            ("cli_scene_sequential", [])):
            out = str(Path(tmp) / f"{path}.txt")
            with recorded_calls(posegraph, "from_edges",
                                lambda a, out: a[0]) as graphs, \
                    extraction_counts() as counts:
                paths[path], wall = run_cli(
                    f"[n] {path}", ["scene", d, out, "--loop-stride", "2"]
                    + extra, problems)
            edges, = graphs
            if extra:
                check_lockstep("[n] scene --device-batch", paths[path],
                               counts, 7, cfg)
            lines = Path(out).read_text().splitlines()
            errs = []
            for k in range(n):
                T = np.asarray([lines[5 * k + 1 + r].split()
                                for r in range(4)], np.float64)
                gt = np.linalg.inv(poses[0]) @ poses[k]
                rot, trans = check_pose(f"[n] {path} scan {k}:", T,
                                        gt[:3, :3], gt[:3, 3], problems)
                errs.append((round(rot, 4), round(trans, 5)))
            if len(edges) != 7:
                problems.append(f"[n] {path}: {len(edges)} of 7 pairs "
                                "registered")
            on = {}
            for dev in ("cuda", "cpu"):
                g = posegraph.from_edges(edges, n, device=dev)
                Rk, tk = posegraph.synchronize(g, n)
                ang, terr = posegraph.residuals(g, Rk, tk)
                on[dev] = [x.cpu().numpy() for x in (Rk, tk, ang, terr)]
            dR = float(np.abs(on["cuda"][0] - on["cpu"][0]).max())
            dt = float(np.abs(on["cuda"][1] - on["cpu"][1]).max())
            print(f"[n] scene{' --device-batch' if extra else ''} "
                  f"--loop-stride 2: {len(edges)} edges, "
                  f"{wall / 7:.3f} s a pair ({wall:.2f} s); scan pose errors "
                  f"vs ground truth (deg, translation) {errs}; edge "
                  f"residuals (deg) {np.round(on['cuda'][2], 4).tolist()}, "
                  f"(translation) {np.round(on['cuda'][3], 5).tolist()}; "
                  f"synchronize card vs CPU: R {dR:.2e}, t {dt:.2e}; "
                  f"launches {paths[path]}; {card}", flush=True)
            if dR >= 1e-4 or dt >= 1e-4:
                problems.append(f"[n] {path}: synchronize on the card and "
                                f"the CPU differ by {dR} / {dt}")
    for path, counts in paths.items():
        if min(counts.values()) < 1:
            problems.append(f"[n] {path}: a kernel was not launched: "
                            f"{counts}")
    if problems:
        fail("; ".join(problems))
    return paths


def check_batch(scene, cfg, per_clock: float, old_k3, step_run):
    """(o) ``register_batch`` on ``bench.py``'s 8 pairs (pair 0 the room of
    (c), pairs 1-7 the scan pairs of rng 1000 + b), all padded to one size:
    at B = 1 (pair after pair, the single-pair step), 2, 4 and 8, one
    warm-up and three timed runs each, each fenced by a host read of the
    results; the peak memory of each B's timed runs.  The first timed B = 8
    run counts launches (K2, K1 and K4 shapes, K3 once a graph pass) and
    host syncs; every pair within the pose limits at B = 8, within 1e-4 of its
    B = 1 transform with the same success.  K3's grids and lanes come from
    the same batch with extraction's eager loop (:func:`eager_k3_calls`),
    which must give the counted run's bits.  Then one profiled B = 8 batch
    (stage table, kernels a batch), K3 on those grids as in (f), and one ``enable_icp`` batch (K2 at 8 x 16384 x 16384).  Returns
    (the counted run's launches, launches per (kernel, shape), the K3
    row, a dict for (p): the 8 pairs with their ground truth, padded size
    and padded clouds on the card, the B = 1, 4 and 8 transforms and
    successes, the wall per pair at each B)."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.dist import mesh
    from plade_tpu_torch.extract import ransac
    from plade_tpu_torch.kernels import cc, nn
    tp, tn, sp, sn, R, t = scene
    scans, truth = scan_pairs(cfg, BATCH - 1)
    pairs = [(tp, tn, sp, sn)] + scans
    truth = [(R, t)] + [(T[:3, :3], T[:3, 3]) for T in truth]
    pad = pipeline._pad_size(max(max(p[0].shape[0], p[2].shape[0])
                                 for p in pairs), maximum=cfg.max_points)
    tgt = mesh.stack_clouds([ptypes.pad_cloud(p[0], p[1], pad, "cuda")
                             for p in pairs])
    src = mesh.stack_clouds([ptypes.pad_cloud(p[2], p[3], pad, "cuda")
                             for p in pairs])
    seeds = list(range(BATCH))
    card = gpu_info()

    def run(B, cfg_run=cfg):
        """All 8 pairs, B at a time (B = 1: the single-pair step); the
        transforms and successes read on the host."""
        step = pipeline.register_pair_device(cfg_run, pad)
        if B == 1:
            outs = [ptypes.RegistrationResult(*(x[None] for x in step(
                ptypes.Cloud(*(x[i] for x in tgt)),
                ptypes.Cloud(*(x[i] for x in src)), seeds[i])))
                for i in range(BATCH)]
        else:
            outs = [mesh.register_batch(
                ptypes.Cloud(*(x[s:s + B] for x in tgt)),
                ptypes.Cloud(*(x[s:s + B] for x in src)), seeds[s:s + B],
                cfg_run, device="cuda") for s in range(0, BATCH, B)]
        res = ptypes.RegistrationResult(*(torch.cat(f) for f in zip(*outs)))
        return res.transform.cpu().numpy(), res.success.tolist(), res

    walls, peaks, syncs, results, bases = {}, {}, {}, {}, {}
    for B in (1, 2, 4, BATCH):
        run(B)                                             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what the phase holds before the runs: the peak less this is
        # the runs' own
        bases[B] = torch.cuda.memory_allocated()
        walls[B] = []
        for k in range(3):
            ptypes.HOST_SYNCS["count"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(B)
            walls[B].append(time.perf_counter() - t0)
            if k == 0:
                syncs[B] = ptypes.HOST_SYNCS["count"]
                results[B] = out
        peaks[B] = torch.cuda.max_memory_allocated()
        print(f"[o] B = {B}: wall per pair (median of 3) "
              f"{statistics.median(walls[B]) * 1e3 / BATCH:.1f} ms, runs "
              f"{[round(w * 1e3, 1) for w in walls[B]]} ms for {BATCH} pairs"
              f"; host syncs {syncs[B]} ({syncs[B] * B / BATCH:g} a batch); "
              f"peak memory {peaks[B] / 2**20:.1f} MiB ("
              f"{(peaks[B] - bases[B]) / 2**20:.1f} above the "
              f"{bases[B] / 2**20:.1f} MiB held before); {card}", flush=True)

    # one more B = 8 run, untimed, with every count at 0 and the kernels'
    # shapes recorded; then K3's grids from the same batch with
    # extraction's eager loop, which must give that run's bits
    reset_counts()
    with kernel_calls("nearest_neighbor",
                      lambda a, out: tuple(a[0].shape[:-1])
                      + (a[1].shape[-2],)) as k2_shapes, \
            kernel_calls("oriented_min_dist_sq",
                         lambda a, out: tuple(a[0].shape[:-1])
                         + (a[2].shape[-2],)) as k1_shapes, \
            kernel_calls("topk_dist_sq", k4_shape) as k4_shapes, \
            recorded_extractions(ransac) as seen, \
            extraction_counts() as counts:
        T_main = run(BATCH)[0]
        torch.cuda.synchronize()
    launches = dict(nn.LAUNCHES)
    with eager_k3_calls(lambda a, out: (a[0].clone(), a[1])) as grids, \
            recorded_extractions(ransac) as eager:
        T_eager = run(BATCH)[0]
    problems = []
    if not same_bits(eager, seen) or not same_bits(T_eager, T_main):
        problems.append("[o] the eager loop's extraction or transforms "
                        "differ from the main path's")
    T8, ok8, res8 = results[BATCH]
    T1, ok1, _ = results[1]
    for i, ((Rg, tg), name) in enumerate(zip(truth, ["room"] + [
            f"scan pair {b}" for b in range(1, BATCH)])):
        dT = float(np.abs(T8[i] - T1[i]).max())
        rot, trans = check_pose(f"[o] pair {i} ({name}), B = {BATCH}:", T8[i],
                                Rg, tg, problems)
        print(f"[o] pair {i}: success {ok8[i]} (B = 1: {ok1[i]}), score "
              f"{float(res8.score[i]):.6f}, matched planes "
              f"{int(res8.matched_planes[i])}, counters "
              f"{int(res8.match_saturated[i])}/{int(res8.pen_overflow[i])}/"
              f"{int(res8.cluster_truncated[i])}; transform within {dT:.3e} "
              f"of its B = 1 result", flush=True)
        if dT >= 1e-4 or ok8[i] != ok1[i] or not ok8[i]:
            problems.append(f"[o] pair {i}: success {ok8[i]} / {ok1[i]}, "
                            f"transform differs from B = 1 by {dT}")
    (_, stats), = seen
    rounds = stats.rounds.tolist()
    lanes = sorted({int(o.shape[0]) for o, _ in grids})
    L = 2 * BATCH * cfg.ransac_exact_lanes
    by_shape = {}
    for name, shapes in (("nearest_neighbor", k2_shapes),
                         ("oriented_min_dist_sq", k1_shapes),
                         ("topk_dist_sq", k4_shapes)):
        shape_counts(name, shapes, by_shape)
    print(f"[o] B = {BATCH}, one batch: launches {launches}; K2 shapes "
          f"(P, Q, T) {k2_shapes}; K1 shapes {k1_shapes}; K4 shapes "
          f"{k4_shapes}; extraction "
          f"counters {counts}; the eager loop: {len(grids)} K3 calls over "
          f"lanes {lanes}, lockstep rounds of the {2 * BATCH} clouds "
          f"{rounds}; host syncs {syncs[BATCH]} (the step at B = 1 in (i): "
          f"{step_run['syncs']} a pair)", flush=True)
    if k2_shapes != [K2_BATCH_SHAPES[0]] * (cfg.rescore_icp_iters + 1):
        problems.append(f"[o] K2 launches {k2_shapes}")
    if not k1_shapes or {s[0] for s in k1_shapes} != {BATCH} \
            or K1_BATCH_SHAPES[1] not in k1_shapes:
        problems.append(f"[o] K1 launches {k1_shapes}")
    if k4_shapes != [(BATCH, cfg.spacing_samples, pad)] \
            or launches["topk_dist_sq"] != 1:
        problems.append(f"[o] K4 launches {k4_shapes} "
                        f"({launches['topk_dist_sq']} counted)")
    check_graph_passes("[o]", launches["close_and_label_lanes"], counts,
                       2 * BATCH, problems)
    if lanes != [L] or len(grids) != max(rounds):
        problems.append(f"[o] eager K3 {len(grids)} calls over lanes "
                        f"{lanes}, not one a lockstep round ({max(rounds)}) "
                        f"at L = {L}")
    if min(launches.values()) < 1:
        problems.append(f"[o] a kernel was not launched: {launches}")
    if problems:
        fail("; ".join(problems))
    walls_pp = {B: statistics.median(w) * 1e3 / BATCH
                for B, w in walls.items()}
    print(f"[o] wall per pair, ms: "
          f"{ {B: round(w, 1) for B, w in walls_pp.items()} }; B = 1 / B = "
          f"{BATCH}: {walls_pp[1] / walls_pp[BATCH]:.2f}x; the step alone in "
          f"(i) (room pair): {step_run['wall'] * 1e3:.1f} ms; peak memory, "
          f"MiB: { {B: round(m / 2**20, 1) for B, m in peaks.items()} }; "
          f"{card}", flush=True)
    table = profile_stages(lambda: run(BATCH), tag="[o]",
                           kernels_of="plade.spacing")
    print(f"[o] kernels a batch of {BATCH}: {table['(total)'][2]} (a pair "
          f"in (i): {step_run['kernels']}); host syncs a batch "
          f"{syncs[BATCH]}", flush=True)
    spacing = table["(kernels of plade.spacing)"]
    k4 = sum(n for name, n in spacing.items() if "topk_kernel" in name)
    if k4 != 1 or any(re.search("gemm|mbtopk|sort", name, re.I)
                      for name in spacing):
        fail(f"[o] the spacing's kernels are not K4's: {spacing}")
    k3_row = k3_main_path(cc, grids, per_clock, old_k3, tag="[o]")
    k3_row["path"] = "register_batch"
    k3_row["launches"] = launches["close_and_label_lanes"]

    # the final ICP of a batch: K2 icp_iters + 1 times over all pairs
    cfg_icp = dataclasses.replace(cfg, enable_icp=True)
    reset_counts()
    with kernel_calls("nearest_neighbor",
                      lambda a, out: tuple(a[0].shape[:-1])
                      + (a[1].shape[-2],)) as icp_shapes:
        T_icp, ok_icp, _ = run(BATCH, cfg_icp)
    icp_launches = dict(nn.LAUNCHES)
    at_shape = sum(s == K2_BATCH_SHAPES[1] for s in icp_shapes)
    by_shape[("nearest_neighbor", "x".join(map(str, K2_BATCH_SHAPES[1])))] \
        = at_shape
    print(f"[o] enable_icp batch of {BATCH}: launches {icp_launches}, K2 at "
          f"{K2_BATCH_SHAPES[1]}: {at_shape} (icp_iters {cfg.icp_iters} + 1)"
          f", shapes {sorted(set(icp_shapes))}", flush=True)
    for i, (Rg, tg) in enumerate(truth):
        check_pose(f"[o] enable_icp pair {i}:", T_icp[i], Rg, tg, problems)
    if at_shape != cfg.icp_iters + 1 or not all(ok_icp):
        problems.append(f"[o] enable_icp batch: K2 {icp_shapes}, success "
                        f"{ok_icp}")
    if problems:
        fail("; ".join(problems))
    batch_run = dict(pairs=pairs, truth=truth, pad=pad, clouds=(tgt, src),
                     T1=T1, ok1=ok1, T4=results[4][0], ok4=results[4][1],
                     T8=T8, ok8=ok8, walls_pp=walls_pp, syncs=syncs,
                     peaks=peaks, bases=bases, launches8=launches, T_icp=T_icp,
                     ok_icp=ok_icp, icp_launches=icp_launches)
    return launches, by_shape, k3_row, batch_run


#: (p)'s 2-process world: each rank's pairs of (o)'s 8, and a worker's
#: time limit in seconds (``import torch``, a CUDA context and 5 pairs)
WORLD_PAIRS = ((0, 5), (5, 8))
WORKER_TIMEOUT = 300


def shard_launches(tag, k2, k1, pairs: int, cfg, problems):
    """The launches of each shard of a mesh run, told apart by the CUDA
    stream they ran on (``k2``, ``k1``: (pairs, stream) a launch): each
    shard one lockstep batch of ``pairs`` pairs (K2 ``rescore_icp_iters``
    + 1 launches, K1 at least one).  Returns the launches by stream."""
    streams = {s for _, s in k2 + k1}
    by = {s: {name: [n for n, s2 in calls if s2 == s] for name, calls in
              (("K2", k2), ("K1", k1))} for s in streams}
    counts = {hex(s): {k: len(v) for k, v in c.items()}
              for s, c in by.items()}
    print(f"{tag} launches by shard stream: {counts}", flush=True)
    for s, c in by.items():
        if len(c["K2"]) != cfg.rescore_icp_iters + 1 or not c["K1"] \
                or set(c["K2"] + c["K1"]) != {pairs}:
            problems.append(f"{tag} shard stream {hex(s)}: not one lockstep "
                            f"batch of {pairs} pairs: {c}")
    return by


def mesh_worker(rank: int, world: int, addr: str, work: Path):
    """A rank of (p)'s 2-process world: joins the group on ``addr``, takes
    its pairs (``WORLD_PAIRS``) of ``work/pairs.npz``, registers them on its
    mesh (``global_mesh``: every visible card), gathers every rank's
    results and writes them, with its launches, to ``work/rank<R>.npz``."""
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.core.types import pad_cloud
    from plade_tpu_torch.dist import mesh as mesh_mod
    from plade_tpu_torch.dist import multihost
    from plade_tpu_torch.kernels import nn
    import torch.distributed as dist
    data = np.load(work / "pairs.npz")
    pad = int(data["pad"])
    lo, hi = WORLD_PAIRS[rank]
    if not multihost.initialize(addr, world, rank, timeout=WORKER_TIMEOUT):
        fail(f"[p] rank {rank}: no process group formed")
    try:
        mesh = multihost.global_mesh()
        tgt, src = (mesh_mod.stack_clouds([pad_cloud(
            data[f"{side}p{i}"], data[f"{side}n{i}"], pad, "cpu")
            for i in range(lo, hi)]) for side in "ts")
        batch, offsets = multihost.local_batch_to_global(
            mesh, tgt, src, range(lo, hi))
        reset_counts()
        t0 = time.perf_counter()
        res = mesh_mod.register_batch(*batch, PladeConfig(), mesh)
        wall = time.perf_counter() - t0
        launches = dict(nn.LAUNCHES)
        np.savez(work / f"rank{rank}.npz", transform=res.transform.numpy(),
                 success=res.success.numpy(), offsets=np.array(offsets),
                 launches=np.array([launches[k] for k in sorted(launches)]))
    finally:
        dist.destroy_process_group()
    print(f"WORKER_OK rank={rank}: devices {mesh.devices}, rank "
          f"{mesh.rank} of {mesh.world_size}, offsets {offsets}, "
          f"{hi - lo} pairs of its own and {res.transform.shape[0]} "
          f"gathered in {wall:.2f} s (the first call of the process); "
          f"launches {launches}", flush=True)


def run_world(work: Path):
    """(p)'s 2-process world: this script twice as ``--mesh-worker`` on
    localhost, each under ``WORKER_TIMEOUT``; a worker that fails or times
    out fails the run.  Returns each rank's (transforms, successes,
    launches by kernel)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), str(len(WORLD_PAIRS)), addr, str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(len(WORLD_PAIRS))]
    logs = []
    deadline = time.perf_counter() + WORKER_TIMEOUT
    try:
        for proc in procs:
            try:
                logs.append(proc.communicate(timeout=max(
                    1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                logs.append(f"timed out after {WORKER_TIMEOUT} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out = []
    for r, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0 or f"WORKER_OK rank={r}" not in log:
            fail(f"[p] rank {r} exited {proc.returncode}:\n{log[-4000:]}")
        print(f"[p] {log.strip().splitlines()[-1]}", flush=True)
        got = np.load(work / f"rank{r}.npz")
        names = sorted(("nearest_neighbor", "oriented_min_dist_sq",
                        "close_and_label_lanes"))
        out.append((got["transform"], got["success"].tolist(),
                    dict(zip(names, got["launches"].tolist()))))
    return out


def host_tensors(x) -> list:
    """Host copies of the tensors of ``x`` (a tensor, or tuples, lists,
    NamedTuples and dicts of them), in order."""
    if torch.is_tensor(x):
        return [x.detach().cpu()]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in host_tensors(v)]
    return []


def repro_stages():
    """The functions whose outputs (p) compares between runs of one batch,
    as (module, name), in the step's order: the plane selection of the
    extraction (K3 runs inside extraction's CUDA graph), spacing, the voxel grids and the prepared clouds, the
    matching, clustering and consistency, the penetration tests, the
    overlap, the rescore's ICP and counts, and the registration."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.extract import ransac
    from plade_tpu_torch.match import matching
    from plade_tpu_torch.verify import overlap, penetration
    return ((ransac, "select_planes_device"), (pipeline, "average_spacing"),
            (pipeline, "voxel_downsample"),
            (pipeline, "voxel_downsample_by_plane"),
            (pipeline, "prepare_cloud"), (matching, "match_descriptors"),
            (matching, "hypothesis_poses"), (matching, "cluster_poses"),
            (matching, "plane_consistency"), (penetration, "run_tests"),
            (overlap, "overlap_scores"), (pipeline, "refine_icp"),
            (overlap, "exact_overlap_counts"), (pipeline, "register_pair"))


@contextlib.contextmanager
def stage_outputs():
    """Records (name, host copies of the outputs) of every call of
    :func:`repro_stages`' functions inside the block, in call order."""
    seen = []
    with contextlib.ExitStack() as stack:
        for module, name in repro_stages():
            stack.enter_context(recorded_calls(
                module, name, lambda a, out, name=name: seen.append(
                    (name, host_tensors(out)))))
        yield seen


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def first_difference(a, b):
    """The first call at which two recordings of :func:`stage_outputs`
    differ in a bit, as (call, name, largest finite difference), or
    None."""
    for k, ((na, xa), (nb, xb)) in enumerate(zip(a, b)):
        same = na == nb and len(xa) == len(xb) and all(
            x.shape == y.shape and x.dtype == y.dtype
            and torch.equal(_bits(x), _bits(y)) for x, y in zip(xa, xb))
        if not same:
            gaps = [(x.double() - y.double()).abs() for x, y in zip(xa, xb)
                    if x.shape == y.shape]
            gaps = [float(g[torch.isfinite(g)].max()) for g in gaps
                    if torch.isfinite(g).any()]
            return k, na, max(gaps, default=float("nan"))
    if len(a) != len(b):
        return min(len(a), len(b)), "(number of calls)", float("nan")
    return None


def check_reproducible(cfg, batch_run, problems):
    """(p) one B = 8 batch of (o)'s pairs through the step, twice, every
    stage's outputs recorded (:func:`stage_outputs`): each the same bits.
    Then twice with the float scatter-sums of the voxel grids and the
    cluster centroids as ``index_add_`` (on the card, atomics: the port
    before ``ops.index_sum``): where those two runs first differ, and how
    far their transforms are from the first runs'."""
    from unittest import mock

    from plade_tpu_torch import pipeline
    from plade_tpu_torch.geometry import voxel
    from plade_tpu_torch.match import matching
    tgt, src = batch_run["clouds"]
    step = pipeline.register_pair_device(cfg, batch_run["pad"])

    def twice():
        runs = []
        for _ in range(2):
            with stage_outputs() as seen:
                seen.append(("result", host_tensors(
                    step(tgt, src, list(range(BATCH))))))
            runs.append(seen)
        return runs
    runs = twice()
    where = first_difference(*runs)
    print(f"[p] one B = {BATCH} batch twice, {len(runs[0])} stage calls "
          f"recorded: "
          + ("every output the same bits" if where is None else
             f"first differs at call {where[0]} ({where[1]}) by {where[2]}"),
          flush=True)
    if where is not None:
        problems.append(f"[p] the same batch gave other bits at call "
                        f"{where[0]} ({where[1]})")

    def atomic(out, index, values):
        return out.index_add_(0, index, values)
    with mock.patch.object(voxel, "index_sum", atomic), \
            mock.patch.object(matching, "index_sum", atomic):
        old = twice()
    where = first_difference(*old)
    T = runs[0][-1][1][0]
    moved = [float((r[-1][1][0] - T).abs().max()) for r in old]
    print(f"[p] the same with index_add_ sums (atomics): "
          + ("the two runs the same bits" if where is None else
             f"first differ at call {where[0]} ({where[1]}) by {where[2]}")
          + f"; their transforms within {max(moved):.3e} of the "
          f"index_sum runs'", flush=True)


def check_mesh(cfg, batch_run):
    """(p) pairs over a pairs axis of devices and processes, on (o)'s 8
    pairs.  First :func:`check_reproducible`.  ``register_array_pairs`` on
    a mesh of two shards on cuda:0 (4 pairs a shard in lockstep; one
    warm-up, three timed runs, then one run with the counts at 0 and each
    launch's shard recorded): the bits of (o)'s two B = 4 batches, every
    pair within 1e-4 of its B = 1 transform in (o), same success, within
    the pose limits, and each shard one lockstep batch; the wall per pair
    and peak memory beside (o)'s B = 8 and B = 4.  ``register_batch`` on
    ``make_mesh()`` (every visible card): the bits of (o)'s
    ``device="cuda"`` B = 8 result.  A 2-process world (``run_world``)
    whose ranks hold 5 and 3 pairs: each rank's 8 gathered results within
    1e-4 of (o)'s B = 1.  ``utils.timing.stage`` around 8 matrix products
    that no host read waits for: with ``sync=`` its time covers their CUDA
    events' time, without it does not.  Returns the launches by path."""
    from plade_tpu_torch.dist import mesh as mesh_mod
    from plade_tpu_torch.extract import ransac
    from plade_tpu_torch.kernels import nn
    from plade_tpu_torch.utils import timing
    pairs, truth, T1, ok1 = (batch_run[k] for k in
                             ("pairs", "truth", "T1", "ok1"))
    card = gpu_info()
    problems, paths = [], {}

    def against_b1(tag, T, ok):
        worst = 0.0
        for i, (Rg, tg) in enumerate(truth):
            dT = float(np.abs(T[i] - T1[i]).max())
            worst = max(worst, dT)
            check_pose(f"{tag} pair {i}:", T[i], Rg, tg, problems)
            if dT >= 1e-4 or ok[i] != ok1[i] or not ok[i]:
                problems.append(f"{tag} pair {i}: success {ok[i]} / "
                                f"{ok1[i]}, transform differs from (o)'s B = "
                                f"1 by {dT}")
        print(f"{tag} every pair within {worst:.3e} of its B = 1 transform "
              f"in (o)", flush=True)

    check_reproducible(cfg, batch_run, problems)

    # two shards on one card, 4 pairs each in lockstep
    two = mesh_mod.make_mesh(devices=["cuda:0", "cuda:0"])

    def run2():
        outs = mesh_mod.register_array_pairs(pairs, cfg, seed=0, mesh=two)
        return (np.stack([o.transform for o in outs]),
                [o.success for o in outs])
    run2()                                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        T2, ok2 = run2()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()

    def stream_of(n):
        return lambda a, out: (n(a), torch.cuda.current_stream().cuda_stream)
    reset_counts()
    with kernel_calls("nearest_neighbor",
                      stream_of(lambda a: a[0].shape[0])) as k2, \
            kernel_calls("oriented_min_dist_sq",
                         stream_of(lambda a: a[0].shape[0])) as k1, \
            extraction_counts() as counts:
        run2()
        torch.cuda.synchronize()
    paths["mesh_two_shards"] = dict(nn.LAUNCHES)
    # K3 inside each shard's extraction graph: once a pass over a shard's
    # 2 x 4 clouds; each shard's stream keeps its own graph
    check_graph_passes("[p] two shards:",
                       paths["mesh_two_shards"]["close_and_label_lanes"],
                       counts, BATCH, problems)
    graph_streams = {s.cuda_stream for s in ransac._GRAPHS}
    print(f"[p] two shards: extraction counters {counts}; streams holding "
          f"a pass graph {sorted(hex(s) for s in graph_streams)}",
          flush=True)
    against_b1("[p] two shards:", T2, ok2)
    # each shard runs one of (o)'s B = 4 batches
    same4 = np.array_equal(T2, batch_run["T4"]) and ok2 == batch_run["ok4"]
    print(f"[p] two shards: the bits of (o)'s B = 4 batches: {same4} (within "
          f"{float(np.abs(T2 - batch_run['T4']).max()):.3e})", flush=True)
    if not same4:
        problems.append("[p] two shards differ from (o)'s B = 4 batches")
    by = shard_launches("[p] two shards:", k2, k1, BATCH // 2, cfg,
                        problems)
    if len(by) != 2 or not set(by) <= graph_streams:
        problems.append(f"[p] two shards ran on {len(by)} streams, not each "
                        "with its pass graph")
    pp = statistics.median(walls) * 1e3 / BATCH
    print(f"[p] two shards on cuda:0: wall per pair (median of 3) {pp:.1f} "
          f"ms, runs {[round(w * 1e3, 1) for w in walls]} ms for {BATCH} "
          f"pairs; one card one shard in (o): B = {BATCH} "
          f"{batch_run['walls_pp'][BATCH]:.1f} ms, B = 4 "
          f"{batch_run['walls_pp'][4]:.1f} ms; peak memory "
          f"{peak / 2**20:.1f} MiB; launches {paths['mesh_two_shards']}; "
          f"{card}", flush=True)
    # where the two shards' time goes: the device's busy share (kernels of
    # both streams summed; over 100% where they overlap)
    profile_stages(run2, tag="[p] two shards:")

    # the default mesh: every visible card, against device="cuda"
    default = mesh_mod.make_mesh()
    want = tuple(torch.device(f"cuda:{k}")
                 for k in range(torch.cuda.device_count()))
    tgt, src = batch_run["clouds"]
    reset_counts()
    res = mesh_mod.register_batch(tgt, src, range(BATCH), cfg, default)
    paths["mesh_default"] = dict(nn.LAUNCHES)
    dT = float(np.abs(res.transform.numpy() - batch_run["T8"]).max())
    print(f"[p] make_mesh(): {default.devices}; its B = {BATCH} result "
          f"within {dT:.3e} of device=\"cuda\"'s in (o), successes "
          f"{res.success.tolist()}; launches {paths['mesh_default']}",
          flush=True)
    if default.devices != want or dT != 0.0 \
            or res.success.tolist() != batch_run["ok8"]:
        problems.append(f"[p] make_mesh(): devices {default.devices}, "
                        f"transform differs from (o)'s by {dT}")
    del res

    # the 2-process world: its workers read the pairs from a file
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        np.savez(work / "pairs.npz", pad=batch_run["pad"], **{
            f"{side}{kind}{i}": p[2 * (side == "s") + (kind == "n")]
            for i, p in enumerate(pairs) for side in "ts" for kind in "pn"})
        t0 = time.perf_counter()
        ranks = run_world(work)
        world_wall = time.perf_counter() - t0
    total = {}
    for r, (T, ok, launches) in enumerate(ranks):
        against_b1(f"[p] rank {r} of 2:", T, ok)
        if min(launches.values()) < 1:
            problems.append(f"[p] rank {r}: a kernel was not launched: "
                            f"{launches}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    if not np.array_equal(ranks[0][0], ranks[1][0]):
        problems.append("[p] the ranks gathered different results")
    paths["multihost"] = total
    print(f"[p] 2-process world on the card: {world_wall:.1f} s from start "
          f"to end, start-up of both processes included; launches of both "
          f"ranks {total}; {card}", flush=True)

    # utils.timing.stage around device work that no host read waits for:
    # only with sync= does the stage's time cover the CUDA events'
    a = torch.randn(8192, 8192, device="cuda") / 8192 ** 0.5
    torch.cuda.synchronize()
    staged = {}
    for sync in (False, True):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        timing.stage_report(reset=True)
        with timing.stage("smoke/matmuls") as out:
            start.record()
            x = a
            for _ in range(8):
                x = x @ a
            end.record()
            if sync:
                out["sync"] = x
        staged[sync] = timing.stage_report(reset=True)["smoke/matmuls"][
            "last"] * 1e3
        torch.cuda.synchronize()
        staged[sync] = (staged[sync], start.elapsed_time(end))
    del a, x
    print(f"[p] utils.timing.stage around 8 products of 8192 x 8192: "
          f"{staged[True][0]:.2f} ms with sync= against the events' "
          f"{staged[True][1]:.2f} ms; without it {staged[False][0]:.3f} ms "
          f"against {staged[False][1]:.2f} ms", flush=True)
    if not (staged[True][0] >= staged[True][1]
            and staged[False][0] < 0.5 * staged[False][1]):
        problems.append(f"[p] stage times {staged} (ms, events ms): the "
                        "synced stage must cover its events, the other not")
    for path in ("mesh_two_shards", "mesh_default"):
        if min(paths[path].values()) < 1:
            problems.append(f"[p] {path}: a kernel was not launched: "
                            f"{paths[path]}")
    if problems:
        fail("; ".join(problems))
    return paths


#: (q)'s groups on the one card: the split kernels over 2 and 3 parts
INTRA_PARTS = (2, 3)


def split_kernels(nn, cfg, batch_run):
    """(q) ``dist.intra.split_queries`` with the real kernels at the main
    path's shapes over ``["cuda:0"] * k`` (k in ``INTRA_PARTS``): K1 at
    131072 x 16384 and 8 x 131072 x 16384, K2 at 131072 x 16384 and 16384
    x 16384, and ``topk_dist_sq`` / ``average_spacing`` at (o)'s B = 8
    spacing shape (its 8 source clouds and sampled queries), each bit for
    bit one launch (the unsplit call), one launch a part, timed beside
    it.  Returns the problems found."""
    from plade_tpu_torch.dist.intra import on_group, query_cuts, split_queries
    from plade_tpu_torch.knn import bruteforce
    problems = []
    src = batch_run["clouds"][1]
    seen = []

    def recorded(queries, refs, *a):
        seen.append((queries, refs))
        return bruteforce.topk_dist_sq(queries, refs, *a)
    # the sampled queries and the clouds of (o)'s B = 8 spacing
    bruteforce.average_spacing(
        src.points, src.mask, cfg.spacing_k, cfg.spacing_samples,
        bruteforce.ONE_DEVICE._replace(topk_dist_sq=recorded))
    (sq, spts), = seen
    block = bruteforce.topk_block(sq, spts)
    cases = [
        ("K1", nn.oriented_min_dist_sq, kernel_inputs(*K1_SHAPES[0])),
        ("K1", nn.oriented_min_dist_sq, batch_inputs(*K1_BATCH_SHAPES[0])),
        ("K2", nn.nearest_neighbor, kernel_inputs(*K2_SHAPES[0])),
        ("K2", nn.nearest_neighbor, kernel_inputs(*K2_SHAPES[1])),
    ]
    for k in INTRA_PARTS:
        group = ["cuda:0"] * k
        for name, kernel, (q, qn, r, rn) in cases:
            if name == "K1":
                def fn(*a):
                    return nn.oriented_min_dist_sq(*a, NORMAL_COS)
                per, shared = [q, qn], [r, rn]
            else:
                fn, per, shared = kernel, [q], [r]
            want = fn(*per, *shared)
            cuts = query_cuts(q.shape[-2], k)
            parts = sum(hi > lo for lo, hi in zip(cuts, cuts[1:]))
            reset_counts()
            got = split_queries(fn, group, per, shared)
            torch.cuda.synchronize()
            launches = sum(nn.LAUNCHES.values())
            same = all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,)))
            ms = cuda_ms(lambda: split_queries(fn, group, per, shared))
            one_ms = cuda_ms(lambda: fn(*per, *shared))
            shape = tuple(q.shape[:-1]) + (r.shape[-2],)
            print(f"[q] {name} {shape} over {k} parts on cuda:0: the bits of "
                  f"one launch {same}; {launches} launches ({parts} parts); "
                  f"{ms:.4f} ms split against {one_ms:.4f} ms one launch",
                  flush=True)
            if not same or launches != parts:
                problems.append(f"[q] {name} {shape} over {k} parts: same "
                                f"bits {same}, {launches} launches")
        passes = on_group(group)
        # the peak memory of one unsplit and one split top-k, each from
        # what is allocated before it
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want = bruteforce.topk_dist_sq(sq, spts, cfg.spacing_k)
        torch.cuda.synchronize()
        one_peak = torch.cuda.max_memory_allocated() - base
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        got = passes.topk_dist_sq(sq, spts, cfg.spacing_k)
        torch.cuda.synchronize()
        split_peak = torch.cuda.max_memory_allocated() - base
        launches = nn.LAUNCHES["topk_dist_sq"]
        cuts = query_cuts(sq.shape[-2], k, block)
        parts = sum(hi > lo for lo, hi in zip(cuts, cuts[1:]))
        sp_want = bruteforce.average_spacing(
            src.points, src.mask, cfg.spacing_k, cfg.spacing_samples)
        sp_got = bruteforce.average_spacing(
            src.points, src.mask, cfg.spacing_k, cfg.spacing_samples,
            passes)
        same = torch.equal(got, want) and torch.equal(sp_got, sp_want)
        ms = cuda_ms(lambda: passes.topk_dist_sq(sq, spts, cfg.spacing_k),
                     reps=2, warm=1)
        one_ms = cuda_ms(lambda: bruteforce.topk_dist_sq(
            sq, spts, cfg.spacing_k), reps=2, warm=1)
        print(f"[q] spacing top-{cfg.spacing_k} {tuple(sq.shape[:-1])} x "
              f"{spts.shape[-2]} (cut at blocks of {block} queries) over {k} "
              f"parts: the bits of the unsplit call {same} (top-k and "
              f"spacing); {launches} K4 launches ({parts} parts); "
              f"{ms:.2f} ms split against {one_ms:.2f} ms; peak memory "
              f"above its inputs {split_peak / 2**20:.1f} MiB split against "
              f"{one_peak / 2**20:.1f} MiB", flush=True)
        if not same or launches != parts:
            problems.append(f"[q] the spacing over {k} parts: same bits "
                            f"{same}, {launches} K4 launches")
    return problems


def check_intra(cfg, batch_run):
    """(q) the ``intra`` axis (``dist/intra.py``, ``make_mesh(intra=)``).
    First :func:`split_kernels`.  Then ``register_batch`` on (o)'s 8 pairs
    over ``make_mesh(devices=["cuda:0"] * 2, intra=2)`` (one group: the
    bits of (o)'s B = 8 batch) and ``["cuda:0"] * 4, intra=2`` (two groups
    of 4 pairs: the bits of (o)'s B = 4 batches): one warm-up, three timed
    runs (the wall per pair, the host syncs of the first, the peak memory),
    then one run with every count at 0 and each K1/K2 launch's thread
    and stream recorded: in each group K1 and K2 as many launches on
    home's stream as on the others' (every pass split in two), K3 once a
    pass of extraction's graph, which home's stream holds and no other
    part's, the same host syncs as (o), and the device memory each stream
    holds (``torch.cuda.memory_snapshot``).
    Last the one group with ``enable_icp`` (the final ICP's K2 split too):
    the bits of (o)'s ``enable_icp`` batch.  Returns the launches by
    path."""
    import threading

    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.dist import intra as intra_mod
    from plade_tpu_torch.dist import mesh as mesh_mod
    from plade_tpu_torch.extract import ransac
    from plade_tpu_torch.kernels import nn
    problems = split_kernels(nn, cfg, batch_run)
    card = gpu_info()
    tgt, src = batch_run["clouds"]
    paths = {}

    def run(m, cfg_run=cfg):
        res = mesh_mod.register_batch(tgt, src, range(BATCH), cfg_run, m)
        return res.transform.numpy(), res.success.tolist()

    def where(a, out):
        return (threading.get_ident(), torch.cuda.current_stream().cuda_stream)

    for path, devices, want, want_syncs in (
            ("mesh_intra", ["cuda:0"] * 2, "8", batch_run["syncs"][BATCH]),
            ("mesh_intra_two_groups", ["cuda:0"] * 4, "4",
             batch_run["syncs"][4])):
        m = mesh_mod.make_mesh(devices=devices, intra=2)
        groups = len(m.groups)
        run(m)                                             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        walls = []
        for i in range(3):
            ptypes.HOST_SYNCS["count"] = 0
            t0 = time.perf_counter()
            T, ok = run(m)
            walls.append(time.perf_counter() - t0)
            if i == 0:
                syncs = ptypes.HOST_SYNCS["count"]
        peak = torch.cuda.max_memory_allocated()
        held = {}
        for seg in torch.cuda.memory_snapshot():
            held[seg["stream"]] = held.get(seg["stream"], 0) \
                + seg["total_size"]
        reset_counts()
        with kernel_calls("nearest_neighbor", where) as k2, \
                kernel_calls("oriented_min_dist_sq", where) as k1, \
                extraction_counts() as counts:
            run(m)
            torch.cuda.synchronize()
        paths[path] = dict(nn.LAUNCHES)
        # a group's home stream is its shard's; K3 runs inside extraction's
        # pass graph, which only home streams hold
        shard_streams = {x.cuda_stream for x in mesh_mod._STREAMS.values()}
        helper_streams = {x.cuda_stream
                          for x in intra_mod._STREAMS.values()}
        graph_streams = {x.cuda_stream for x in ransac._GRAPHS}
        homes = {th: s for th, s in k2 if s in shard_streams}
        check_graph_passes(f"[q] {path}:",
                           paths[path]["close_and_label_lanes"], counts,
                           2 * BATCH // groups, problems)
        if graph_streams & helper_streams \
                or not set(homes.values()) <= graph_streams:
            problems.append(f"[q] {path}: pass graphs on streams "
                            f"{sorted(map(hex, graph_streams))}, homes "
                            f"{sorted(map(hex, homes.values()))}")
        by = {}
        for th, home in homes.items():
            by[th] = {name: {"home": sum(c == (th, home) for c in calls),
                             "others": sum(c[0] == th and c[1] != home
                                           for c in calls)}
                      for name, calls in (("K2", k2), ("K1", k1))}
        same = np.array_equal(T, batch_run["T" + want]) \
            and ok == batch_run["ok" + want]
        pp = statistics.median(walls) * 1e3 / BATCH
        o_peak, o_base = (batch_run[k][int(want)] for k in ("peaks", "bases"))
        print(f"[q] {path}: {groups} group(s) of 2 on cuda:0, "
              f"{BATCH // groups} pairs a group: the bits of (o)'s B = "
              f"{want} {same} (within "
              f"{float(np.abs(T - batch_run['T' + want]).max()):.3e}); wall "
              f"per pair (median of 3) {pp:.1f} ms, runs "
              f"{[round(w * 1e3, 1) for w in walls]} ms for {BATCH} pairs; "
              f"(o) B = {want}: {batch_run['walls_pp'][int(want)]:.1f} ms; "
              f"host syncs {syncs} ((o) B = {want}: {want_syncs}); peak "
              f"memory {peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} "
              f"above the {base / 2**20:.1f} MiB held before ((o) B = "
              f"{want}: {o_peak / 2**20:.1f} MiB, "
              f"{(o_peak - o_base) / 2**20:.1f} above its "
              f"{o_base / 2**20:.1f}); launches {paths[path]}; by group "
              f"thread and stream (home, others) "
              f"{list(by.values())}; device memory held by stream "
              f"{sorted(round(v / 2**20, 1) for v in held.values())} MiB "
              f"({len(held)} streams; {len(mesh_mod._STREAMS)} shard and "
              f"{len(intra_mod._STREAMS)} helper streams drawn so far); "
              f"{card}", flush=True)
        if not same:
            problems.append(f"[q] {path}: not the bits of (o)'s B = {want}")
        # and each group's one copy of its results to the host
        if syncs != want_syncs + groups:
            problems.append(f"[q] {path}: host syncs {syncs}, (o) "
                            f"{want_syncs} + {groups} copies")
        if len(by) != groups:
            problems.append(f"[q] {path}: {len(by)} group threads")
        for c in by.values():
            if c["K2"]["home"] != cfg.rescore_icp_iters + 1 \
                    or c["K2"]["others"] != c["K2"]["home"] \
                    or not c["K1"]["home"] \
                    or c["K1"]["others"] != c["K1"]["home"]:
                problems.append(f"[q] {path}: a group's launches {c}")
        if path == "mesh_intra":
            for name in ("nearest_neighbor", "oriented_min_dist_sq"):
                if paths[path][name] != 2 * batch_run["launches8"][name]:
                    problems.append(
                        f"[q] {path}: {name} {paths[path][name]} launches, "
                        f"(o) B = {BATCH}: {batch_run['launches8'][name]}")

    # the final ICP's K2 through the split too
    cfg_icp = dataclasses.replace(cfg, enable_icp=True)
    reset_counts()
    T, ok = run(mesh_mod.make_mesh(devices=["cuda:0"] * 2, intra=2), cfg_icp)
    paths["mesh_intra_icp"] = dict(nn.LAUNCHES)
    same = np.array_equal(T, batch_run["T_icp"]) \
        and ok == batch_run["ok_icp"]
    k2_want = 2 * batch_run["icp_launches"]["nearest_neighbor"]
    print(f"[q] mesh_intra with enable_icp: the bits of (o)'s enable_icp "
          f"batch {same}; launches {paths['mesh_intra_icp']} (K2 "
          f"{k2_want} expected: (o)'s {k2_want // 2}, each in two parts)",
          flush=True)
    if not same or paths["mesh_intra_icp"]["nearest_neighbor"] != k2_want:
        problems.append(f"[q] enable_icp: same bits {same}, launches "
                        f"{paths['mesh_intra_icp']}")
    if problems:
        fail("; ".join(problems))
    return paths


#: (r)'s scene whose K1/K2 shapes and first repeat's K3 grids are timed:
#: the suite's largest lockstep batch (7 pairs)
EVAL_TIMED_SCENE = "floor_long"


def check_eval_suite(cfg, per_clock: float, old_k3):
    """(r) the evaluation suite (``plade_tpu_torch.tools.run_eval``): its 8
    scenes at ``N_POINTS`` = 60000, ``REPEATS`` = 3 repeats each, every
    consecutive pair through ``evaluate_scene(device_batch=True)`` on the
    card at ``cfg`` (the default ``PladeConfig()``).  Per scene: the recall
    of each repeat, the RMSE, s/pair, the peak memory, the K1/K2/K3
    launches (with K1/K2's shapes; K3 once a pass of extraction's graph)
    and the truncation
    counters summed over its pairs; each kernel launched in every scene,
    every transform finite.  The overall recall must reach the reference
    binary's (``REF_EVAL.json``).  The per-pair results go to
    ``chiprun_out/eval_smoke.{md,json}``.  Then K1/K2 at
    ``EVAL_TIMED_SCENE``'s shapes as in (b), and K3 on the grids of that
    scene's first repeat as in (f) (from the repeat run once more with
    extraction's eager loop, which must give its transforms' bits).
    Returns (the suite's launches, the rows of the kernels' JSON line,
    ``"path": "eval_suite"``)."""
    from plade_tpu_torch.kernels import cc, nn
    from plade_tpu_torch.tools import run_eval
    card = gpu_info()
    ref = run_eval.load_reference()
    if not ref:
        fail(f"[r] no reference results at {run_eval.REF_EVAL}")
    rp = sum(r["pairs"] for r in ref.values())
    ref_recall = sum(r["pairs"] * r["recall"] for r in ref.values()) / rp
    launches = dict.fromkeys(nn.LAUNCHES, 0)
    by_shape = {}
    timed = {}
    runs, problems = [], []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as base:
        for sc in run_eval.SCENES:
            name = sc["name"]
            keep = name == EVAL_TIMED_SCENE
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with kernel_calls("nearest_neighbor",
                              lambda a, out: tuple(a[0].shape[:-1])
                              + (a[1].shape[-2],)) as k2, \
                    kernel_calls("oriented_min_dist_sq",
                                 lambda a, out: tuple(a[0].shape[:-1])
                                 + (a[2].shape[-2],)) as k1, \
                    extraction_counts() as ecounts:
                try:
                    run = run_eval.run_scene(sc, cfg, "cuda",
                                             run_eval.REPEATS, base)
                except Exception as e:          # noqa: BLE001
                    fail(f"[r] {name}: {type(e).__name__}: {e}")
            peak = torch.cuda.max_memory_allocated() - held
            counts = dict(nn.LAUNCHES)
            for k, v in counts.items():
                launches[k] += v
            for kname, shapes in (("nearest_neighbor", k2),
                                  ("oriented_min_dist_sq", k1)):
                for shape in shapes:
                    key = (kname, "x".join(map(str, shape)))
                    by_shape[key] = by_shape.get(key, 0) + 1
            if keep:
                # K3's grids: the scene's first repeat once more with
                # extraction's eager loop, which must give its bits
                with eager_k3_calls(lambda a, out: (a[0].clone(), a[1])) \
                        as grids:
                    again = run_eval.run_scene(sc, cfg, "cuda", 1, base)
                if not same_bits(
                        np.asarray([p["transform"]
                                    for p in again.results[0]]),
                        np.asarray([p["transform"]
                                    for p in run.results[0]])):
                    problems.append(f"[r] {name}: the eager loop's "
                                    "transforms differ from the main path's")
                timed = dict(k2=sorted(set(k2)), k1=sorted(set(k1)),
                             grids=grids)
            check_graph_passes(f"[r] {name}:",
                               counts["close_and_label_lanes"], ecounts,
                               None, problems)
            c = run.counters
            print(f"[r] {name}{' (holdout)' if sc['holdout'] else ''}: "
                  f"{run.pairs} pairs, recall {run.recall:.3f} (repeats "
                  f"{'/'.join(f'{x:.2f}' for x in run.recalls)}), RMSE "
                  f"{run.rmse:.4f} (repeats "
                  f"{'/'.join(f'{x:.4f}' for x in run.rmses)}), "
                  f"{run.s_per_pair:.4f} s/pair (walls "
                  f"{[round(w, 3) for w in run.walls]} s), peak memory "
                  f"{peak / 2**20:.1f} MiB above the {held / 2**20:.1f} held "
                  f"before; launches K2 {counts['nearest_neighbor']} at "
                  f"{sorted(set(k2))}, K1 {counts['oriented_min_dist_sq']} "
                  f"at {sorted(set(k1))}, K3 {counts['close_and_label_lanes']}"
                  f"; extraction counters {ecounts}; counters {c}; {card}",
                  flush=True)
            for rep, res in enumerate(run.results):
                for p in res:
                    if not np.isfinite(p["transform"]).all():
                        problems.append(f"[r] {name} repeat {rep} pair "
                                        f"{p['pair']}: transform not finite")
                    if not p["recalled"] or any(p[k] for k in
                                                run_eval.COUNTERS):
                        print(f"[r] {name} repeat {rep} pair {p['pair']}: "
                              f"success {p['success']}, rotation error "
                              f"{p['rot_err_deg']:.3f} deg, translation "
                              f"error {p['trans_err']:.4f}, score "
                              f"{p['score']:.4f}, matched planes "
                              f"{p['matched_planes']}, counters "
                              f"{[p[k] for k in run_eval.COUNTERS]}",
                              flush=True)
            if min(counts.values()) < 1:
                problems.append(f"[r] {name}: a kernel was not launched: "
                                f"{counts}")
            runs.append(run)
    wall = time.perf_counter() - t0
    sums = {k: sum(r.counters[k] for r in runs) for k in run_eval.COUNTERS}
    total, recall, rmse = run_eval.overall([(r.pairs, r.recall, r.rmse)
                                            for r in runs])
    out = Path(__file__).resolve().parent / "chiprun_out" / "eval_smoke"
    beats = run_eval.write_report(runs, ref, str(out), card,
                                  run_eval.REPEATS, wall)
    print(f"[r] the suite: recall {recall:.4f} over {total} pairs x "
          f"{run_eval.REPEATS} repeats (the reference binary "
          f"{ref_recall:.4f}; every scene at or above its reference "
          f"column: {beats}), translation RMSE {rmse:.4f}, {wall:.1f} s; "
          f"launches {launches}; K1/K2 launches by shape {by_shape}; "
          f"counters summed {sums}; "
          f"results in {out}.md/.json; {card}", flush=True)
    if recall < ref_recall:
        problems.append(f"[r] recall {recall} below the reference binary's "
                        f"{ref_recall}")
    if problems:
        fail("; ".join(problems))
    rows = check_batched_kernels(nn, timed["k2"], timed["k1"],
                                 path="eval_suite", tag="[r]")
    for row in rows:
        row["launches"] = by_shape.get((row["name"], row["shape"]), 0)
    k3_row = k3_main_path(cc, timed["grids"], per_clock, old_k3, tag="[r]")
    k3_row.update(path="eval_suite",
                  launches=launches["close_and_label_lanes"],
                  shape=f"{EVAL_TIMED_SCENE}, repeat 0: "
                        f"{k3_row['shape'].split(': ', 1)[1]}")
    return launches, rows + [k3_row]


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout of the parent tree: also build its csrc/nn.cu and "
             "csrc/cc.cu and time its K1/K2/K3 against this tree's in "
             "turns, in phases (b) and (f)")
    parser.add_argument(
        "--mesh-worker", nargs=4, metavar=("RANK", "WORLD", "ADDR", "DIR"),
        default=None, help="run as a rank of phase (p)'s 2-process world")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", flush=True)
        sys.exit(2)
    try:
        import plade_tpu_torch  # noqa: F401
    except ModuleNotFoundError:
        fail("plade_tpu_torch is not beside chip_smoke.py: run the script "
             "from the root of a checkout of the repository")
    if args.mesh_worker:
        rank, world, addr, work = args.mesh_worker
        mesh_worker(int(rank), int(world), addr, Path(work))
        return
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.io import synthetic as syn
    from plade_tpu_torch.kernels import build, cc, nn
    from plade_tpu_torch.pipeline import register_clouds, register_with_planes

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}", flush=True)

    # (a) build
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as report:
        build.build(verbose=True)
    report = report.getvalue()
    print(report, flush=True)
    build.library()
    print(f"[a] kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # (b) kernels against their plain versions
    rows, inputs = check_kernels(nn)
    old_k3 = None
    if args.parent is not None:
        nn_dll, keys, cc_dll = parent_libraries(args.parent)
        compare_parent(nn, nn_dll, keys, rows, inputs)
        old_k3 = parent_k3(cc_dll)
    del inputs
    rows += check_batched_kernels(nn)
    rows += check_topk(nn, report)
    rows += check_walk(report)
    per_clock = cell_ops_per_clock()
    rows += check_cc(cc, per_clock, old_k3)

    # (c) the slice at the default config
    cfg = PladeConfig()
    tp, tn, sp, sn, tpl, spl, R, t, gen = make_scene(
        16000, 0, ptypes.PlaneSet, cfg.max_planes, syn)
    print(f"[c] scene: target {tp.shape[0]} pts / {int(tpl.count)} planes, "
          f"source {sp.shape[0]} pts / {int(spl.count)} planes", flush=True)
    T, info = register_with_planes(tp, tn, sp, sn, tpl, spl, cfg,
                                   device="cuda")          # warm-up
    walls = []
    for run in range(3):
        if run == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, info = register_with_planes(tp, tn, sp, sn, tpl, spl, cfg,
                                       device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = dict(nn.LAUNCHES)
            syncs = ptypes.HOST_SYNCS["count"]
    check_result("[c]", T, info)
    rot, trans = pose_errors(T, R, t)
    print(f"[c] rotation error {rot:.6f} deg, translation error {trans:.6f}"
          f", matched_planes {info['matched_planes']}, score "
          f"{info['score']:.6f}, overlap {info['overlap']:.6f}", flush=True)
    print(f"[c] counters: match_saturated {info['match_saturated']}, "
          f"pen_overflow {info['pen_overflow']}, cluster_truncated "
          f"{info['cluster_truncated']}", flush=True)
    print(f"[c] launches per registration: {launches}; host syncs "
          f"{syncs}; wall per pair (median of 3) "
          f"{statistics.median(walls) * 1e3:.1f} ms, runs "
          f"{[round(w * 1e3, 1) for w in walls]} ms", flush=True)
    if rot >= ROT_TOL_DEG or trans >= TRANS_TOL:
        fail(f"pose error {rot} deg / {trans} beyond {ROT_TOL_DEG} / "
             f"{TRANS_TOL}")
    for key in ("match_saturated", "pen_overflow", "cluster_truncated"):
        if info[key] != 0:
            fail(f"{key} = {info[key]}")
    if launches["oriented_min_dist_sq"] < 2 or launches["nearest_neighbor"] \
            < 4:
        fail(f"kernel launches {launches} below K1 >= 2, K2 >= 4")
    planes_launches = launches

    # (d) one profiled registration: where the time goes
    profile_stages(lambda: register_with_planes(tp, tn, sp, sn, tpl, spl,
                                                cfg, device="cuda"))

    # (e) small scene: the card against the CPU (plain kernel versions)
    small = dataclasses.replace(
        cfg, max_ds_points=4096, max_plane_points=1024, max_lines=128,
        max_query_pairs=2048, max_target_pairs=4096, max_matches=8192,
        max_pose_clusters=512, max_candidate_results=64,
        max_penetration_tests=1024, spacing_samples=2000, max_planes=12)
    stp, stn, ssp, ssn, stpl, sspl, sR, st, _ = make_scene(
        1500, 1, ptypes.PlaneSet, small.max_planes, syn)
    Tg, ig = register_with_planes(stp, stn, ssp, ssn, stpl, sspl, small,
                                  device="cuda")
    Tc, ic = register_with_planes(stp, stn, ssp, ssn, stpl, sspl, small,
                                  device="cpu")
    check_result("[e] gpu", Tg, ig)
    check_result("[e] cpu", Tc, ic)
    drot, dtrans = pose_errors(Tg, Tc[:3, :3], Tc[:3, 3])
    print(f"[e] small scene, card vs CPU: rotation diff {drot:.6f} deg, "
          f"translation diff {dtrans:.3e}, score {ig['score']:.6f} vs "
          f"{ic['score']:.6f}, matched_planes {ig['matched_planes']} vs "
          f"{ic['matched_planes']}", flush=True)
    if drot >= 0.1 or dtrans >= 1e-3 \
            or ig["matched_planes"] != ic["matched_planes"] \
            or abs(ig["score"] - ic["score"]) >= 1e-3:
        fail("card and CPU disagree on the small scene")
    for side, (pts, nrm) in (("target", (stp, stn)), ("source", (ssp, ssn))):
        extract_card_vs_cpu(pts, nrm, small, side)

    # (f) register_clouds and (g) register_files on the scene of (c)
    clouds_run = check_register_clouds(tp, tn, sp, sn, R, t, gen, cfg,
                                       "cuda")
    row = k3_main_path(cc, clouds_run["k3_grids"], per_clock, old_k3)
    row["path"] = "register_clouds"
    rows.append(row)

    # (h) one profiled register_clouds: where the time goes
    clouds_table = profile_stages(lambda: register_clouds(
        tp, tn, sp, sn, cfg, seed=0, device="cuda"), tag="[h]")
    if "plade.extract" not in clouds_table:
        fail("[h] no plade.extract range in the profile")

    # (i) the device step: lockstep extraction, K3 at L = 12
    scene = (tp, tn, sp, sn, R, t)
    step_run = check_device_step(scene, cfg, clouds_run, clouds_table)
    row = k3_main_path(cc, step_run["k3_grids"], per_clock, old_k3,
                       tag="[i]")
    row["path"] = "register_pair_device"
    rows.append(row)

    # (j), (k) the options; (l) the batch entry
    paths, icp_k2 = check_options(scene, cfg, step_run)
    paths["register_array_pairs"] = check_array_pairs(cfg)
    # (m) the command line, (n) scene mode
    paths.update(check_cli(scene, clouds_run["files_T"], cfg))
    paths.update(check_scene(cfg))
    # (o) the bench's 8 pairs in lockstep
    batch_launches, batch_by_shape, k3_row, batch_run = check_batch(
        scene, cfg, per_clock, old_k3, step_run)
    # (p) pairs over a pairs axis: two shards on the card, the default
    # mesh, a 2-process world; utils.timing.stage around one step
    paths.update(check_mesh(cfg, batch_run))
    # (q) one pair's nearest-neighbour passes over a group: the split
    # kernels, two intra meshes on the card, one with enable_icp
    paths.update(check_intra(cfg, batch_run))
    # (r) the evaluation suite: 8 scenes x 3 repeats, 41 pairs
    print(f"[r] the script's time before (r): "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    paths["eval_suite"], eval_rows = check_eval_suite(cfg, per_clock, old_k3)
    rows += eval_rows
    print(f"[r] the script's time after (r): "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    rows.append(k3_row)
    # launches by (kernel, shape) of the runs that count them by shape
    by_shape = {"register_batch": batch_by_shape,
                "register_clouds": clouds_run["by_shape"]}
    for row in rows:
        if (row.get("path") == "register_batch" and "launches" not in row) \
                or row["name"] == "topk_dist_sq":
            row["launches"] = by_shape[row["path"]].get(
                (row["name"], row["shape"]), 0)
    paths.update({"register_batch": batch_launches,
                  "register_pair_device": step_run["launches"],
                  "register_clouds": clouds_run["launches"],
                  "register_with_planes": planes_launches})
    for row in rows:
        if row["name"] == "nearest_neighbor" and \
                row["shape"] == f"{ICP_SHAPE[0]}x{ICP_SHAPE[1]}":
            row["path"] = "enable_icp"
        path = row.setdefault("path", "register_pair_device")
        row["launches_by_path"] = {p: counts.get(row["name"], 0)
                                   for p, counts in paths.items()}
        if path in ("register_batch", "eval_suite") \
                or row["name"] in ("topk_dist_sq", "penetration_walk"):
            pass                # (o)'s, (r)'s or (f)'s at this row's shape
        elif path is None:
            # measured on chip_smoke's own grids, on no main path (K3' is
            # the L = 1 entry the reference's tests call; the paths run the
            # same kernel through close_and_label_lanes)
            row["on_main_path"] = False
            row["launches"] = 0
        elif path == "enable_icp":
            # its path's K2 launches at this shape (the rescore's are at
            # 131072 x 16384)
            row["launches"] = icp_k2
        else:
            row["launches"] = paths[path].get(row["name"], 0)

    print(json.dumps({"kernels": rows}))
    print(gpu_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
