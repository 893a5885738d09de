"""Batch registration of pairs over a pairs axis of devices
(``plade_tpu/dist/mesh.py``).

The reference vmaps its device step over a leading pair axis
(``make_batch_register``) and shards that batch over a JAX device mesh: a
``pairs`` axis of data parallelism and an ``intra`` axis for the point
buffers.  Here a batch on one device is the device step of
``pipeline.build_register_device_fn`` over a leading pair axis: its B pairs
run in lockstep, each kernel launched once for all of them (K1/K2 with a
pair axis, K3 over the lanes of all 2B clouds), each host loop run to the
slowest pair.  A :class:`Mesh` is the ``(pairs, intra)`` mesh: a list of
devices (one device may stand more than once) read as groups of ``intra``
devices.  Each group is a shard that runs its contiguous part of a batch
in lockstep on its first device, its home, in a host thread of its own
(the caller's, when one shard has pairs) and on a CUDA stream of its own;
the spacing's top-k and the K1/K2 launches of its pairs split their query
rows over the group (``dist/intra.py``), and every other stage runs on
home.  A mesh of several processes (``dist/multihost.py``) adds a rank and
a process group: each rank runs its own pairs on its own devices (a group
never spans ranks), and every rank gets every pair's result.  Pairs never
communicate, so only the small ``RegistrationResult`` crosses groups and
ranks.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PladeConfig
from ..core.types import Cloud, RegistrationResult, host_tensors, pad_cloud
from ..pipeline import (_cap_cloud, _pad_size, _run_device,
                        register_pair_device)
from ..utils import timing

PAIRS = "pairs"
INTRA = "intra"


class Mesh(NamedTuple):
    """The devices this process runs its pairs on, read as groups of
    ``intra`` (group ``g`` is ``devices[g * intra:(g + 1) * intra]``, its
    first device home); ``rank`` and ``world_size`` place the process in a
    multi-process mesh (0 and 1, ``group`` None, for one process)."""
    devices: tuple
    rank: int = 0
    world_size: int = 1
    group: object = None
    intra: int = 1

    @property
    def groups(self) -> list[tuple]:
        """The pairs axis: one tuple of devices a group, home first."""
        k = self.intra
        return [self.devices[g:g + k] for g in range(0, len(self.devices),
                                                     k)]


class PairOutcome(NamedTuple):
    """Per-pair batch result, with the truncation diagnostics the
    single-pair entry reports in its info dict."""
    transform: np.ndarray   # (4, 4)
    success: bool
    score: float
    overlap: float
    matched_planes: int
    cloud_capped: bool = False      # input subsampled to cfg.max_points
    match_saturated: int = 0        # dropped descriptor radius hits (rows)
    pen_overflow: int = 0           # dropped penetration tests
    cluster_truncated: int = 0      # hypotheses beyond the cluster prefix


def make_mesh(n_devices: int | None = None, intra: int = 1,
              devices=None) -> Mesh:
    """A ``(pairs, intra)`` mesh over the first ``n_devices`` of
    ``devices`` (torch devices or their names; one device may stand more
    than once, within a group too), by default every visible CUDA card:
    ``n_devices // intra`` groups of ``intra`` consecutive devices.
    Without a card the default raises ``RuntimeError``, as the entry points
    do.  Groups have run on one card repeated (``["cuda:0"] * 2``); groups
    of distinct cards have not been run yet."""
    if devices is None:
        _run_device("cuda")
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devices = tuple(_run_device(d) for d in devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} of {len(devices)} devices")
    if intra < 1 or n_devices % intra != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"intra={intra}")
    return Mesh(devices[:n_devices], intra=intra)


def device_mesh(device=None) -> Mesh:
    """The mesh a ``device`` argument names: every visible card for
    ``cuda`` without an index (the default), else that one device."""
    device = _run_device(device)
    if device.type == "cuda" and device.index is None:
        return make_mesh()
    return make_mesh(devices=[device])


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack same-shape Clouds along a new leading batch axis."""
    return Cloud(*(torch.stack(xs) for xs in zip(*clouds)))


def _stack_padded(clouds, pad: int, device) -> Cloud:
    """(points, normals) pairs padded to ``pad`` rows on ``device`` and
    stacked; no clouds give a Cloud of 0 pairs on the CPU."""
    if not clouds:
        return Cloud(torch.zeros(0, pad, 3), torch.zeros(0, pad, 3),
                     torch.zeros(0, dtype=torch.int32))
    return stack_clouds([pad_cloud(p, n, pad, device) for p, n in clouds])


def _bounds(n: int, k: int) -> list[int]:
    """Offsets of ``n`` items split into ``k`` contiguous parts whose sizes
    differ by at most 1, the larger first."""
    q, r = divmod(n, k)
    return [i * q + min(i, r) for i in range(k + 1)]


def _empty_result() -> RegistrationResult:
    """A ``RegistrationResult`` of 0 pairs on the CPU."""
    i32 = torch.int32
    return RegistrationResult(
        transform=torch.zeros(0, 4, 4), score=torch.zeros(0),
        overlap=torch.zeros(0), matched_planes=torch.zeros(0, dtype=i32),
        success=torch.zeros(0, dtype=torch.bool),
        match_saturated=torch.zeros(0, dtype=i32),
        pen_overflow=torch.zeros(0, dtype=i32),
        cluster_truncated=torch.zeros(0, dtype=i32))


#: each shard's stream, by (device, shard): drawn once and reused, so that
#: the caching allocator keeps a shard's blocks for its next batch (a new
#: stream a call would allocate its whole working set anew)
_STREAMS: dict = {}


def _in_shard(device: torch.device, shard: int, after, fn):
    """``fn()`` in this thread on ``device``: for a card under its device
    context and on the stream of shard ``shard`` there, which first waits
    for ``after`` (the stream that made the inputs, or None)."""
    if device.type != "cuda":
        return fn()
    with torch.cuda.device(device):
        stream = _STREAMS.get((device, shard))
        if stream is None:
            stream = _STREAMS.setdefault((device, shard),
                                         torch.cuda.Stream(device))
        if after is not None:
            stream.wait_stream(after)
        with torch.cuda.stream(stream):
            return fn()


def _register_shards(tgt_batch: Cloud, src_batch: Cloud, seeds, cfg,
                     groups, draws) -> RegistrationResult:
    """The batch split into contiguous shards over ``groups`` (tuples of
    devices, home first), each shard in lockstep on its home with the rest
    of its group as ``intra``, in a host thread of its own (a lone shard in
    this thread); the results on the CPU in pair order.  A shard's
    exception is raised here once every shard has ended.  Each shard is
    the span ``shard.<k>.<home>``, credited to the caller's call, with its
    pairs counted as ``shard.<k>.pairs``."""
    B, N = tgt_batch.points.shape[:2]
    after = torch.cuda.current_stream(tgt_batch.points.device) \
        if tgt_batch.points.is_cuda else None
    cut = _bounds(B, len(groups))
    caller = timing.current_call()

    def shard(k, group, lo, hi):
        with timing.joined(caller), timing.stage(f"shard.{k}.{group[0]}"):
            timing.count(f"shard.{k}.pairs", hi - lo)
            step = register_pair_device(cfg, N, group[0], group[1:])
            res = step(Cloud(*(x[lo:hi] for x in tgt_batch)),
                       Cloud(*(x[lo:hi] for x in src_batch)), seeds[lo:hi],
                       None if draws is None else draws[2 * lo:2 * hi])
            # the copy to the host waits for the shard's stream
            return RegistrationResult(*host_tensors(res))

    jobs = [(k, g, lo, hi) for k, (g, lo, hi)
            in enumerate(zip(groups, cut, cut[1:])) if hi > lo]
    if not jobs:
        return _empty_result()
    if len(jobs) == 1:
        # in this thread, where the caller's profiler sees its ranges
        (k, g, lo, hi), = jobs
        return _in_shard(g[0], k, after,
                         functools.partial(shard, k, g, lo, hi))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_in_shard, g[0], k, after,
                               functools.partial(shard, k, g, lo, hi))
                   for k, g, lo, hi in jobs]
    parts = [f.result() for f in futures]
    return RegistrationResult(*(torch.cat(f) for f in zip(*parts)))


def _gather(local: RegistrationResult, mesh: Mesh) -> RegistrationResult:
    """Every rank's results, in rank order, on every rank (a rank may have
    none)."""
    import torch.distributed as dist
    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, local, group=mesh.group)
    return RegistrationResult(*(torch.cat(f) for f in zip(*parts)))


def register_batch(tgt_batch: Cloud, src_batch: Cloud, seeds,
                   cfg: PladeConfig, mesh: Mesh | None = None, device=None,
                   draws=None) -> RegistrationResult:
    """Register a batch of pairs: ``tgt_batch`` / ``src_batch`` are Clouds
    of B pairs padded to one size with a leading pair axis, pair ``i``
    drawing from ``seeds[i]`` (or, with ``draws``, from the 2B functions
    in the step's order: target 0, source 0, target 1, ...).

    With ``device``, the batch runs in lockstep on that one device, and the
    results are tensors there.  Otherwise it runs on ``mesh`` (by default
    :func:`make_mesh`, every visible card): split into contiguous shards
    over the mesh's groups (sizes differing by at most 1; a shard of 0
    pairs launches nothing), each in lockstep on its group, and the results
    are CPU tensors in pair order.  On a mesh of several processes the
    batch is this rank's pairs (:func:`multihost.local_batch_to_global`)
    and every rank returns every rank's results, in rank order.  Each
    pair's result is what the step gives that pair alone."""
    seeds = [int(s) for s in seeds]
    B = tgt_batch.points.shape[0]
    if len(seeds) != B or (draws is not None and len(draws) != 2 * B):
        raise ValueError(f"register_batch: {B} pairs, {len(seeds)} seeds, "
                         f"{None if draws is None else len(draws)} draws")
    if device is not None and mesh is not None:
        raise ValueError("register_batch: give mesh or device, not both")
    with timing.call("register_batch", B):
        if device is not None:
            step = register_pair_device(cfg, tgt_batch.points.shape[1],
                                        device)
            return step(tgt_batch, src_batch, seeds, draws)
        if mesh is None:
            mesh = make_mesh()
        res = _register_shards(tgt_batch, src_batch, seeds, cfg,
                               mesh.groups, draws)
        return _gather(res, mesh) if mesh.world_size > 1 else res


def register_array_pairs(cloud_pairs, cfg: PladeConfig, seed: int = 0,
                         mesh: Mesh | None = None, device=None,
                         batch_pairs: int = 8) -> list[PairOutcome]:
    """Register a list of raw numpy cloud pairs through the device step:
    the host-level entry of batch flows.

    ``cloud_pairs``: list of (tgt_pts, tgt_nrm, src_pts, src_nrm).  Each
    cloud is capped at ``cfg.max_points`` (pair ``i``'s target drawn from
    ``seed + 2i``, its source from ``seed + 2i + 1``), all pairs are padded
    to one size, and pair ``i`` registers with seed ``seed + i``.  The
    pairs run in lockstep ``batch_pairs`` at a time on ``device``, or on
    every shard of ``mesh`` (by default :func:`make_mesh`, every visible
    card; on a mesh of several processes every rank passes every pair, runs
    its part and returns all): :func:`register_batch` on chunks of
    ``batch_pairs`` pairs a shard.  No chunk is padded with a repeated
    pair, so every outcome is what the step gives that pair alone.  No
    target/source swap is applied (the device step mirrors the cloud-level
    reference overload, plade.cpp:638-662).  Returns one PairOutcome per
    input pair."""
    if batch_pairs < 1:
        raise ValueError(f"batch_pairs must be >= 1, got {batch_pairs}")
    if mesh is not None and device is not None:
        raise ValueError("register_array_pairs: give mesh or device, not "
                         "both")
    if device is not None:
        device = _run_device(device)
    elif mesh is None:
        mesh = make_mesh()
    if not cloud_pairs:
        return []
    with timing.call("register_array_pairs", len(cloud_pairs)):
        with timing.stage("entry.stage_in"):
            capped = []
            cap_flags = []
            max_n = 0
            for i, (tp, tn, sp, sn) in enumerate(cloud_pairs):
                tp, tn, t_capped = _cap_cloud(tp, tn, cfg.max_points,
                                              seed + 2 * i)
                sp, sn, s_capped = _cap_cloud(sp, sn, cfg.max_points,
                                              seed + 2 * i + 1)
                if t_capped or s_capped:
                    print(f"[register_array_pairs] pair {i}: cloud capped "
                          f"to max_points={cfg.max_points}", flush=True)
                cap_flags.append(bool(t_capped or s_capped))
                max_n = max(max_n, tp.shape[0], sp.shape[0])
                capped.append((tp, tn, sp, sn))
            pad = _pad_size(max_n, maximum=cfg.max_points)
        # the padded clouds: on the device, or on the host for the shards
        home = device or torch.device("cpu")
        D = len(mesh.groups) if mesh is not None else 1
        W = mesh.world_size if mesh is not None else 1
        outcomes = []
        for start in range(0, len(capped), batch_pairs * D * W):
            chunk = capped[start:start + batch_pairs * D * W]
            # this rank's part: its groups' shards of the chunk
            cut = _bounds(len(chunk), D * W)
            r = mesh.rank if mesh is not None else 0
            lo, hi = cut[r * D], cut[(r + 1) * D]
            with timing.stage("entry.stage_in"):
                tgt_b, src_b = (_stack_padded([c[2 * s:2 * s + 2]
                                               for c in chunk[lo:hi]], pad,
                                              home) for s in (0, 1))
            res = register_batch(
                tgt_b, src_b, [seed + start + lo + i for i in range(hi - lo)],
                cfg, mesh=mesh, device=device)
            with timing.stage("entry.read_out"):
                # a mesh's shards have copied their results to the host
                host = host_tensors(res) if device is not None else res
                cols = {f: x.tolist() for f, x in zip(res._fields[1:],
                                                       host[1:])}
                outcomes += [PairOutcome(
                    host[0][i].numpy(), cloud_capped=cap_flags[start + i],
                    **{f: v[i] for f, v in cols.items()})
                    for i in range(len(chunk))]
    return outcomes
