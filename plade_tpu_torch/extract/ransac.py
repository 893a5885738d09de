"""Batched greedy RANSAC plane extraction (``plade_tpu/extract/ransac.py``).

The reference package's module docstring describes the algorithm: a
Schnabel Efficient-RANSAC plane detector reshaped into greedy rounds of
wide candidate draws, subset scoring, exact rescoring of a few check
lanes, multi-accept with exclusive assignment, Gaussian-gated refits and a
largest-connected-component trim on a 2-D occupancy bitmap.  This port
keeps its semantics operation for operation; where PyTorch differs:

* The extractor carries a leading axis of clouds, which it extracts in
  lockstep: every operation of a round launches once for all of them, as
  the reference's ``jax.vmap`` of its extractor computes it (the device
  step extracts the targets and sources of all its pairs together).  One cloud is the call with
  one cloud on that axis.
* ``lax.while_loop`` is a Python loop.  The clouds' ``done`` flags are read
  on the host once per round (``core.types.host_value``), and nothing else
  inside a round reads the device.  A cloud that is done is frozen: the
  rounds the others still run leave its state, ``rounds`` included, as it
  was, as the vmapped ``while_loop`` of the reference does.  Each pass is
  the span ``extract.round`` (``utils/timing.py``), its draws and its read
  of ``done`` spans of their own; the call counts the passes
  (``extract.rounds``), the clouds they computed (``extract.cloud_rounds``)
  and those of them already done (``extract.frozen``).
* On a card a pass is one CUDA graph (:class:`_PassGraph`): its round has
  fixed shapes and reads nothing on the host, so it is captured once per
  extractor, stream, cloud count and floor support and replayed each pass,
  instead of some two thousand launches enqueued from Python.  A stream
  keeps one graph, whose memory pool holds about a round's working set
  (:func:`_pass_graph`).  The draws stay outside it, eager, and are
  copied into its static buffers.  The first pass of a new graph runs
  eagerly (the warm-up) before the capture; the call counts the replayed
  passes (``extract.graph_rounds``) and the captures
  (``extract.graph_captures``).  On the CPU, and under a capture the
  caller already runs, the passes run eagerly.  Both paths run the same
  :func:`build_extract_fn` pass, bit for bit.
* ``top_k``, ``approx_max_k`` (exact off the TPU) and ``argsort`` keep the
  lower index first among ties, as JAX does: they are stable sorts here.
* ``.at[idx].set(..., mode="drop")`` scatters into a buffer one slot
  longer and cuts that slot off (``_set_drop``).
* The random draws of a round come from one function per cloud,
  ``draws(state) -> (g, lvl, g2, g3)`` of that cloud's state, by default
  fed by a ``torch.Generator`` on the cloud's device (``generator_draws``).
  The tests pass one that replays ``jax.random``, which holds the whole
  extractor to the reference package on identical draws.  A cloud that is
  done draws no more.
* The connected-component labelling is K3
  (``kernels/cc.close_and_label_lanes``) with ``bitmap_cc_iters_tpu``
  rounds on every device: the CUDA kernel on the card, its plain version
  on the CPU, one launch over the lanes of all clouds.  (The reference
  labels with a pointer-jump HLO on the CPU and with K3 on the TPU; both
  agree wherever the labels have converged.)
* The trim's occupancy histogram and component sizes are integer
  scatter-adds, exact on every device.
* The pool dedup key ``counts * SC - arange(SC)`` is int64 (int32 overflows
  near 16k candidates per round).
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Callable, NamedTuple

import torch

from ..core.config import PladeConfig
from ..core.ops import drop, lift, take
from ..core.types import PlaneSet, host_value
from ..geometry.eig3 import smallest_eigvec3
from ..geometry.transforms import cross
from ..kernels.build import captured_launches, credit_launches
from ..kernels.cc import close_and_label_lanes
from ..utils import timing

_EPS = 1e-12
#: ring of banned planes (see ``_State.ban_n``)
_BAN_RING = 256
_I32 = torch.int32
_F32 = torch.float32


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` computes
    it: sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(_norm(v), min=_EPS)


def _plane_basis(normal: torch.Tensor):
    """Two orthonormal in-plane axes for unit normals (..., 3)."""
    big = (torch.abs(normal[..., 0:1]) > 0.9).to(normal.dtype)
    h = torch.cat([1.0 - big, big, torch.zeros_like(big)], dim=-1)
    u = _normalize(cross(normal, h))
    v = cross(normal, u)
    return u, v


def _fit_plane(points: torch.Tensor, weights: torch.Tensor):
    """Weighted LS planes through points (..., N, 3), one per row of
    weights (..., N): centroid + smallest covariance eigenvector
    (Plane::LeastSquaresFit semantics, Plane.cpp:169-191).  Returns
    (normals (..., 3), centroids (..., 3))."""
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1.0)
    c = torch.sum(points * w[..., :, None], dim=-2)
    d = (points - c[..., None, :]) * torch.sqrt(w)[..., :, None]
    cov = d.transpose(-1, -2) @ d
    return smallest_eigvec3(cov), c


class ExtractStats(NamedTuple):
    """Termination diagnostics of one greedy extraction run (with a leading
    cloud axis when several clouds are extracted together)."""
    rounds: torch.Tensor        # () int32 — greedy rounds executed
    drawn: torch.Tensor         # () f32 — drawn counter at termination
    trials: torch.Tensor        # () int32 — support halvings used
    min_support: torch.Tensor   # () int32 — final support threshold


class _State(NamedTuple):
    """The reference's extraction state without its PRNG key (the draws
    come from a ``draws`` function per cloud).  In the loop every field
    carries a leading axis of B clouds; a ``draws`` function sees its own
    cloud's slice, with the shapes below."""
    assigned: torch.Tensor      # (N,) bool
    point_plane: torch.Tensor   # (N,) int32
    coeffs: torch.Tensor        # (P, 4)
    sizes: torch.Tensor         # (P,) int32
    num_planes: torch.Tensor    # () int32
    min_support: torch.Tensor   # () int32 — current support threshold
    drawn: torch.Tensor         # () f32 — valid candidates drawn (decayed)
    trials: torch.Tensor        # () int32 — support halvings used
    exh_streak: torch.Tensor    # () int32 — consecutive exhaustion rounds
    rounds: torch.Tensor        # () int32 — greedy rounds executed
    pool_n: torch.Tensor        # (C, 3) — candidate pool plane normals
    pool_d: torch.Tensor        # (C,)   — candidate pool plane offsets
    pool_valid: torch.Tensor    # (C,) bool
    pool_dormant: torch.Tensor  # (C,) bool — exact-debunked at this level
    pool_exact: torch.Tensor    # (C,) int32 — last exact count if dormant
    level_probs: torch.Tensor   # (L,) f32 — 3-point sampling level weights
    ban_n: torch.Tensor         # (K, 3) — banned planes (ring buffer)
    ban_d: torch.Tensor         # (K,)
    ban_loose: torch.Tensor     # (K,) bool — loose-tolerance (trim-fail) ban
    ban_count: torch.Tensor     # () int32 — total bans pushed (ring cursor)
    done: torch.Tensor          # () bool


#: ``draws(state) -> (g (N,) f32 uniform, lvl (S_cell,) int level,
#: g2 (n_draw,) f32 uniform, g3 (n_draw,) f32 uniform)`` for one cloud
Draws = Callable[[_State], tuple]


def generator_draws(generator: torch.Generator, num_points: int,
                    n_cell: int, n_draw: int) -> Draws:
    """A round's draws from ``generator`` on its device: the anchors'
    uniform noise, the 3-point draws' sampling levels (Gumbel-max over the
    log level weights, as ``jax.random.categorical``) and the two
    companion picks' uniform noise."""
    dev = generator.device
    tiny = torch.finfo(_F32).tiny

    def draws(state: _State):
        g = torch.rand(num_points, generator=generator, device=dev)
        u = torch.rand((n_cell, state.level_probs.shape[0]),
                       generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        logits = torch.log(torch.clamp(state.level_probs, min=1e-9))
        lvl = torch.argmax(gumbel + logits, dim=-1)
        g2 = torch.rand(n_draw, generator=generator, device=dev)
        g3 = torch.rand(n_draw, generator=generator, device=dev)
        return g, lvl, g2, g3

    return draws


def _set_drop(base: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
              vals) -> torch.Tensor:
    """Per cloud, ``base[c].at[idx[c]].set(vals[c], mode="drop")`` for
    base (B, M, ...) and idx (B, k) in [0, M]: index M is dropped.
    ``rows`` is ``arange(B)[:, None]``."""
    buf = torch.cat([base, base.new_zeros(base.shape[:1] + (1,)
                                          + base.shape[2:])], dim=1)
    buf[rows, idx] = vals
    return buf[:, :-1]


def _set(base: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
         vals) -> torch.Tensor:
    """Per cloud, ``base[c].at[idx[c]].set(vals[c])`` with in-range
    indices."""
    buf = base.clone()
    buf[rows, idx] = vals
    return buf


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first true entry along the last axis (0 if none), as
    ``jnp.argmax`` of a bool array."""
    return torch.argmax(mask.to(_I32), dim=-1)


def _trim_bitmap(uv, inlier, cell, grid: int, t_sub: int = 1):
    """Phase 1 of the CC trim for a batch of lanes: uv (..., N, 2), inlier
    (..., N) -> (occupancy counts (..., grid * grid) int32, flat cell index
    per point (..., N) int64).

    The cell is stretched when the plane's extent exceeds ``grid`` cells.
    Occupancy counts every ``t_sub``-th point; every point's own cell index
    is exact.  The histogram is an integer scatter-add."""
    big = 1e30
    cell = torch.as_tensor(cell, dtype=_F32, device=uv.device)
    umin = torch.amin(torch.where(inlier[..., None], uv, big), dim=-2)
    umax = torch.amax(torch.where(inlier[..., None], uv, -big), dim=-2)
    extent = torch.amax(umax - umin, dim=-1)
    cell = torch.maximum(torch.clamp(cell, min=_EPS), extent / (grid - 1))
    # clamped before the int conversion: XLA's conversion saturates, C's
    # is undefined out of range
    ij = torch.clamp(torch.floor((uv - umin[..., None, :])
                                 / cell[..., None, None]), 0, grid - 1)
    ij = ij.to(torch.int64)
    flat = ij[..., 0] * grid + ij[..., 1]
    occ = torch.zeros(inlier.shape[:-1] + (grid * grid,), dtype=_I32,
                      device=uv.device)
    occ.scatter_add_(-1, flat[..., ::t_sub], inlier[..., ::t_sub].to(_I32))
    return occ, flat


def _trim_select(occ_counts, flat_labels, flat, inlier, grid: int):
    """Phase 3 of the CC trim for a batch of lanes: keep the inliers of the
    component with the most occupancy.  occ_counts, flat_labels (...,
    grid * grid); flat, inlier (..., N) -> kept (..., N).  Component sizes
    are the occupancy summed by label (an integer scatter-add; the label
    G * G, outside every component, falls in a slot that is cut off)."""
    GG = grid * grid
    labels = flat_labels.to(torch.int64)
    comp = torch.zeros(occ_counts.shape[:-1] + (GG + 1,), dtype=_I32,
                       device=occ_counts.device)
    comp.scatter_add_(-1, labels, occ_counts.to(_I32))
    best = torch.argmax(comp[..., :GG], dim=-1)          # first maximum
    point_labels = torch.gather(labels, -1, flat)
    return inlier & (point_labels == best[..., None])


def _largest_component_masks(uv, inl, cell, grid: int, t_sub: int = 1,
                             cc_iters: int = 256):
    """CC trim for all lanes: uv (..., N, A, 2), inl (..., N, A), cell
    (...) -> kept (..., N, A).  The labelling is one K3 launch over the
    lanes of every leading index (L = B x A for B clouds)."""
    cell = torch.as_tensor(cell, dtype=_F32, device=uv.device)[..., None]
    occ, flat = _trim_bitmap(uv.transpose(-3, -2), inl.transpose(-2, -1),
                             cell, grid, t_sub)
    labels = close_and_label_lanes(occ.reshape(-1, grid, grid),
                                   cc_iters).reshape(occ.shape)
    return _trim_select(occ, labels, flat, inl.transpose(-2, -1),
                        grid).transpose(-2, -1)


def _support_thresholds(cfg: PladeConfig) -> list[int]:
    """The reference's halving schedule: 10000, 5000, ..., >= floor
    (plade.cpp:607-633)."""
    ts = []
    t = cfg.ransac_init_min_support
    while t >= cfg.ransac_min_allowed_support:
        ts.append(t)
        t //= 2
    return ts


def _thresholds_on(cfg: PladeConfig, device) -> torch.Tensor:
    """``_support_thresholds`` as an int32 tensor made on ``device`` (the
    schedule is the initial support shifted right by 0, 1, 2, ...)."""
    n = len(_support_thresholds(cfg))
    shifts = torch.arange(n, dtype=torch.int64, device=device)
    init = torch.full((n,), cfg.ransac_init_min_support, dtype=torch.int64,
                      device=device)
    return torch.bitwise_right_shift(init, shifts).to(_I32)


def _use_graph(points: torch.Tensor) -> bool:
    """Whether the passes over ``points`` run as a CUDA graph: on a card,
    unless the caller's stream is already capturing (captures do not
    nest)."""
    if not points.is_cuda:
        return False
    with torch.cuda.device(points.device):
        return not torch.cuda.is_current_stream_capturing()


class _PassGraph:
    """One pass of the lockstep loop as a CUDA graph, for one extractor,
    stream, cloud count and floor support: ``advance(state, draws,
    *inputs) -> state`` over static buffers of the state, the clouds'
    inputs and the draws.  A call loads its state and inputs
    (:meth:`load`), then steps (:meth:`step`): the graph's first pass runs
    eagerly (the warm-up) and captures the graph, every later one copies
    its draws in and replays it.  Each replay credits the pass's K3 launch
    to ``kernels/build.LAUNCHES``.  A call holds ``lock`` from its load
    until its results are copied out.  Every block of the graph's memory
    pool is freed by the end of the capture, and the pool returns to the
    allocator when the graph is dropped."""

    def __init__(self, advance, state: _State, inputs: tuple):
        self.advance = advance
        self.lock = threading.Lock()
        self.state = _State(*map(torch.empty_like, state))
        self.inputs = tuple(map(torch.empty_like, inputs))
        self.draws = None
        self.graph = None
        self.launches = []

    def load(self, state: _State, inputs: tuple) -> _State:
        for dst, src in zip((*self.state, *self.inputs), (*state, *inputs)):
            dst.copy_(src)
        return self.state

    def _pass(self):
        new = self.advance(self.state, self.draws, *self.inputs)
        for dst, src in zip(self.state, new):
            dst.copy_(src)

    def step(self, state: _State, drawn) -> _State:
        """The next pass of the static state; ``drawn`` holds, per draw
        field, the clouds' tensors."""
        if self.graph is None:
            self.draws = tuple(torch.stack(xs) for xs in drawn)
            # the warm-up: this pass eagerly, on the caller's stream, so that
            # nothing (a library handle, a kernel's first load) starts inside
            # the capture
            self._pass()
            graph = torch.cuda.CUDAGraph()
            # one capture at a time in the process; thread-local, since a
            # mesh's shards replay and run eagerly in threads of their own
            with _CAPTURE_LOCK, captured_launches() as launches, \
                    torch.cuda.graph(graph, stream=_capture_stream(),
                                     capture_error_mode="thread_local"):
                self._pass()
            self.graph, self.launches = graph, launches
        else:
            for dst, xs in zip(self.draws, drawn):
                torch.stack(xs, out=dst)
            self.graph.replay()
            credit_launches(self.launches)
        return self.state


#: per stream, its one pass graph with the graph's key (extractor's
#: pass, clouds, floor support): a mesh's shards replay at once, each on a
#: stream of its own, so they share neither a graph's buffers nor its
#: pool, and one shard never drops another's graph
_GRAPHS: dict = {}
_GRAPHS_LOCK = threading.Lock()
#: held by a capture: it synchronizes the device and empties the
#: allocator's cache first, and only one may be underway in a process
_CAPTURE_LOCK = threading.Lock()
#: per device, the side stream captures run on (not the default stream,
#: which cannot capture)
_CAPTURE_STREAMS: dict = {}


def _capture_stream() -> torch.cuda.Stream:
    """The current device's capture stream (under ``_CAPTURE_LOCK``)."""
    dev = torch.cuda.current_device()
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream()
    return _CAPTURE_STREAMS[dev]


def _pass_graph(advance, state: _State, inputs: tuple,
                floor_support: int) -> _PassGraph:
    """The current stream's pass graph of ``advance`` for ``state``'s
    clouds, made (not yet captured) on first use.  A stream keeps one
    graph: a new one takes the last one's place, whose memory pool returns
    to the allocator (the next capture empties its cache first).  So the
    graphs hold at most one round's working set a stream that extracts,
    what the eager loop needs at its peak; a caller that changes shapes on
    one stream captures at each change."""
    key = (advance, state.done.shape[0], floor_support)
    stream = torch.cuda.current_stream()
    with _GRAPHS_LOCK:
        held = _GRAPHS.get(stream)
        if held is None or held[0] != key:
            held = _GRAPHS[stream] = (key, _PassGraph(functools.partial(
                advance, floor_support=floor_support), state, inputs))
    return held[1]


def build_extract_fn(cfg: PladeConfig, num_points: int,
                     max_extract: int | None = None):
    """The extraction function for a fixed cloud size (see
    :func:`extract` inside)."""
    max_extract = max_extract or cfg.max_planes
    S = cfg.ransac_candidates_per_round
    S_cell = S // 2                       # 3-point locality-stratified draws
    S_seed = S - S_cell                   # seed-normal proposals
    C = cfg.ransac_pool
    L = cfg.ransac_levels
    grid = cfg.bitmap_grid
    log_overlook = math.log(cfg.ransac_overlook_prob)
    R_SUB = max(1, cfg.ransac_score_subset)
    T_SUB = max(1, cfg.ransac_trim_subset)
    D_SUB = max(R_SUB, cfg.ransac_draw_subset)
    A = min(cfg.ransac_exact_lanes, C)
    A_CHK = min(max(cfg.ransac_check_lanes, A), C)
    CONFLICT_FRAC = cfg.ransac_conflict_frac
    thr = cfg.ransac_normal_thresh
    n_draw = -(-num_points // D_SUB)

    def round_body(state: _State, drawn_now, rows, th_sched, points,
                   normals, valid, eps, bitmap_eps, extent,
                   floor_support: int) -> _State:
        """One greedy round of B clouds: every state field and every
        per-cloud input carries the leading cloud axis (``eps``,
        ``bitmap_eps``, ``extent``: (B,)); ``drawn_now`` is the round's
        draws stacked over the clouds; ``rows`` is ``arange(B)[:, None]``,
        the cloud index of a per-cloud gather or scatter."""
        dev = points.device
        B = points.shape[0]

        def take(x, idx):
            """``x[c, idx[c]]`` per cloud: x (B, M, ...), idx (B, k)."""
            return x[rows, idx]

        min_support = state.min_support
        # FLAT mode: acceptance and termination run against the largest
        # schedule level at which the planes so far already number >=
        # cfg.min_planes (the floor until then); see the reference
        if cfg.ransac_flat_support:
            pvalid = torch.arange(state.sizes.shape[1], device=dev) \
                < state.num_planes[:, None]
            cnt_th = torch.sum((state.sizes[:, None, :]
                                >= th_sched[None, :, None])
                               & pvalid[:, None, :], dim=2)
            okth = cnt_th >= cfg.min_planes
            support_now = torch.maximum(
                torch.where(torch.any(okth, dim=1),
                            th_sched[_first_true(okth)], min_support),
                min_support)
        else:
            support_now = min_support
        g, lvl, g2, g3 = drawn_now
        lvl = lvl.to(torch.int64)
        free = valid & ~state.assigned                          # (B, N)
        free_f = torch.clamp(torch.sum(free.to(_F32), dim=1), min=1.0)
        pts_sub = points[:, ::R_SUB]
        nrm_sub = normals[:, ::R_SUB]
        free_sub = free[:, ::R_SUB]

        # ---- candidate generation: S distinct uniform anchors among free
        # points (Gumbel top-k), half seed-normal proposals, half 3-point
        # draws from an adaptively weighted locality level
        scores = torch.where(free, g, -1.0)
        seeds = torch.sort(scores, dim=1, descending=True,
                           stable=True).indices[:, :S]
        anchor_n = _normalize(take(normals, seeds))             # (B, S, 3)
        anchor_p = take(points, seeds)
        anchor_free = take(free, seeds)

        seed_n = anchor_n[:, :S_seed]
        seed_d = -torch.sum(seed_n * anchor_p[:, :S_seed], dim=-1)
        seed_ok = anchor_free[:, :S_seed]

        pts_draw = points[:, ::D_SUB]
        nrm_draw = normals[:, ::D_SUB]
        free_draw = free[:, ::D_SUB]
        ap = anchor_p[:, S_seed:]                            # (B, S_cell, 3)
        an = anchor_n[:, S_seed:]
        radius = extent[:, None] * (0.87 / (2.0 ** (lvl.to(_F32) + 1.0)))
        d2a = (torch.sum(pts_draw * pts_draw, dim=-1)[:, :, None]
               - 2.0 * (pts_draw @ ap.transpose(1, 2))
               + torch.sum(ap * ap, dim=-1)[:, None, :])  # (B, n_draw, S_cell)
        within = (d2a <= (radius * radius)[:, None, :]) \
            & free_draw[:, :, None]
        pick2 = torch.argmax(torch.where(within, g2[:, :, None], -1.0),
                             dim=1)
        pick3 = torch.argmax(torch.where(within, g3[:, :, None], -1.0),
                             dim=1)
        p2, p3 = take(pts_draw, pick2), take(pts_draw, pick3)
        crs = cross(p2 - ap, p3 - ap)
        cnorm = _norm(crs)[..., 0]
        cn = crs / torch.clamp(cnorm, min=_EPS)[..., None]
        nok = (torch.abs(torch.sum(cn * an, -1)) > thr) \
            & (torch.abs(torch.sum(cn * _normalize(take(nrm_draw, pick2)),
                                   -1)) > thr) \
            & (torch.abs(torch.sum(cn * _normalize(take(nrm_draw, pick3)),
                                   -1)) > thr)
        enough = torch.sum(within, dim=1) >= 3
        del d2a, within                    # (B, n_draw, S_cell): done with
        cell_ok = anchor_free[:, S_seed:] & enough & nok & (cnorm > 1e-10)
        cell_d = -torch.sum(cn * ap, dim=-1)

        cand_n = torch.cat([seed_n, cn], dim=1)                 # (B, S, 3)
        cand_d = torch.cat([seed_d, cell_d], dim=1)
        cand_ok = torch.cat([seed_ok, cell_ok], dim=1)

        K_ban = state.ban_n.shape[1]
        ban_live = torch.arange(K_ban, device=dev)[None, :] \
            < torch.clamp(state.ban_count, max=K_ban)[:, None]  # (B, K)

        def banned_mask(nmat, dvec):
            dots = nmat @ state.ban_n.transpose(1, 2)            # (B, ., K)
            sgn = torch.sign(dots + 1e-30)
            dd = torch.abs(dvec[:, :, None] * sgn - state.ban_d[:, None, :])
            thr_dot = torch.where(state.ban_loose, 0.995, 0.999)[:, None, :]
            thr_dd = torch.where(state.ban_loose, 6.0, 3.0)[:, None, :] \
                * eps[:, None, None]
            near = (torch.abs(dots) > thr_dot) & (dd < thr_dd)
            return torch.any(near & ban_live[:, None, :], dim=2)

        cand_drawn = cand_ok            # pre-ban: feeds the drawn counter
        cand_ok = cand_ok & ~banned_mask(cand_n, cand_d)

        # ---- subset scoring of fresh candidates and pool entries
        def inlier_counts(pts, nrms, fr, nmat, dvec):
            # the round's largest tensors (B, N / R_SUB, S + C): each
            # computed in place and dropped once compared, the same values
            # in a third of the memory (a pass graph's pool holds the
            # round's peak)
            dd = (pts @ nmat.transpose(1, 2)).add_(dvec[:, None, :]).abs_()
            ok = dd < eps[:, None, None]
            del dd
            ok &= (nrms @ nmat.transpose(1, 2)).abs_() > thr
            ok &= fr[:, :, None]
            return torch.sum(ok, dim=1, dtype=_I32)

        all_n = torch.cat([cand_n, state.pool_n], dim=1)     # (B, S+C, 3)
        all_d = torch.cat([cand_d, state.pool_d], dim=1)
        all_ok = torch.cat([cand_ok, state.pool_valid], dim=1)
        all_dormant = torch.cat([
            torch.zeros((B, S), dtype=torch.bool, device=dev),
            state.pool_dormant], dim=1)
        all_exact = torch.cat([torch.zeros((B, S), dtype=_I32, device=dev),
                               state.pool_exact], dim=1)
        all_ok = all_ok & (~banned_mask(all_n, all_d) | all_dormant)
        counts = torch.where(
            all_ok, inlier_counts(pts_sub, nrm_sub, free_sub, all_n, all_d)
            * R_SUB, 0)

        # ---- sampling-level reweighting (UpdateLevelWeights, factor .5)
        contrib = torch.where(cell_ok, counts[:, S_seed:S].to(_F32), 0.0)
        level_scores = torch.zeros((B, L), dtype=_F32, device=dev) \
            .scatter_add_(1, lvl, contrib)
        probs = state.level_probs
        raw = torch.where(probs > 1e-9,
                          level_scores / torch.clamp(probs, min=1e-9), 0.0)
        mixed = 0.9 * raw + 0.1 * torch.sum(raw, dim=1, keepdim=True) / L
        msum = torch.sum(mixed, dim=1, keepdim=True)
        normed = torch.where(msum > 0, mixed / torch.clamp(msum, min=1e-9),
                             torch.full((B, L), 1.0 / L, device=dev))
        new_level_probs = 0.5 * probs + 0.5 * normed

        # ---- pool dedup: drop a candidate matching a STRONGER one (higher
        # estimate, ties by lower index) within the tight ban tolerance
        dup_dots = all_n @ all_n.transpose(1, 2)
        dup_dd = torch.abs(all_d[:, :, None] * torch.sign(dup_dots + 1e-30)
                           - all_d[:, None, :])
        dup_near = (torch.abs(dup_dots) > 0.999) \
            & (dup_dd < 3.0 * eps[:, None, None])
        SC = counts.shape[1]
        dup_key = counts.to(torch.int64) * SC \
            - torch.arange(SC, dtype=torch.int64, device=dev)
        stronger = dup_near & (dup_key[:, None, :] > dup_key[:, :, None]) \
            & all_ok[:, None, :]
        dup = torch.any(stronger, dim=2) & ~all_dormant
        all_ok = all_ok & ~dup
        counts = torch.where(all_ok, counts, 0)

        # ---- pool merge: keep the top C by estimate; dormancy rides along
        top_idx = torch.sort(counts, dim=1, descending=True, stable=True) \
            .indices[:, :C]
        top_counts = take(counts, top_idx)
        pool_n = take(all_n, top_idx)
        pool_d = take(all_d, top_idx)
        pool_valid = take(all_ok, top_idx) & (top_counts > 0)
        pool_dormant = take(all_dormant, top_idx)
        pool_exact = take(all_exact, top_idx)

        drawn = state.drawn + torch.sum(cand_drawn.to(_F32), dim=1)

        def log_pfail(k_f, dr):
            """log P_fail(k) per cloud: k_f (B, ...), dr broadcast to it."""
            ff = free_f.reshape((B,) + (1,) * (k_f.dim() - 1))
            p = torch.clamp(k_f / (4.0 * ff), 0.0, 0.999999)
            return dr * torch.log1p(-p)

        # ---- exact check lanes: the pool's top-A_CHK live estimates
        # rescored on ALL points
        lane_key = torch.where(pool_valid & ~pool_dormant, top_counts, -1)
        lane_top = torch.sort(lane_key, dim=1, descending=True, stable=True)
        lane_est = lane_top.values[:, :A_CHK]
        lane_sel = lane_top.indices[:, :A_CHK]
        lane_n = take(pool_n, lane_sel)                      # (B, A_CHK, 3)
        lane_d = take(pool_d, lane_sel)
        lane_live = lane_est > 0
        dd_l = torch.abs(points @ lane_n.transpose(1, 2) + lane_d[:, None, :])
        nd_l = torch.abs(normals @ lane_n.transpose(1, 2))
        Mmask = (dd_l < eps[:, None, None]) & (nd_l > thr) \
            & free[:, :, None]                               # (B, N, A_CHK)
        exact = torch.where(lane_live, torch.sum(Mmask, dim=1, dtype=_I32),
                            0)

        # priority = exact count descending (stable, as jnp.argsort)
        lane_order = torch.sort(-exact, dim=1, stable=True).indices
        lane_n = take(lane_n, lane_order)
        lane_d = take(lane_d, lane_order)
        lane_sel = take(lane_sel, lane_order)
        lane_live = take(lane_live, lane_order)
        exact = take(exact, lane_order)
        Mmask = torch.take_along_dim(Mmask, lane_order[:, None, :], dim=2)

        eligible = lane_live & (exact >= support_now[:, None]) \
            & (log_pfail(exact.to(_F32), drawn[:, None]) <= log_overlook)

        # ---- multi-accept: greedy selection of non-conflicting lanes
        Mf = Mmask.to(_F32)
        shared = Mf.transpose(1, 2) @ Mf                # (B, A_CHK, A_CHK)
        smaller = torch.minimum(exact[:, :, None], exact[:, None, :])
        conflict = shared > CONFLICT_FRAC * torch.clamp(smaller.to(_F32),
                                                        min=1.0)
        conflict &= ~torch.eye(A_CHK, dtype=torch.bool, device=dev)
        sel_lane = torch.zeros((B, A_CHK), dtype=torch.bool, device=dev)
        for a in range(A_CHK):
            clash = torch.any(sel_lane & conflict[:, a], dim=1)
            sel_lane[:, a] = eligible[:, a] & ~clash
        sel_i = sel_lane.to(_I32)
        sel_rank = torch.cumsum(sel_i, dim=1) - sel_i
        sel_lane = sel_lane & (sel_rank < A)

        # compact the <= A selected lanes into A slots, priority order kept
        slot = torch.sort(torch.where(
            sel_lane, torch.arange(A_CHK, device=dev), A_CHK),
            dim=1).values[:, :A]
        slot_ok = slot < A_CHK                                  # (B, A)
        slot_safe = torch.clamp(slot, max=A_CHK - 1)
        sel_n = take(lane_n, slot_safe)                         # (B, A, 3)
        sel_d = take(lane_d, slot_safe)
        back_idx = torch.where(slot_ok, slot_safe, A_CHK)

        # ---- refit selected lanes (Gaussian-gated LS)
        band_eps = (3.0 * eps)[:, None, None]

        def wscore_l(n_, d_):
            dd = torch.abs(points @ n_.transpose(1, 2) + d_[:, None, :])
            nd = torch.abs(normals @ n_.transpose(1, 2))
            comp = (dd < band_eps) & (nd > thr) & free[:, :, None]
            w = torch.exp(-dd * dd / ((2.0 / 9.0) * band_eps ** 2))
            return torch.sum(torch.where(comp, w, 0.0), dim=1)

        ln, ld, sc = sel_n, sel_d, wscore_l(sel_n, sel_d)
        for _ in range(cfg.ransac_refit_rounds):
            dd = torch.abs(points @ ln.transpose(1, 2) + ld[:, None, :])
            nd = torch.abs(normals @ ln.transpose(1, 2))
            band = (dd < band_eps) & (nd > thr) & free[:, :, None]
            n2, c2 = _fit_plane(points[:, None],
                                band.transpose(1, 2).to(_F32))
            n2 = torch.where(torch.sum(n2 * ln, -1, keepdim=True) < 0, -n2,
                             n2)
            d2 = -torch.sum(n2 * c2, dim=-1)
            sc2 = wscore_l(n2, d2)
            better = sc2 > sc
            ln = torch.where(better[..., None], n2, ln)
            ld = torch.where(better, d2, ld)
            sc = torch.maximum(sc2, sc)
        dd_f = torch.abs(points @ ln.transpose(1, 2) + ld[:, None, :])
        nd_f = torch.abs(normals @ ln.transpose(1, 2))
        inl = (dd_f < band_eps) & (nd_f > thr) & free[:, :, None]  # (B,N,A)

        # largest-connected-component trim per lane: one K3 launch over the
        # B x A lanes
        uvec, vvec = _plane_basis(ln)
        uv = torch.stack([points @ uvec.transpose(1, 2),
                          points @ vvec.transpose(1, 2)], dim=-1)
        kept = _largest_component_masks(uv, inl, bitmap_eps, grid, T_SUB,
                                        cfg.bitmap_cc_iters_tpu)  # (B, N, A)

        # exclusive assignment: each lane in priority order claims its kept
        # points not yet claimed by a previously accepted lane
        owner = torch.full(free.shape, A, dtype=_I32, device=dev)
        excl_support = torch.zeros((B, A), dtype=_I32, device=dev)
        ok_support = torch.zeros((B, A), dtype=torch.bool, device=dev)
        for a in range(A):
            my = kept[:, :, a] & slot_ok[:, a:a + 1] & (owner == A)
            cnt = torch.sum(my, dim=1, dtype=_I32)
            ok_a = slot_ok[:, a] & (cnt >= support_now)
            owner = torch.where(my & ok_a[:, None], a, owner)
            excl_support[:, a] = cnt
            ok_support[:, a] = ok_a
        excl = owner[:, :, None] == torch.arange(A, device=dev)
        ok_i = ok_support.to(_I32)
        rank = torch.cumsum(ok_i, dim=1) - ok_i
        room = max_extract - state.num_planes
        accept_lane = ok_support & (rank < room[:, None])
        n_acc = torch.sum(accept_lane, dim=1, dtype=_I32)

        # bans: trim-failed lanes (refit and pre-refit fits, loose) and
        # debunked lanes (tight); they clear on halving
        trim_fail_slot = slot_ok & ~ok_support                  # (B, A)
        no_chk = torch.zeros((B, A_CHK), dtype=torch.bool, device=dev)
        accept_chk = _set_drop(no_chk, rows, back_idx, accept_lane)
        trim_fail = _set_drop(no_chk, rows, back_idx, trim_fail_slot)
        debunked = lane_live & (exact < support_now[:, None])
        to_ban = trim_fail | debunked
        ban_src_n = _set_drop(lane_n, rows, back_idx, ln)
        ban_src_d = _set_drop(lane_d, rows, back_idx, ld)
        to_ban_i = to_ban.to(_I32)
        tf_rank = torch.cumsum(to_ban_i, dim=1) - to_ban_i
        ban_idx = torch.where(
            to_ban, torch.remainder(state.ban_count[:, None] + tf_rank,
                                    K_ban), K_ban)
        ban_n = _set_drop(state.ban_n, rows, ban_idx, ban_src_n)
        ban_d = _set_drop(state.ban_d, rows, ban_idx, ban_src_d)
        ban_loose = _set_drop(state.ban_loose, rows, ban_idx, trim_fail)
        ban_count = state.ban_count + torch.sum(to_ban_i, dim=1)
        tf_i = trim_fail_slot.to(_I32)
        tf2_rank = torch.cumsum(tf_i, dim=1) - tf_i
        ban_idx2 = torch.where(
            trim_fail_slot, torch.remainder(ban_count[:, None] + tf2_rank,
                                            K_ban), K_ban)
        ban_n = _set_drop(ban_n, rows, ban_idx2, sel_n)
        ban_d = _set_drop(ban_d, rows, ban_idx2, sel_d)
        ban_loose = _set_drop(ban_loose, rows, ban_idx2,
                              torch.ones_like(trim_fail_slot))
        ban_count = (ban_count + torch.sum(tf_i, dim=1)).to(_I32)

        # orient normals along the mean support-point normal
        mean_n = excl.to(_F32).transpose(1, 2) @ normals        # (B, A, 3)
        flip = torch.sum(mean_n * ln, dim=-1) < 0
        ln_o = torch.where(flip[..., None], -ln, ln)
        ld_o = torch.where(flip, -ld, ld)

        # commit all accepted lanes: plane ids in priority order
        pid = torch.where(accept_lane, state.num_planes[:, None] + rank,
                          max_extract)
        new_coeffs = _set_drop(state.coeffs, rows, pid,
                               torch.cat([ln_o, ld_o[..., None]], dim=-1))
        new_sizes = _set_drop(state.sizes, rows, pid, excl_support)
        acc_pt = torch.any(excl & accept_lane[:, None, :], dim=2)  # (B, N)
        new_assigned = state.assigned | acc_pt
        new_point_plane = torch.where(
            acc_pt, take(pid, torch.clamp(owner, max=A - 1).long()),
            state.point_plane)
        num_planes = state.num_planes + n_acc

        # pool bookkeeping: accepted and trim-failed lanes leave the pool;
        # debunked lanes turn dormant until the next halving
        drop = accept_chk | trim_fail
        pool_valid = _set(pool_valid, rows, lane_sel,
                          take(pool_valid, lane_sel) & ~drop)
        pool_dormant = _set(pool_dormant, rows, lane_sel,
                            take(pool_dormant, lane_sel) | debunked)
        pool_exact = _set(pool_exact, rows, lane_sel,
                          torch.where(debunked, exact,
                                      take(pool_exact, lane_sel)))

        # drawn decays per acceptance, sequentially against a shrinking
        # free count
        free_rem = free_f
        dec_prod = torch.ones((B,), dtype=_F32, device=dev)
        for a in range(A):
            k_a = excl_support[:, a].to(_F32)
            base = 1.0 - torch.clamp(k_a / torch.clamp(free_rem, min=1.0),
                                     max=0.999)
            factor = torch.where(accept_lane[:, a], base * base * base, 1.0)
            dec_prod = dec_prod * factor
            free_rem = free_rem - torch.where(accept_lane[:, a], k_a, 0.0)
        drawn = drawn * dec_prod

        # ---- overlook-probability termination / auto-tune halving
        pending_lane = torch.any(eligible & ~accept_chk & ~trim_fail,
                                 dim=1) \
            | torch.any(lane_live & (exact >= support_now[:, None])
                        & ~eligible & ~accept_chk & ~trim_fail, dim=1)
        # the value a tensor on the device: a Python scalar would be copied
        # from the host, which a graph's capture refuses
        in_lanes = _set(torch.zeros((B, C), dtype=torch.bool, device=dev),
                        rows, lane_sel, torch.ones_like(lane_sel,
                                                        dtype=torch.bool))
        ms_f = support_now.to(_F32)
        est_lcb = ms_f - torch.sqrt(torch.clamp(ms_f, min=1.0) * R_SUB)
        pending_pool = torch.any(pool_valid & ~pool_dormant & ~in_lanes
                                 & (top_counts.to(_F32) >= est_lcb[:, None]),
                                 dim=1)
        pending = pending_lane | pending_pool
        n_free_now = torch.sum(free, dim=1, dtype=_I32) \
            - torch.sum(acc_pt, dim=1, dtype=_I32)
        no_room = n_free_now < support_now
        exh_cond = ((log_pfail(ms_f, drawn) <= log_overlook) | no_room) \
            & (n_acc == 0) & ~pending
        exh_streak = torch.where(exh_cond, state.exh_streak + 1, 0)
        exhausted = exh_streak >= (1 if cfg.ransac_flat_support else 2)
        need_more = num_planes < cfg.min_planes
        can_halve = (min_support > floor_support) \
            & (state.trials < cfg.ransac_max_trials)
        halve = exhausted & need_more & can_halve
        # level jump past halvings the evidence already excludes
        d_max = torch.amax(torch.where(pool_valid & pool_dormant, pool_exact,
                                       0), dim=1)
        new_support = torch.clamp(torch.div(min_support, 2,
                                            rounding_mode="floor"),
                                  min=floor_support)
        for _ in range(6):
            skippable = (log_pfail(new_support.to(_F32), drawn)
                         <= log_overlook) \
                & (new_support > d_max) & (new_support > floor_support)
            new_support = torch.where(
                halve & skippable,
                torch.clamp(torch.div(new_support, 2, rounding_mode="floor"),
                            min=floor_support), new_support)
        new_support = torch.where(halve, new_support, min_support)
        pool_dormant = pool_dormant & ~halve[:, None]
        rounds = state.rounds + 1
        done = (exhausted & ~(need_more & can_halve)) \
            | (num_planes >= max_extract) \
            | (rounds >= cfg.ransac_max_rounds)
        return _State(
            assigned=new_assigned,
            point_plane=new_point_plane,
            coeffs=new_coeffs,
            sizes=new_sizes,
            num_planes=num_planes.to(_I32),
            min_support=new_support.to(_I32),
            drawn=drawn,
            trials=torch.where(halve, state.trials + 1, state.trials),
            exh_streak=torch.where(halve, 0, exh_streak).to(_I32),
            rounds=rounds.to(_I32),
            pool_n=pool_n,
            pool_d=pool_d,
            pool_valid=pool_valid,
            pool_dormant=pool_dormant,
            pool_exact=torch.where(halve[:, None], 0, pool_exact),
            level_probs=new_level_probs,
            ban_n=ban_n,
            ban_d=ban_d,
            ban_loose=ban_loose,
            ban_count=torch.where(halve, 0, ban_count).to(_I32),
            done=done,
        )

    def advance(state: _State, drawn_now, rows, th_sched, points, normals,
                valid, eps, bitmap_eps, extent, floor_support: int) -> _State:
        """One pass of the lockstep loop: :func:`round_body`, with every
        cloud already done frozen, its state left as it was.  The freeze
        is applied whether or not a cloud is done (on none it is the
        round's state, bit for bit), so that a pass has one form."""
        new = round_body(state, drawn_now, rows, th_sched, points, normals,
                         valid, eps, bitmap_eps, extent, floor_support)
        B = points.shape[0]
        return _State(*(torch.where(
            state.done.reshape((B,) + (1,) * (o.dim() - 1)), o, n)
            for o, n in zip(state, new)))

    def extract(points, normals, count, floor_support: int,
                generator=None, draws=None, init_support: int | None = None):
        """points/normals: (N, 3) BIG-padded tensors, count: () int32 — or
        (B, N, 3), (B, N, 3) and (B,) for B clouds extracted in lockstep,
        with ``generator`` and ``draws`` then lists of one per cloud.

        Returns (PlaneSet padded to ``max_extract`` planes in greedy order,
        ExtractStats), with the leading cloud axis when the inputs have it.
        The support threshold starts at ``init_support`` (by default the
        floor in flat-support mode, else the reference's 10000,
        ``cfg.ransac_init_min_support``; never below the floor), and halves
        down to ``floor_support`` while fewer than ``cfg.min_planes``
        planes exist and the overlook bound says nothing of the current
        support remains.  A cloud's draws come from its ``draws`` or, by
        default, from its ``generator`` (a fresh one seeded with the
        cloud's index on the points' device when neither is given)."""
        single = points.dim() == 2
        if single:
            points, normals = points[None], normals[None]
            generator, draws = [generator], [draws]
        dev = points.device
        B = points.shape[0]
        generator = generator or [None] * B
        draws = list(draws or [None] * B)
        if not len(generator) == len(draws) == B:
            raise ValueError(f"extract: {B} clouds, {len(generator)} "
                             f"generators, {len(draws)} draws")
        for c in range(B):
            if draws[c] is None:
                gen = generator[c]
                if gen is None:
                    gen = torch.Generator(device=dev).manual_seed(c)
                draws[c] = generator_draws(gen, num_points, S_cell, n_draw)
        if init_support is None:
            init_support = (cfg.ransac_min_allowed_support
                            if cfg.ransac_flat_support
                            else cfg.ransac_init_min_support)
        count = torch.as_tensor(count, device=dev).reshape(B)
        valid = torch.arange(num_points, device=dev)[None, :] \
            < count[:, None]
        safe_pts = torch.where(valid[..., None], points, 0.0)
        pmin = torch.amin(torch.where(valid[..., None], points, 1e30), dim=1)
        pmax = torch.amax(torch.where(valid[..., None], points, -1e30),
                          dim=1)
        scale = torch.amax(pmax - pmin, dim=1)   # PointCloud::getScale
        eps = cfg.ransac_dist_thresh * scale
        bitmap_eps = cfg.ransac_bitmap_reso * scale

        def zeros(*shape, dtype=_F32):
            return torch.zeros((B,) + shape, dtype=dtype, device=dev)

        def full(value, dtype=_I32):
            return torch.full((B,), value, dtype=dtype, device=dev)

        state = _State(
            assigned=zeros(num_points, dtype=torch.bool),
            point_plane=torch.full((B, num_points), -1, dtype=_I32,
                                   device=dev),
            coeffs=zeros(max_extract, 4),
            sizes=zeros(max_extract, dtype=_I32),
            num_planes=full(0),
            min_support=full(max(int(init_support), int(floor_support))),
            drawn=full(0.0, _F32),
            trials=full(0),
            exh_streak=full(0),
            rounds=full(0),
            pool_n=zeros(C, 3),
            pool_d=zeros(C),
            pool_valid=zeros(C, dtype=torch.bool),
            pool_dormant=zeros(C, dtype=torch.bool),
            pool_exact=zeros(C, dtype=_I32),
            level_probs=torch.full((B, L), 1.0 / L, dtype=_F32, device=dev),
            # the ban ring must outlast many rounds of wide-lane debunking
            ban_n=zeros(_BAN_RING, 3),
            ban_d=zeros(_BAN_RING),
            ban_loose=zeros(_BAN_RING, dtype=torch.bool),
            ban_count=full(0),
            done=full(False, torch.bool),
        )
        inputs = (torch.arange(B, device=dev)[:, None],
                  _thresholds_on(cfg, dev), safe_pts, normals, valid, eps,
                  bitmap_eps, scale)
        floor_support = int(floor_support)

        def loop(state, step):
            """The passes until every cloud is done: ``step(state,
            drawn)`` makes the next state from the round's draws (per
            field, the clouds' tensors).  Returns (the last state,
            passes, frozen cloud-passes)."""
            done = [False] * B
            last = [None] * B
            rounds = frozen = 0
            while True:
                with timing.stage("extract.round"):
                    # a cloud's draws see its own state; a done cloud draws
                    # no more (its last draws fill its slot, and its round
                    # is discarded)
                    with timing.stage("extract.draws"):
                        for c in range(B):
                            if not done[c]:
                                last[c] = draws[c](
                                    _State(*(f[c] for f in state)))
                    state = step(state, list(zip(*last)))
                    rounds += 1
                    frozen += sum(done)
                    with timing.stage("extract.done_read"):
                        done = host_value(state.done)
                if all(done):
                    return state, rounds, frozen

        def outputs(state):
            return (PlaneSet(coeffs=state.coeffs, sizes=state.sizes,
                             count=state.num_planes,
                             point_plane=state.point_plane),
                    ExtractStats(rounds=state.rounds, drawn=state.drawn,
                                 trials=state.trials,
                                 min_support=state.min_support))

        if _use_graph(points):
            with torch.cuda.device(dev):
                graph = _pass_graph(advance, state, inputs, floor_support)
                with graph.lock:
                    captures = int(graph.graph is None)
                    state, rounds, frozen = loop(graph.load(state, inputs),
                                                 graph.step)
                    # out of the static buffers, which the next call
                    # overwrites
                    planes, stats = (type(x)(*(f.clone() for f in x))
                                     for x in outputs(state))
            replayed = rounds - captures
        else:
            state, rounds, frozen = loop(state, lambda s, d: advance(
                s, tuple(map(torch.stack, d)), *inputs, floor_support))
            planes, stats = outputs(state)
            replayed = captures = 0
        timing.count("extract.rounds", rounds)
        timing.count("extract.cloud_rounds", B * rounds)
        timing.count("extract.frozen", frozen)
        timing.count("extract.graph_rounds", replayed)
        timing.count("extract.graph_captures", captures)
        if single:
            planes = PlaneSet(*(x[0] for x in planes))
            stats = ExtractStats(*(x[0] for x in stats))
        return planes, stats

    return extract


@functools.lru_cache(maxsize=8)
def make_extractor(cfg: PladeConfig, num_points: int,
                   max_extract: int | None = None):
    """The standalone extraction for a fixed cloud size,
    ``extract(points, normals, count, floor_support, generator=None,
    draws=None, init_support=None) -> (PlaneSet, ExtractStats)`` of
    :func:`build_extract_fn`, cached per config, cloud size and
    ``max_extract`` (the planes' buffer, ``cfg.max_planes`` by default)."""
    return build_extract_fn(cfg, num_points, max_extract)


def _cached_extractor(cfg: PladeConfig, num_points: int):
    """The pipeline's extractor: up to 64 planes, selected afterwards."""
    return make_extractor(cfg, num_points, 64)


def auto_extract(points, normals, count, cfg: PladeConfig, num_points: int,
                 generator: torch.Generator | None = None,
                 draws: Draws | None = None) -> PlaneSet:
    """Plane extraction with the reference's auto-tuning semantics
    (plade.cpp:602-635): extract greedily once with the floor support and
    up to 64 planes, then select the support threshold a posteriori with
    :func:`select_planes_device`."""
    extractor = _cached_extractor(cfg, num_points)
    planes, _ = extractor(points, normals, count,
                          cfg.ransac_min_allowed_support,
                          generator=generator, draws=draws)
    return select_planes_device(planes, cfg)


def _keep_largest(planes: PlaneSet, keep: torch.Tensor,
                  cfg: PladeConfig) -> PlaneSet:
    """The planes of ``keep``, at most ``cfg.max_planes`` (the largest by
    support, greedy order restored), padded to ``cfg.max_planes`` rows, with
    ``point_plane`` renumbered to them (-1 for points of a dropped
    plane).  Over a leading axis of clouds when ``planes`` has one."""
    single = planes.coeffs.dim() == 2
    if single:
        planes, keep = lift((planes, keep))
    coeffs0 = planes.coeffs
    dev = coeffs0.device
    B, P0 = coeffs0.shape[:2]
    P = cfg.max_planes
    sizes = planes.sizes
    order = torch.sort(-torch.where(keep, sizes, -1), stable=True).indices
    kept = order[:, :P]
    kept_valid = torch.gather(keep, 1, kept)
    kk = torch.sort(torch.where(kept_valid, kept, P0)).values
    if kk.shape[1] < P:
        kk = torch.cat([kk, torch.full((B, P - kk.shape[1]), P0,
                                       dtype=kk.dtype, device=dev)], dim=1)
    new_valid = kk < P0
    kk_safe = torch.clamp(kk, max=P0 - 1)
    coeffs = torch.where(new_valid[..., None], take(coeffs0, kk_safe), 0.0)
    out_sizes = torch.where(new_valid, torch.gather(sizes, 1, kk_safe), 0)
    remap = torch.full((B, P0 + 1), -1, dtype=_I32, device=dev)
    remap.scatter_(1, torch.where(new_valid, kk_safe, P0), torch.arange(
        P, dtype=_I32, device=dev).expand(B, P))
    pp = planes.point_plane
    new_pp = torch.where(pp >= 0, torch.gather(
        remap, 1, torch.clamp(pp, 0, P0).long()), -1)
    out = PlaneSet(coeffs=coeffs, sizes=out_sizes.to(_I32),
                   count=torch.sum(new_valid, dim=1, dtype=_I32),
                   point_plane=new_pp.to(_I32))
    return drop(out) if single else out


def select_planes_device(planes: PlaneSet, cfg: PladeConfig) -> PlaneSet:
    """Post-selection implementing the auto-tune support thresholds
    (plade.cpp:602-635) as masked reductions, with no host sync: the
    largest threshold of the halving schedule that leaves >= min_planes
    planes, then at most max_planes (the largest by support, greedy order
    kept).  It picks the planes of the reference's host-side
    ``select_planes`` and of its ``select_planes_device``.  One cloud's
    planes, or a leading axis of clouds, selected together."""
    dev = planes.coeffs.device
    sizes = planes.sizes
    valid = planes.mask
    th = _thresholds_on(cfg, dev)                                   # (T,)
    cnt = torch.sum((sizes[..., None, :] >= th[:, None])
                    & valid[..., None, :], dim=-1)             # (..., T)
    okth = cnt >= cfg.min_planes
    # a 1-element index: indexing with a 0-d tensor reads it on the host
    chosen = torch.where(torch.any(okth, dim=-1, keepdim=True),
                         th[_first_true(okth)[..., None]],
                         cfg.ransac_min_allowed_support)
    return _keep_largest(planes, valid & (sizes >= chosen), cfg)


def select_planes(planes: PlaneSet, cfg: PladeConfig) -> PlaneSet:
    """The reference's host-side ``select_planes`` on one cloud's PlaneSet
    of numpy arrays or tensors: :func:`select_planes_device` on them as
    tensors, the selected PlaneSet on the device of ``planes.coeffs`` (the
    CPU for numpy)."""
    return select_planes_device(
        PlaneSet(*(torch.as_tensor(x) for x in planes)), cfg)


def select_planes_pinned(planes: PlaneSet, cfg: PladeConfig) -> PlaneSet:
    """Selection for the pinned min-support overload (plade.cpp:583-599):
    no auto-tune threshold, every extracted plane is used (extraction ran
    with the pinned support as floor and start), cut only to the
    ``max_planes`` buffer (the largest by support, greedy order restored),
    on the device (the reference's is host-side numpy)."""
    return _keep_largest(planes, planes.mask, cfg)
