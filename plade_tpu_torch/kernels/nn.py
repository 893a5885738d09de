"""Exact nearest-neighbour passes: the CUDA kernels and their plain versions.

``nearest_neighbor`` (K2) and ``oriented_min_dist_sq`` (K1) replace the
Pallas kernels of ``plade_tpu/kernels/nn.py``.  Each public function takes
CUDA tensors to its hand-written kernel (``csrc/nn.cu``) and CPU tensors to
its plain PyTorch version in this module; there is no fallback from one to
the other.  The plain versions use the kernels' difference form
``d2 = dx*dx + dy*dy + dz*dz`` (not the |q|^2 - 2 q.r + |r|^2 expansion)
and their tie rule (lowest index wins), and are blocked over references so
that the (Q, T) distance matrix is never materialised.  Both take either
one query set against one reference set or a leading axis of P pairs, each
pair's queries against that pair's references: one launch for all pairs.

``LAUNCHES`` (shared by every kernel module, defined in ``build``) counts
kernel launches per kernel, and nothing else: a run resets it and reads it
to show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, count_launch  # noqa: F401

#: elements of one (query, reference) block in the plain versions
_BLOCK_ELEMS = 1 << 22


def _ref_block(Q: int, T: int) -> int:
    return max(1, min(T, _BLOCK_ELEMS // max(Q, 1)))


def _d2(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3) x (..., B, 3) -> (..., Q, B) squared distances in
    difference form."""
    dx = q[..., 0:1] - r[..., None, :, 0]
    dy = q[..., 1:2] - r[..., None, :, 1]
    dz = q[..., 2:3] - r[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nearest_neighbor_plain(queries: torch.Tensor, refs: torch.Tensor):
    """Plain PyTorch K2: ((..., Q) min d2, (..., Q) int32 argmin, lowest
    index on ties), for (Q, 3) x (T, 3) or per pair (P, Q, 3) x (P, T, 3)."""
    Q, T = queries.shape[-2], refs.shape[-2]
    lead = queries.shape[:-2]
    best = torch.full(lead + (Q,), float("inf"), dtype=torch.float32,
                      device=queries.device)
    best_i = torch.zeros(lead + (Q,), dtype=torch.int32,
                         device=queries.device)
    B = _ref_block(queries[..., 0].numel(), T)
    for base in range(0, T, B):
        d2 = _d2(queries, refs[..., base:base + B, :])
        bi = torch.argmin(d2, dim=-1)         # first minimum on ties
        bd = torch.gather(d2, -1, bi[..., None])[..., 0]
        take = bd < best                      # earlier block wins ties
        best = torch.where(take, bd, best)
        best_i = torch.where(take, (bi + base).to(torch.int32), best_i)
    return best, best_i


def oriented_min_dist_sq_plain(queries, qnormals, refs, rnormals,
                               normal_cos: float) -> torch.Tensor:
    """Plain PyTorch K1: (..., Q) min d2 over references with
    ``qn . rn >= normal_cos``; +inf where none passes.  Shapes as
    :func:`nearest_neighbor_plain`'s."""
    Q, T = queries.shape[-2], refs.shape[-2]
    best = torch.full(queries.shape[:-2] + (Q,), float("inf"),
                      dtype=torch.float32, device=queries.device)
    cos = torch.full((), normal_cos, dtype=torch.float32,
                     device=queries.device)
    B = _ref_block(queries[..., 0].numel(), T)
    for base in range(0, T, B):
        rn = rnormals[..., base:base + B, :]
        dot = qnormals[..., 0:1] * rn[..., None, :, 0] \
            + qnormals[..., 1:2] * rn[..., None, :, 1] \
            + qnormals[..., 2:3] * rn[..., None, :, 2]
        d2 = _d2(queries, refs[..., base:base + B, :])
        d2 = torch.where(dot >= cos, d2, float("inf"))
        best = torch.minimum(best, d2.amin(dim=-1))
    return best


def _check(name: str, *tensors: torch.Tensor):
    """The device of ``tensors``: all float32, contiguous, on one device,
    and all (N, 3) or all (P, N, 3) with one P."""
    dev = tensors[0].device
    lead = tensors[0].shape[:-2]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.dim() not in (2, 3) or t.shape[-1] != 3 \
                or t.shape[:-2] != lead:
            raise ValueError(f"{name}: expected (N, 3) or (P, N, 3), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if max(t.numel() for t in tensors) >= 2 ** 31:
        raise ValueError(f"{name}: too many rows for 32-bit offsets")
    return dev


def _raise_on(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def nearest_neighbor(queries: torch.Tensor, refs: torch.Tensor):
    """Per query (min squared distance, int32 index of the nearest
    reference); ties go to the lowest index.  queries (Q, 3), refs (T, 3),
    or per pair queries (P, Q, 3) against that pair's refs (P, T, 3) (one
    launch for all pairs; indices within the pair's refs); float32,
    contiguous, on one device."""
    dev = _check("nearest_neighbor", queries, refs)
    if dev.type == "cpu":
        return nearest_neighbor_plain(queries, refs)
    if dev.type != "cuda":
        raise ValueError(f"nearest_neighbor: unsupported device {dev}")
    if refs.shape[-2] == 0:
        raise ValueError("nearest_neighbor: no reference points")
    from .build import library
    lead = queries.shape[:-2]
    P = lead[0] if lead else 1
    Q, T = queries.shape[-2], refs.shape[-2]
    d = torch.empty(lead + (Q,), dtype=torch.float32, device=dev)
    i = torch.empty(lead + (Q,), dtype=torch.int32, device=dev)
    # per query the (d2 bits, index) key the reference slices merge into;
    # freed on return while the kernels may still run, which is safe: the
    # caching allocator orders its reuse on this stream after them
    keys = torch.empty(lead + (Q,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().plade_nearest_neighbor(
            queries.data_ptr(), refs.data_ptr(), d.data_ptr(), i.data_ptr(),
            keys.data_ptr(), P, Q, T, stream)
    _raise_on("nearest_neighbor", err)
    count_launch("nearest_neighbor")
    return d, i


def reference_slices(Q: int, T: int, oriented: bool = False,
                     pairs: int = 1) -> int:
    """Number of reference slices a K2 launch (K1 with ``oriented``) of
    ``pairs`` pairs of Q queries against T references splits into on the
    current CUDA device (``csrc/nn.cu``)."""
    from .build import library
    return library().plade_nn_ref_slices(pairs, Q, T, int(oriented))


def min_dist_sq(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Per-query squared distance to the nearest reference point (K2)."""
    d, _ = nearest_neighbor(queries, refs)
    return d


def oriented_min_dist_sq(queries: torch.Tensor, qnormals: torch.Tensor,
                         refs: torch.Tensor, rnormals: torch.Tensor,
                         normal_cos: float) -> torch.Tensor:
    """Per query the squared distance to the nearest reference whose normal
    agrees (``qn . rn >= normal_cos``), +inf where none does.  All four
    tensors (N, 3), or per pair (P, N, 3) (one launch for all pairs),
    float32, contiguous, on one device."""
    dev = _check("oriented_min_dist_sq", queries, qnormals, refs, rnormals)
    if qnormals.shape != queries.shape or rnormals.shape != refs.shape:
        raise ValueError("oriented_min_dist_sq: normals must match points")
    if dev.type == "cpu":
        return oriented_min_dist_sq_plain(queries, qnormals, refs, rnormals,
                                          normal_cos)
    if dev.type != "cuda":
        raise ValueError(f"oriented_min_dist_sq: unsupported device {dev}")
    from .build import library
    lead = queries.shape[:-2]
    P = lead[0] if lead else 1
    Q, T = queries.shape[-2], refs.shape[-2]
    d = torch.empty(lead + (Q,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().plade_oriented_min_dist_sq(
            queries.data_ptr(), qnormals.data_ptr(), refs.data_ptr(),
            rnormals.data_ptr(), float(normal_cos), d.data_ptr(), P, Q, T,
            stream)
    _raise_on("oriented_min_dist_sq", err)
    count_launch("oriented_min_dist_sq")
    return d
