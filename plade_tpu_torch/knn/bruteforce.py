"""Blocked brute-force neighbour computations
(``plade_tpu/knn/bruteforce.py``).

``nearest_neighbor`` and ``min_dist_sq`` are K2 (``kernels/nn.py``): the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.
``average_spacing``'s top-k (:func:`topk_dist_sq`) is exact where the
reference uses ``lax.approx_min_k``, which JAX also computes exactly off
the TPU: K4 (``kernels/nn.py``, ``csrc/knn.cu``) for CUDA tensors, the
blocked ``torch.topk`` of :func:`topk_dist_sq_plain` for CPU tensors, the
same bits.  Both keep the reference's |q|^2 - 2 q.r + |r|^2 distance form,
so that the spacing, from which every radius of the pipeline is derived,
rounds like the reference's.

Padding convention: invalid points sit at BIG, so they never enter any
neighbourhood and need no masks here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.ops import scalar
from ..kernels import nn as kernels
from ..kernels.nn import min_dist_sq, nearest_neighbor, oriented_min_dist_sq


#: most elements of one (cloud, query, reference) distance block of
#: ``topk_dist_sq_plain``: 512 queries against 131072 references (one
#: default-size cloud) a block, and fewer queries a block for several clouds
_BLOCK_ELEMS = 512 * 131072


def _block_dist_sq(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3) x (..., B, 3) -> (..., Q, B) squared distances,
    expansion form."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    rr = torch.sum(r * r, dim=-1)
    cross = q @ r.transpose(-1, -2)
    return torch.clamp(qq - 2.0 * cross + rr[..., None, :], min=0.0)


def topk_block(queries: torch.Tensor, refs: torch.Tensor,
               block: int = 512) -> int:
    """The queries a block of :func:`topk_dist_sq_plain`: at most
    ``block``, fewer when the clouds' distance block would pass
    ``_BLOCK_ELEMS``.  It depends on the leading axes and the reference
    count, not on the query count, so a part of the queries keeps the whole
    call's blocks."""
    clouds = queries[..., 0, 0].numel()
    return max(1, min(block, _BLOCK_ELEMS // max(1, clouds
                                                 * refs.shape[-2])))


def topk_dist_sq_plain(queries: torch.Tensor, refs: torch.Tensor, k: int,
                       block: int = 512) -> torch.Tensor:
    """(..., Q, k) smallest squared distances (ascending), exact, for
    queries (..., Q, 3) against refs (..., T, 3), in blocks of
    :func:`topk_block` queries: K4's plain version."""
    block = topk_block(queries, refs, block)
    out = []
    for s in range(0, queries.shape[-2], block):
        d = _block_dist_sq(queries[..., s:s + block, :], refs)
        out.append(torch.topk(d, k, dim=-1, largest=False, sorted=True)
                   .values)
    return torch.cat(out, dim=-2)


def topk_dist_sq(queries: torch.Tensor, refs: torch.Tensor, k: int,
                 block: int = 512) -> torch.Tensor:
    """(..., Q, k) smallest squared distances (ascending), exact, for
    queries (..., Q, 3) against refs (..., T, 3): K4 for tensors on a card
    (``block`` unused), :func:`topk_dist_sq_plain` for CPU tensors."""
    if queries.device.type == "cpu" and refs.device.type == "cpu":
        return topk_dist_sq_plain(queries, refs, k, block)
    return kernels.topk_dist_sq(queries, refs, k)


class NNPasses(NamedTuple):
    """The nearest-neighbour passes of a pair's step, with the signatures
    of the functions of :data:`ONE_DEVICE`; ``dist.intra.on_group`` gives
    the ones that split their queries over a group of devices."""
    min_dist_sq: Callable
    oriented_min_dist_sq: Callable
    nearest_neighbor: Callable
    topk_dist_sq: Callable


#: every pass as one call on its inputs' device
ONE_DEVICE = NNPasses(min_dist_sq, oriented_min_dist_sq, nearest_neighbor,
                      topk_dist_sq)


def average_spacing(points: torch.Tensor, mask: torch.Tensor, k: int = 6,
                    samples: int = 10000,
                    nn: NNPasses = ONE_DEVICE) -> torch.Tensor:
    """Average point spacing with the reference's quirks
    (util.cpp:1619-1648): strided sampling of <= ``samples`` query points,
    k-NN including the query itself, the k-1 neighbour distances divided
    by k.  points (N, 3), mask (N,) -> a 0-d float32 tensor; or per cloud
    (B, N, 3), (B, N) -> (B,).  The top-k is ``nn``'s."""
    count = torch.sum(mask.to(torch.int32), dim=-1, keepdim=True)
    step = torch.clamp(count // samples, min=1)
    idx = torch.arange(samples, dtype=torch.int32, device=points.device) \
        * step
    sample_valid = idx < count
    idx = torch.minimum(idx, torch.clamp(count - 1, min=0))
    q = torch.gather(points, -2, idx.to(torch.int64)[..., None]
                     .expand(idx.shape + (3,)))
    d = nn.topk_dist_sq(q, points, k)           # d[..., 0] == 0 (self)
    per_sample = torch.sum(torch.sqrt(d[..., 1:]), dim=-1) / k
    w = sample_valid.to(torch.float32)
    return torch.sum(per_sample * w, dim=-1) / torch.clamp(
        torch.sum(w, dim=-1), min=1.0)


def count_within(queries: torch.Tensor, refs: torch.Tensor, radius,
                 block: int = 2048) -> torch.Tensor:
    """(..., Q) int32 count of the references within ``radius`` of each
    query, for queries (..., Q, 3) against refs (..., T, 3), in blocks of
    ``block`` references (the expansion form of :func:`topk_dist_sq`)."""
    r2 = scalar(radius, queries.device) ** 2
    count = torch.zeros(queries.shape[:-1], dtype=torch.int32,
                        device=queries.device)
    for s in range(0, refs.shape[-2], block):
        d = _block_dist_sq(queries, refs[..., s:s + block, :])
        count += torch.sum(d <= r2, dim=-1, dtype=torch.int32)
    return count
