"""Blocked brute-force neighbour computations
(``plade_tpu/knn/bruteforce.py``).

``nearest_neighbor`` and ``min_dist_sq`` are K2 (``kernels/nn.py``): the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.
``average_spacing`` selects with an exact ``torch.topk`` where the
reference uses ``lax.approx_min_k``, which JAX also computes exactly off
the TPU.  It keeps the reference's |q|^2 - 2 q.r + |r|^2 distance form, so
that the spacing, from which every radius of the pipeline is derived,
rounds like the reference's.

Padding convention: invalid points sit at BIG, so they never enter any
neighbourhood and need no masks here.
"""
from __future__ import annotations

import torch

from ..kernels.nn import min_dist_sq, nearest_neighbor  # noqa: F401


def _block_dist_sq(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Q,3) x (B,3) -> (Q,B) squared distances, expansion form."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    rr = torch.sum(r * r, dim=-1)
    cross = q @ r.T
    return torch.clamp(qq - 2.0 * cross + rr[None, :], min=0.0)


def topk_dist_sq(queries: torch.Tensor, refs: torch.Tensor, k: int,
                 block: int = 512) -> torch.Tensor:
    """(Q, k) smallest squared distances (ascending), exact."""
    out = []
    for s in range(0, queries.shape[0], block):
        d = _block_dist_sq(queries[s:s + block], refs)
        out.append(torch.topk(d, k, dim=1, largest=False, sorted=True)
                   .values)
    return torch.cat(out, dim=0)


def average_spacing(points: torch.Tensor, mask: torch.Tensor, k: int = 6,
                    samples: int = 10000) -> torch.Tensor:
    """Average point spacing with the reference's quirks
    (util.cpp:1619-1648): strided sampling of <= ``samples`` query points,
    k-NN including the query itself, the k-1 neighbour distances divided
    by k.  Returns a 0-d float32 tensor."""
    count = torch.sum(mask.to(torch.int32))
    step = torch.clamp(count // samples, min=1)
    idx = torch.arange(samples, dtype=torch.int32, device=points.device) \
        * step
    sample_valid = idx < count
    idx = torch.minimum(idx, torch.clamp(count - 1, min=0))
    q = points[idx.to(torch.int64)]
    d = topk_dist_sq(q, points, k)          # d[:, 0] == 0 (self)
    per_sample = torch.sum(torch.sqrt(d[:, 1:]), dim=1) / k
    w = sample_valid.to(torch.float32)
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)
