"""A cloud's average point spacing, as PLADE defines it (the C++
reference's util.cpp:1619-1648): at most ``samples`` query points taken at
a fixed stride, each query's ``k`` nearest points counted with the query
itself, the ``k - 1`` neighbour distances summed and divided by ``k``,
averaged over the queries."""
from __future__ import annotations

import torch

from .precision import expansion_d2


def _queries(points: torch.Tensor, samples: int) -> torch.Tensor:
    n = points.shape[0]
    step = max(n // samples, 1)
    idx = torch.arange(samples, device=points.device) * step
    return points[idx[idx < n]]


def average_spacing(points, k: int = 6, samples: int = 10000,
                    device="cpu", block: int = 256) -> float:
    """The spacing of ``points`` ((n, 3), the cloud's rows without
    padding) in float64 on ``device``."""
    p = torch.as_tensor(points).to(device=device, dtype=torch.float64)
    q = _queries(p, samples)
    pp = torch.sum(p * p, dim=-1)
    per = []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        # float64 leaves |q|^2 - 2 q.r + |r|^2 exact to ~1e-15 at these
        # scales, far below the squared spacing
        d2 = torch.clamp(torch.sum(qb * qb, dim=-1, keepdim=True)
                         - 2.0 * qb @ p.T + pp[None], min=0.0)
        d = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
        per.append(torch.sum(torch.sqrt(d[:, 1:]), dim=-1) / k)
    return float(torch.cat(per).mean())


def average_spacing_tf32(points, k: int = 6, samples: int = 10000,
                         device="cpu", block: int = 256) -> float:
    """The control: the same spacing with the distances' product in
    TF32."""
    p = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    q = _queries(p, samples)
    per = []
    for s in range(0, q.shape[0], block):
        d = torch.topk(expansion_d2(q[s:s + block], p), k, dim=-1,
                       largest=False, sorted=True).values
        per.append(torch.sum(torch.sqrt(d[:, 1:]), dim=-1) / k)
    return float(torch.cat(per).to(torch.float64).mean())
