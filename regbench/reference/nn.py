"""Nearest neighbours of sampled query rows, the answers of K2
(``nearest_neighbor``: per query the least squared distance to a reference
and its index) and K1 (``oriented_min_dist_sq``: the least squared
distance to a reference whose unit normal agrees, ``qn . rn >=
normal_cos``, +inf where none does).

Distances are float64 differences.  K1's normal test is its definition's
float32 test, the dot summed left to right, so that a reference whose dot
lies within a rounding of ``normal_cos`` is in or out as the float32
answer has it.  Rows are given as (pair, row) indices into a launch's
(P, Q, 3) queries, each against its own pair's (P, T, 3) references.
"""
from __future__ import annotations

import torch

from .precision import expansion_d2, tf32_matmul

INF = float("inf")


def _by_pair(rows: torch.Tensor):
    """(pair, row indices) for each pair that has sampled rows."""
    for p in torch.unique(rows[:, 0]).tolist():
        yield p, rows[rows[:, 0] == p, 1]


def k2_reference(q: torch.Tensor, r: torch.Tensor, rows: torch.Tensor,
                 index: torch.Tensor, block: int = 256):
    """For the sampled ``rows`` ((S, 2) pair, row) of a K2 launch on
    queries ``q`` (P, Q, 3) and references ``r`` (P, T, 3): float64 (the
    least squared distance, the squared distance to reference ``index``
    (S,) of that pair), each (S,)."""
    least = torch.empty(rows.shape[0], dtype=torch.float64, device=q.device)
    at = torch.empty_like(least)
    for p, idx in _by_pair(rows):
        sel = torch.nonzero(rows[:, 0] == p)[:, 0]
        refs = r[p].to(torch.float64)
        for s in range(0, idx.shape[0], block):
            qs = q[p, idx[s:s + block]].to(torch.float64)
            d2 = torch.sum((qs[:, None, :] - refs[None]) ** 2, dim=-1)
            out = sel[s:s + block]
            least[out] = d2.min(dim=-1).values
            at[out] = torch.gather(
                d2, 1, index[out].to(torch.int64)[:, None])[:, 0]
    return least, at


def k2_tf32(q: torch.Tensor, r: torch.Tensor, rows: torch.Tensor,
            block: int = 256):
    """The control's K2 answers for ``rows``: (least d2, index) from the
    expansion form with its product in TF32."""
    d = torch.empty(rows.shape[0], dtype=torch.float32, device=q.device)
    i = torch.empty(rows.shape[0], dtype=torch.int64, device=q.device)
    for p, idx in _by_pair(rows):
        sel = torch.nonzero(rows[:, 0] == p)[:, 0]
        for s in range(0, idx.shape[0], block):
            d2 = expansion_d2(q[p, idx[s:s + block]], r[p])
            v, j = d2.min(dim=-1)
            d[sel[s:s + block]] = v
            i[sel[s:s + block]] = j
    return d, i


def _dot32(qn: torch.Tensor, rn: torch.Tensor) -> torch.Tensor:
    """(S, T) float32 dots, summed left to right."""
    return (qn[:, 0:1] * rn[None, :, 0] + qn[:, 1:2] * rn[None, :, 1]) \
        + qn[:, 2:3] * rn[None, :, 2]


def k1_reference(q, qn, r, rn, normal_cos: float, rows: torch.Tensor,
                 block: int = 256) -> torch.Tensor:
    """float64 least squared distance to an agreeing reference for the
    sampled ``rows`` of a K1 launch, +inf where none agrees."""
    least = torch.empty(rows.shape[0], dtype=torch.float64, device=q.device)
    cos = torch.tensor(normal_cos, dtype=torch.float32, device=q.device)
    for p, idx in _by_pair(rows):
        sel = torch.nonzero(rows[:, 0] == p)[:, 0]
        refs = r[p].to(torch.float64)
        for s in range(0, idx.shape[0], block):
            take = idx[s:s + block]
            d2 = torch.sum((q[p, take].to(torch.float64)[:, None, :]
                            - refs[None]) ** 2, dim=-1)
            ok = _dot32(qn[p, take].to(torch.float32),
                        rn[p].to(torch.float32)) >= cos
            least[sel[s:s + block]] = torch.where(ok, d2, INF).min(
                dim=-1).values
    return least


def k1_tf32(q, qn, r, rn, normal_cos: float, rows: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """The control's K1 answers: distances and normal dots as TF32
    products."""
    d = torch.empty(rows.shape[0], dtype=torch.float32, device=q.device)
    for p, idx in _by_pair(rows):
        sel = torch.nonzero(rows[:, 0] == p)[:, 0]
        for s in range(0, idx.shape[0], block):
            take = idx[s:s + block]
            d2 = expansion_d2(q[p, take], r[p])
            ok = tf32_matmul(qn[p, take], rn[p].T) >= normal_cos
            d[sel[s:s + block]] = torch.where(ok, d2, INF).min(
                dim=-1).values
    return d


def relative_gap(value: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |value - ref| / ref over the rows (0 where both are 0 or
    both +inf; +inf where one is +inf and the other not)."""
    value = value.to(torch.float64)
    both_inf = torch.isinf(value) & torch.isinf(ref)
    diff = torch.where(both_inf, 0.0, torch.abs(value - ref))
    den = torch.clamp(torch.where(torch.isinf(ref), 1.0, ref), min=1e-30)
    gap = torch.where(diff == 0, 0.0, diff / den)
    return float(gap.max()) if gap.numel() else 0.0
