"""Pair-line 8-D descriptors (``plade_tpu/descriptors/pairlines.py``,
``pair_descriptors`` only: the live 2-2 family).

Descriptor layout (ComputeDescriptorVectorForPairLines, util.cpp:533-602):
[0] closest distance between the lines / scale, [1] newLine1 . newLine2,
[2] sp11 . sp12, [3] sp21 . sp22, [4] newLine1 . sp21,
[5] newLine1 . sp22, [6] newLine2 . sp11, [7] newLine2 . sp12.
"""
from __future__ import annotations

import torch

from ..core.ops import nonzero_static
from ..core.types import LineSet, PairDescriptors
from ..geometry.lines import closest_points_two_lines
from ..geometry.transforms import cross


def _canonical(u_self, sp_a, sp_b):
    """Order (sp_a, sp_b) so |u_self . first| <= |u_self . second|."""
    swap = torch.abs(torch.sum(u_self * sp_a, -1)) \
        > torch.abs(torch.sum(u_self * sp_b, -1))
    first = torch.where(swap[..., None], sp_b, sp_a)
    second = torch.where(swap[..., None], sp_a, sp_b)
    return first, second


def pair_descriptors(lines: LineSet, plane_normals: torch.Tensor, scale,
                     max_pairs: int, ordered: bool, min_angle_cos: float,
                     pad_value: float = 1.0e6) -> PairDescriptors:
    """Descriptors for all retained line pairs: ordered=True builds (i, j)
    and (j, i) rows (target side), ordered=False i<j only (query side);
    pairs with |u_i . u_j| > ``min_angle_cos`` are dropped."""
    L = lines.direction.shape[0]
    dev = lines.direction.device
    u = lines.direction
    p = lines.point
    sup = lines.support.to(torch.int64)
    sp = plane_normals[sup]                                 # (L, 2, 3)

    lmask = lines.mask
    cosang = torch.abs(u @ u.T)
    keep = lmask[:, None] & lmask[None, :]
    ar = torch.arange(L, device=dev)
    if ordered:
        keep &= ar[:, None] != ar[None, :]
    else:
        keep &= ar[None, :] > ar[:, None]
    keep &= cosang <= min_angle_cos

    idx = nonzero_static(keep.reshape(-1), max_pairs, L * L)
    in_range = idx < L * L
    idx_safe = torch.clamp(idx, max=L * L - 1)
    ii = idx_safe // L
    jj = idx_safe % L
    count = torch.sum(keep.to(torch.int32))

    q1, _, dist = closest_points_two_lines(u[ii], p[ii], u[jj], p[jj])
    u1, u2 = u[ii], u[jj]
    sp11, sp12 = _canonical(u2, sp[ii, 0], sp[ii, 1])
    sp21, sp22 = _canonical(u1, sp[jj, 0], sp[jj, 1])
    new1 = cross(sp11, sp12)
    new2 = cross(sp21, sp22)

    def dot(a, b):
        return torch.sum(a * b, -1)

    desc = torch.stack([
        dist / scale,
        dot(new1, new2),
        dot(sp11, sp12),
        dot(sp21, sp22),
        dot(new1, sp21),
        dot(new1, sp22),
        dot(new2, sp11),
        dot(new2, sp12),
    ], dim=-1)
    # padded rows are pushed far away, with opposite signs on the query and
    # target sides, so they never fall inside the match radius
    desc = torch.where(in_range[:, None], desc, pad_value)
    r = in_range[:, None]
    return PairDescriptors(
        desc=desc,
        line_vec1=torch.where(r, new1, 0.0),
        line_vec2=torch.where(r, new2, 0.0),
        anchor=torch.where(r, q1, 0.0),
        line_idx=torch.where(r, torch.stack([ii, jj], dim=-1), 0)
        .to(torch.int32),
        count=torch.clamp(count, max=max_pairs).to(torch.int32),
    )
