"""Pair-line descriptors (``plade_tpu/descriptors/pairlines.py``): the
live 8-D 2-2 family (``pair_descriptors``) and the degraded 6-D 22-21 /
22-12 families behind ``PladeConfig.enable_degraded_families``
(``degraded_descriptors``).

8-D layout (ComputeDescriptorVectorForPairLines, util.cpp:533-602):
[0] closest distance between the lines / scale, [1] newLine1 . newLine2,
[2] sp11 . sp12, [3] sp21 . sp22, [4] newLine1 . sp21,
[5] newLine1 . sp22, [6] newLine2 . sp11, [7] newLine2 . sp12.
"""
from __future__ import annotations

import torch

from ..core.ops import drop, lift, nonzero_static, per_pair, take
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


def _line_pairs(lines: LineSet, max_pairs: int, ordered: bool,
                min_angle_cos: float):
    """The retained line pairs of each of P line sets (leading axis),
    compacted to ``max_pairs`` rows: ordered=True keeps (i, j) and (j, i)
    (target side), ordered=False i<j only (query side); pairs with
    |u_i . u_j| > ``min_angle_cos`` are dropped.  Returns (in_range, ii,
    jj, count of all retained pairs), each with the leading axis."""
    P, L = lines.direction.shape[:2]
    u = lines.direction
    lmask = lines.mask
    cosang = torch.abs(u @ u.transpose(-1, -2))
    keep = lmask[:, :, None] & lmask[:, None, :]
    ar = torch.arange(L, device=u.device)
    if ordered:
        keep &= ar[:, None] != ar[None, :]
    else:
        keep &= ar[None, :] > ar[:, None]
    keep &= cosang <= min_angle_cos

    idx = nonzero_static(keep.reshape(P, L * L), max_pairs, L * L)
    in_range = idx < L * L
    idx_safe = torch.clamp(idx, max=L * L - 1)
    return (in_range, idx_safe // L, idx_safe % L,
            torch.sum(keep.reshape(P, L * L).to(torch.int32), dim=1))


def _support_normals(lines: LineSet, plane_normals, ii, jj):
    """Per retained pair, both lines' (direction, point, support plane
    normals (..., 2, 3))."""
    u, p = lines.direction, lines.point
    sp = take(plane_normals, lines.support.to(torch.int64))  # (P, L, 2, 3)
    return (take(u, ii), take(p, ii), take(sp, ii),
            take(u, jj), take(p, jj), take(sp, jj))


def pair_descriptors(lines: LineSet, plane_normals: torch.Tensor, scale,
                     max_pairs: int, ordered: bool, min_angle_cos: float,
                     pad_value: float = 1.0e6) -> PairDescriptors:
    """Descriptors for all retained line pairs (see :func:`_line_pairs`).
    One line set, or a leading axis of P (``scale`` then a number or
    (P,))."""
    single = lines.direction.dim() == 2
    if single:
        lines, plane_normals = lift((lines, plane_normals))
    P = lines.direction.shape[0]
    scale = per_pair(scale, P, lines.direction.device)[:, None]
    in_range, ii, jj, count = _line_pairs(lines, max_pairs, ordered,
                                          min_angle_cos)
    u1, p1, sp1, u2, p2, sp2 = _support_normals(lines, plane_normals, ii, jj)
    q1, _, dist = closest_points_two_lines(u1, p1, u2, p2)
    sp11, sp12 = _canonical(u2, sp1[..., 0, :], sp1[..., 1, :])
    sp21, sp22 = _canonical(u1, sp2[..., 0, :], sp2[..., 1, :])
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
    r = in_range[..., None]
    desc = torch.where(r, desc, pad_value)
    out = PairDescriptors(
        desc=desc,
        line_vec1=torch.where(r, new1, 0.0),
        line_vec2=torch.where(r, new2, 0.0),
        anchor=torch.where(r, q1, 0.0),
        line_idx=torch.where(r, torch.stack([ii, jj], dim=-1), 0)
        .to(torch.int32),
        count=torch.clamp(count, max=max_pairs).to(torch.int32),
    )
    return drop(out) if single else out


def degraded_descriptors(lines: LineSet, plane_normals: torch.Tensor, scale,
                         max_pairs: int, ordered: bool, min_angle_cos: float,
                         family: str, pad_value: float = 1.0e6
                         ) -> PairDescriptors:
    """Degraded 6-D descriptor families 22-21 / 22-12 of the retained line
    pairs (the reference package's, util.cpp:830-919, layouts
    util.cpp:578-593): one of a line's two support planes is replaced by
    the pseudo-plane ``lineVec x (+-plane)``.

    ``family``: "2221" degrades line 2 ([dist/scale, n1.n2, sp11.sp12,
    n1.real2, n2.sp11, n2.sp12]); "2212" degrades line 1 ([dist/scale,
    n1.n2, sp21.sp22, n1.sp21, n1.sp22, n2.real1]).  The target side
    (ordered=True) emits 4 variants a pair (either surviving plane x the
    pseudo sign), the query side 2.  Returns (max_pairs * variants) rows,
    variant-major.  One line set, or a leading axis of P, as
    :func:`pair_descriptors`."""
    if family not in ("2221", "2212"):
        raise ValueError(f"unknown degraded family {family!r}")
    single = lines.direction.dim() == 2
    if single:
        lines, plane_normals = lift((lines, plane_normals))
    P = lines.direction.shape[0]
    scale = per_pair(scale, P, lines.direction.device)[:, None]
    in_range, ii, jj, count = _line_pairs(lines, max_pairs, ordered,
                                          min_angle_cos)
    u1, p1, sp1, u2, p2, sp2 = _support_normals(lines, plane_normals, ii, jj)
    q1, _, dist = closest_points_two_lines(u1, p1, u2, p2)

    def dot(a, b):
        return torch.sum(a * b, -1)

    variants = [(0, 1.0), (1, 1.0), (0, -1.0), (1, -1.0)] if ordered \
        else [(0, 1.0), (1, 1.0)]
    rows = []
    for k, s in variants:
        if family == "2221":
            real = sp2[..., k, :]                           # line 2 survivor
            pseudo = cross(u2, s * real)
            sp11, sp12 = _canonical(u2, sp1[..., 0, :], sp1[..., 1, :])
            n21, n22 = _canonical(u1, real, pseudo)
            new1 = cross(sp11, sp12)
            new2 = cross(n21, n22)
            desc = torch.stack([
                dist / scale, dot(new1, new2), dot(sp11, sp12),
                dot(new1, real), dot(new2, sp11), dot(new2, sp12)], dim=-1)
        else:
            real = sp1[..., k, :]                           # line 1 survivor
            pseudo = cross(u1, s * real)
            n11, n12 = _canonical(u2, real, pseudo)
            sp21, sp22 = _canonical(u1, sp2[..., 0, :], sp2[..., 1, :])
            new1 = cross(n11, n12)
            new2 = cross(sp21, sp22)
            desc = torch.stack([
                dist / scale, dot(new1, new2), dot(sp21, sp22),
                dot(new1, sp21), dot(new1, sp22), dot(new2, real)], dim=-1)
        rows.append((desc, new1, new2))

    V = len(variants)
    r = in_range.repeat(1, V)[..., None]
    out = PairDescriptors(
        desc=torch.where(r, torch.cat([x[0] for x in rows], dim=1),
                         pad_value),
        line_vec1=torch.where(r, torch.cat([x[1] for x in rows], dim=1),
                              0.0),
        line_vec2=torch.where(r, torch.cat([x[2] for x in rows], dim=1),
                              0.0),
        anchor=torch.where(r, q1.repeat(1, V, 1), 0.0),
        line_idx=torch.where(r, torch.stack([ii, jj], dim=-1)
                             .repeat(1, V, 1), 0).to(torch.int32),
        count=(torch.clamp(count, max=max_pairs) * V).to(torch.int32),
    )
    return drop(out) if single else out
