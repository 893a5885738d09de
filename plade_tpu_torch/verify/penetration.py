"""Plane-penetration candidate filter (``plade_tpu/verify/penetration.py``,
AreTwoPlanesPenetrable, util.cpp:1279-1458).

Three phases: dense cheap geometry over all (candidate, source plane,
target plane) triples; compaction of the triples that need point counting
into a static test budget, each test walking its clipped segment with a
fixed number of samples; and a scatter of verdicts back to candidates.
Tests whose two planes both hold at most ``small_points`` points run over
sliced buffers, as in the reference.  The live-chunk loop is a Python loop
over the chunks that hold tests: one host sync per buffer tier.  Every
function takes one pair or a leading axis of pairs.

Reference quirks kept: the pair-skip compares the normals' dot product
with the angle in radians (util.cpp:489); side 1 needs both counts >=
``min_points`` and side 2 only one; the imbalance ratio uses
min(pos, neg + 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.ops import drop, flat_rows, lift, nonzero_static, per_pair, take
from ..core.types import host_value
from ..geometry.lines import intersect_planes
from ..geometry.transforms import normalize


def _clip_line_with_quad(u, p0, corners):
    """Intersect line (u, p0) with the 4 edges of the (..., 4, 3) quad.
    Returns (first two hit points (..., 2, 3), number of hits)."""
    nxt = torch.roll(corners, -1, dims=-2)
    e = normalize(nxt - corners)
    uu = u[..., None, :].expand(e.shape)
    pp = p0[..., None, :].expand(e.shape)
    not_parallel = torch.abs(torch.sum(uu * e, -1)) <= 0.9999
    w0 = pp - corners
    b = torch.sum(uu * e, -1)
    d = torch.sum(uu * w0, -1)
    f = torch.sum(e * w0, -1)
    denom = torch.clamp(1.0 - b * b, min=1e-9)
    s = (b * f - d) / denom
    tt = (f - b * d) / denom
    ip = 0.5 * (pp + s[..., None] * uu + corners + tt[..., None] * e)
    between = torch.sum((corners - ip) * (nxt - ip), -1) <= 0.0
    hit = not_parallel & between
    n_hits = torch.sum(hit.to(torch.int32), -1)
    rank = torch.cumsum(hit.to(torch.int32), dim=-1) - 1
    sel0 = (rank == 0) & hit
    sel1 = (rank == 1) & hit
    pt0 = torch.sum(torch.where(sel0[..., None], ip, 0.0), dim=-2)
    pt1 = torch.sum(torch.where(sel1[..., None], ip, 0.0), dim=-2)
    return torch.stack([pt0, pt1], dim=-2), n_hits


class PenTests(NamedTuple):
    cand: torch.Tensor     # (K,) int32 candidate index
    src: torch.Tensor      # (K,) int32 source plane
    tgt: torch.Tensor      # (K,) int32 target plane
    start: torch.Tensor    # (K, 3)
    direc: torch.Tensor    # (K, 3)
    length: torch.Tensor   # (K,)
    valid: torch.Tensor    # (K,) bool
    overflow: torch.Tensor  # () int32 — triples dropped beyond max_tests


def build_tests(R, t, cand_valid,
                src_coeffs, src_corners, src_centers, src_pmask,
                tgt_coeffs, tgt_corners, tgt_centers, tgt_pmask,
                length_threshold, angle_threshold, max_tests: int
                ) -> PenTests:
    """Dense geometry + compaction of the triples needing point counts.
    One pair, or a leading axis of P pairs on every input
    (``length_threshold`` a number or (P,)) and on every field of the
    result."""
    single = R.dim() == 3
    if single:
        (R, t, cand_valid, src_coeffs, src_corners, src_centers, src_pmask,
         tgt_coeffs, tgt_corners, tgt_centers, tgt_pmask) = lift(
            (R, t, cand_valid, src_coeffs, src_corners, src_centers,
             src_pmask, tgt_coeffs, tgt_corners, tgt_centers, tgt_pmask))
    B, C = R.shape[:2]
    Ps = src_coeffs.shape[1]
    Pt = tgt_coeffs.shape[1]
    length_threshold = per_pair(length_threshold, B, R.device)

    ns = src_coeffs[..., :3]
    ds = src_coeffs[..., 3]
    rn = torch.einsum("...cij,...pj->...cpi", R, ns)        # (B,C,Ps,3)
    rd = ds[:, None, :] - torch.einsum("...cpi,...ci->...cp", rn, t)
    sc = torch.einsum("...cij,...pj->...cpi", R, src_centers) \
        + t[:, :, None, :]
    rcorners = torch.einsum("...cij,...pkj->...cpki", R, src_corners) \
        + t[:, :, None, None, :]

    nt = tgt_coeffs[..., :3]
    dt = tgt_coeffs[..., 3]

    # skip: nearly-coincident matched pair (util.cpp:487-492, dot vs ANGLE)
    d_a = torch.abs(torch.einsum("...qi,...cpi->...cpq", nt, sc)
                    + dt[:, None, None, :])
    d_b = torch.abs(torch.einsum("...cpi,...qi->...cpq", rn, tgt_centers)
                    + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    dotn = torch.einsum("...cpi,...qi->...cpq", rn, nt)
    skip = (c2pd < length_threshold[:, None, None, None]) \
        & (dotn > angle_threshold)

    p1 = torch.cat([rn, rd[..., None]], dim=-1)             # (B,C,Ps,4)
    p1b = p1[:, :, :, None, :].expand(B, C, Ps, Pt, 4)
    p2b = torch.cat([nt, dt[..., None]], -1)[:, None, None, :, :] \
        .expand(B, C, Ps, Pt, 4)
    u, p0, line_ok = intersect_planes(p1b, p2b)

    q1 = rcorners[:, :, :, None, :, :].expand(B, C, Ps, Pt, 4, 3)
    q2 = tgt_corners[:, None, None, :, :, :].expand(B, C, Ps, Pt, 4, 3)
    pts1, n1 = _clip_line_with_quad(u, p0, q1)
    pts2, n2 = _clip_line_with_quad(u, p0, q2)
    clip_ok = (n1 == 2) & (n2 == 2)

    # overlap of the two clipped spans along the line (util.cpp:1353-1373)
    direc = normalize(pts1[..., 1, :] - pts1[..., 0, :])
    allpts = torch.cat([pts1, pts2], dim=-2)                # (...,4,3)
    proj = torch.sum((allpts - pts1[..., 0:1, :]) * direc[..., None, :], -1)
    order = torch.sort(proj, dim=-1, stable=True).indices
    tags = order // 2                                       # 0 = quad1
    overlap_ok = tags[..., 0] != tags[..., 1]
    lo = torch.take_along_dim(proj, order[..., 1:2], dim=-1)[..., 0]
    hi = torch.take_along_dim(proj, order[..., 2:3], dim=-1)[..., 0]
    start = pts1[..., 0, :] + lo[..., None] * direc
    length = hi - lo

    need = (~skip) & line_ok & clip_ok & overlap_ok
    need &= cand_valid[:, :, None, None] & src_pmask[:, None, :, None] \
        & tgt_pmask[:, None, None, :]

    total = C * Ps * Pt
    flat = need.reshape(B, total)
    n_need = torch.sum(flat.to(torch.int32), dim=1)
    idx = nonzero_static(flat, max_tests, total)
    ok = idx < total
    idx_safe = torch.clamp(idx, max=total - 1)
    ci = idx_safe // (Ps * Pt)
    si = (idx_safe // Pt) % Ps
    ti = idx_safe % Pt
    out = PenTests(
        cand=ci.to(torch.int32), src=si.to(torch.int32),
        tgt=ti.to(torch.int32),
        start=take(start.reshape(B, total, 3), idx_safe),
        direc=take(direc.reshape(B, total, 3), idx_safe),
        length=torch.gather(length.reshape(B, total), 1, idx_safe),
        valid=ok,
        overflow=torch.clamp(n_need - max_tests, min=0).to(torch.int32),
    )
    return drop(out) if single else out


def _d2(a, b):
    """Batched squared distances (..., M, 3) x (..., S, 3) -> (..., M, S),
    |a|^2 - 2 a.b + |b|^2 form as in the reference."""
    aa = torch.sum(a * a, dim=-1)
    bb = torch.sum(b * b, dim=-1)
    cross = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(aa[..., None] - 2.0 * cross + bb[..., None, :],
                       min=0.0)


def run_tests(tests: PenTests, R, t,
              src_plane_pts, src_plane_counts,
              tgt_plane_pts, tgt_plane_counts,
              src_coeffs, tgt_coeffs,
              search_radius, min_points: int, min_distance,
              n_samples: int, chunk: int = 512, max_ratio: float = 5.0,
              small_points: int = 512):
    """The point-counting walk of each compacted test; returns per-test
    ``penetrable`` (K,) bool, or (P, K) over a leading axis of P pairs
    (``search_radius`` and ``min_distance`` numbers or (P,)).  Each buffer
    tier runs the chunk count of the pair with the most live tests (one
    host read of the pairs' counts a tier); chunks past a pair's live
    count hold invalid tests, whose verdict is False."""
    single = R.dim() == 3
    if single:
        (tests, R, t, src_plane_pts, src_plane_counts, tgt_plane_pts,
         tgt_plane_counts, src_coeffs, tgt_coeffs) = lift(
            (tests, R, t, src_plane_pts, src_plane_counts, tgt_plane_pts,
             tgt_plane_counts, src_coeffs, tgt_coeffs))
    ns = src_coeffs[..., :3]
    ds = src_coeffs[..., 3]
    dev = R.device
    B, K = tests.cand.shape
    search_radius = per_pair(search_radius, B, dev)[:, None]
    min_distance = per_pair(min_distance, B, dev)[:, None]

    def one_chunk(src_pts, tgt_pts, cand, src, tgt, start, direc, length,
                  valid):
        Rt = take(R, cand)                                  # (B,k,3,3)
        tt = take(t, cand)
        cloud1 = torch.einsum("...kij,...kmj->...kmi", Rt,
                              take(src_pts, src)) \
            + tt[..., None, :]                              # (B,k,M,3)
        ar = torch.arange(cloud1.shape[-2], device=dev)
        m1 = ar < torch.gather(src_plane_counts, 1, src)[..., None]
        cloud2 = take(tgt_pts, tgt)                         # (B,k,M,3)
        m2 = ar < torch.gather(tgt_plane_counts, 1, tgt)[..., None]

        rn = torch.einsum("...kij,...kj->...ki", Rt, take(ns, src))
        rd = torch.gather(ds, 1, src) - torch.sum(rn * tt, -1)
        ntg = take(tgt_coeffs, tgt)
        dtg = ntg[..., 3]
        ntg = ntg[..., :3]

        ks = torch.arange(n_samples, dtype=torch.float32, device=dev)
        s_pos = ks * search_radius[..., None]               # (B,k,S)
        s_ok = s_pos < length[..., None]
        samples = start[..., None, :] + s_pos[..., None] * direc[..., None, :]
        r_occ = (search_radius / 2)[..., None, None] ** 2
        r_near = (search_radius ** 2)[..., None, None]
        min_d = min_distance[..., None]

        def side(points, pmask, other, omask, pn, pd):
            # occupancy of the other cloud per sample (>= 2 within r/2)
            d2o = _d2(other, samples)                       # (B,k,M,S)
            occ = torch.sum((d2o <= r_occ) & omask[..., None], dim=-2) >= 2
            sample_live = s_ok & occ
            d2p = _d2(points, samples)
            near = torch.any((d2p <= r_near)
                             & sample_live[..., None, :], dim=-1) & pmask
            signed = torch.einsum("...kmi,...ki->...km", points, pn) \
                + pd[..., None]
            pos = torch.sum((near & (signed > min_d)).to(torch.int32), -1)
            neg = torch.sum((near & (signed < -min_d)).to(torch.int32), -1)
            return pos, neg

        def ratio(pos, neg):
            return torch.maximum(pos, neg) / torch.clamp(
                torch.minimum(pos, neg + 1), min=1)

        # side 1: source points vs target plane (util.cpp:1383-1415)
        pos1, neg1 = side(cloud1, m1, cloud2, m2, ntg, dtg)
        side1 = (pos1 >= min_points) & (neg1 >= min_points) \
            & (ratio(pos1, neg1) <= max_ratio)
        # side 2: target points vs source plane (util.cpp:1417-1453)
        pos2, neg2 = side(cloud2, m2, cloud1, m1, rn, rd)
        side2 = ((pos2 >= min_points) | (neg2 >= min_points)) \
            & (ratio(pos2, neg2) <= max_ratio)
        return side1 & side2 & valid

    chunk = min(chunk, K)
    per_test = (tests.cand.to(torch.int64), tests.src.to(torch.int64),
                tests.tgt.to(torch.int64), tests.start, tests.direc,
                tests.length, tests.valid)

    M = src_plane_pts.shape[-2]
    Ms = min(small_points, M)
    is_small = (torch.gather(src_plane_counts, 1, per_test[1]) <= Ms) \
        & (torch.gather(tgt_plane_counts, 1, per_test[2]) <= Ms)

    def run_group(sel, src_pts, tgt_pts):
        """Front-compact each pair's selected tests, run the chunks that
        hold any test of some pair (the reference loop is exactly as long
        as its live tests, util.cpp:450-511), and scatter verdicts back to
        test order."""
        n_sel = max(host_value(torch.sum(sel.to(torch.int32), dim=1)))
        idx = nonzero_static(sel, K, K)
        safe = torch.clamp(idx, max=K - 1)
        g = [take(x, safe) for x in per_test]
        g[-1] = g[-1] & (idx < K)
        out = torch.zeros((B, K), dtype=torch.bool, device=dev)
        for s in range(0, n_sel, chunk):
            out[:, s:s + chunk] = one_chunk(
                src_pts, tgt_pts, *(x[:, s:s + chunk] for x in g))
        pen = torch.zeros((B * (K + 1),), dtype=torch.bool, device=dev)
        pen[flat_rows(idx, K + 1)] = out.reshape(-1)
        return pen.reshape(B, K + 1)[:, :K]

    pen = run_group(tests.valid & is_small, src_plane_pts[..., :Ms, :],
                    tgt_plane_pts[..., :Ms, :])
    pen |= run_group(tests.valid & ~is_small, src_plane_pts, tgt_plane_pts)
    return pen[0] if single else pen


def rejected_candidates(tests: PenTests, penetrable, num_candidates: int):
    """A candidate is rejected if any of its tests penetrates.  One pair,
    or a leading axis of pairs."""
    cand = tests.cand.to(torch.int64)
    hits = torch.zeros(cand.shape[:-1] + (num_candidates,),
                       dtype=torch.int32, device=penetrable.device) \
        .scatter_add_(-1, cand, (penetrable & tests.valid).to(torch.int32))
    return hits > 0
