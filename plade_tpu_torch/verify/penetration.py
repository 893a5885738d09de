"""Plane-penetration candidate filter (``plade_tpu/verify/penetration.py``,
AreTwoPlanesPenetrable, util.cpp:1279-1458).

Three phases: dense cheap geometry over all (candidate, source plane,
target plane) triples; compaction of the triples that need point counting
into a static test budget, each test walking its clipped segment with a
fixed number of samples; and a scatter of verdicts back to candidates.
Tests whose two planes both hold at most ``small_points`` points run over
sliced buffers, as in the reference.  The live-chunk loop is a Python loop
over the chunks that hold tests: one host sync per buffer tier.

Reference quirks kept: the pair-skip compares the normals' dot product
with the angle in radians (util.cpp:489); side 1 needs both counts >=
``min_points`` and side 2 only one; the imbalance ratio uses
min(pos, neg + 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.ops import nonzero_static
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
    """Dense geometry + compaction of the triples needing point counts."""
    C = R.shape[0]
    Ps = src_coeffs.shape[0]
    Pt = tgt_coeffs.shape[0]

    ns = src_coeffs[:, :3]
    ds = src_coeffs[:, 3]
    rn = torch.einsum("cij,pj->cpi", R, ns)                 # (C,Ps,3)
    rd = ds[None, :] - torch.einsum("cpi,ci->cp", rn, t)
    sc = torch.einsum("cij,pj->cpi", R, src_centers) + t[:, None, :]
    rcorners = torch.einsum("cij,pkj->cpki", R, src_corners) \
        + t[:, None, None, :]

    nt = tgt_coeffs[:, :3]
    dt = tgt_coeffs[:, 3]

    # skip: nearly-coincident matched pair (util.cpp:487-492, dot vs ANGLE)
    d_a = torch.abs(torch.einsum("qi,cpi->cpq", nt, sc) + dt[None, None, :])
    d_b = torch.abs(torch.einsum("cpi,qi->cpq", rn, tgt_centers)
                    + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    dotn = torch.einsum("cpi,qi->cpq", rn, nt)
    skip = (c2pd < length_threshold) & (dotn > angle_threshold)

    p1 = torch.cat([rn, rd[..., None]], dim=-1)             # (C,Ps,4)
    p1b = p1[:, :, None, :].expand(C, Ps, Pt, 4)
    p2b = torch.cat([nt, dt[:, None]], -1)[None, None, :, :] \
        .expand(C, Ps, Pt, 4)
    u, p0, line_ok = intersect_planes(p1b, p2b)

    q1 = rcorners[:, :, None, :, :].expand(C, Ps, Pt, 4, 3)
    q2 = tgt_corners[None, None, :, :, :].expand(C, Ps, Pt, 4, 3)
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
    need &= cand_valid[:, None, None] & src_pmask[None, :, None] \
        & tgt_pmask[None, None, :]

    flat = need.reshape(-1)
    total = C * Ps * Pt
    n_need = torch.sum(flat.to(torch.int32))
    idx = nonzero_static(flat, max_tests, total)
    ok = idx < total
    idx_safe = torch.clamp(idx, max=total - 1)
    ci = idx_safe // (Ps * Pt)
    si = (idx_safe // Pt) % Ps
    ti = idx_safe % Pt
    return PenTests(
        cand=ci.to(torch.int32), src=si.to(torch.int32),
        tgt=ti.to(torch.int32),
        start=start.reshape(total, 3)[idx_safe],
        direc=direc.reshape(total, 3)[idx_safe],
        length=length.reshape(total)[idx_safe],
        valid=ok,
        overflow=torch.clamp(n_need - max_tests, min=0).to(torch.int32),
    )


def _d2(a, b):
    """Batched squared distances (k,M,3) x (k,S,3) -> (k,M,S),
    |a|^2 - 2 a.b + |b|^2 form as in the reference."""
    aa = torch.sum(a * a, dim=-1)
    bb = torch.sum(b * b, dim=-1)
    cross = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp(aa[..., None] - 2.0 * cross + bb[:, None, :], min=0.0)


def run_tests(tests: PenTests, R, t,
              src_plane_pts, src_plane_counts,
              tgt_plane_pts, tgt_plane_counts,
              src_coeffs, tgt_coeffs,
              search_radius, min_points: int, min_distance,
              n_samples: int, chunk: int = 512, max_ratio: float = 5.0,
              small_points: int = 512):
    """The point-counting walk of each compacted test; returns per-test
    ``penetrable`` (K,) bool."""
    ns = src_coeffs[:, :3]
    ds = src_coeffs[:, 3]
    dev = R.device

    def one_chunk(src_pts, tgt_pts, cand, src, tgt, start, direc, length,
                  valid):
        Rt = R[cand]                                        # (k,3,3)
        tt = t[cand]
        cloud1 = torch.einsum("kij,kmj->kmi", Rt, src_pts[src]) \
            + tt[:, None, :]                                # (k,M,3)
        ar = torch.arange(cloud1.shape[1], device=dev)[None, :]
        m1 = ar < src_plane_counts[src][:, None]
        cloud2 = tgt_pts[tgt]                               # (k,M,3)
        m2 = ar < tgt_plane_counts[tgt][:, None]

        rn = torch.einsum("kij,kj->ki", Rt, ns[src])
        rd = ds[src] - torch.sum(rn * tt, -1)
        ntg = tgt_coeffs[tgt, :3]
        dtg = tgt_coeffs[tgt, 3]

        ks = torch.arange(n_samples, dtype=torch.float32, device=dev)
        s_pos = ks[None, :] * search_radius                 # (k,S)
        s_ok = s_pos < length[:, None]
        samples = start[:, None, :] + s_pos[..., None] * direc[:, None, :]

        def side(points, pmask, other, omask, pn, pd):
            # occupancy of the other cloud per sample (>= 2 within r/2)
            d2o = _d2(other, samples)                       # (k,M,S)
            occ = torch.sum((d2o <= (search_radius / 2) ** 2)
                            & omask[..., None], dim=1) >= 2
            sample_live = s_ok & occ
            d2p = _d2(points, samples)
            near = torch.any((d2p <= search_radius ** 2)
                             & sample_live[:, None, :], dim=2) & pmask
            signed = torch.einsum("kmi,ki->km", points, pn) + pd[:, None]
            pos = torch.sum((near & (signed > min_distance)).to(torch.int32),
                            1)
            neg = torch.sum((near & (signed < -min_distance))
                            .to(torch.int32), 1)
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

    K = tests.cand.shape[0]
    chunk = min(chunk, K)
    per_test = (tests.cand.to(torch.int64), tests.src.to(torch.int64),
                tests.tgt.to(torch.int64), tests.start, tests.direc,
                tests.length, tests.valid)

    M = src_plane_pts.shape[1]
    Ms = min(small_points, M)
    is_small = (src_plane_counts[per_test[1]] <= Ms) \
        & (tgt_plane_counts[per_test[2]] <= Ms)

    def run_group(sel, src_pts, tgt_pts):
        """Front-compact the selected tests, run the chunks that hold any
        (the reference loop is exactly as long as its live tests,
        util.cpp:450-511), and scatter verdicts back to test order."""
        n_sel = host_value(torch.sum(sel.to(torch.int32)))
        idx = nonzero_static(sel, K, K)
        safe = torch.clamp(idx, max=K - 1)
        g = [x[safe] for x in per_test]
        g[-1] = g[-1] & (idx < K)
        out = torch.zeros((K,), dtype=torch.bool, device=dev)
        for s in range(0, n_sel, chunk):
            out[s:s + chunk] = one_chunk(src_pts, tgt_pts,
                                         *(x[s:s + chunk] for x in g))
        pen = torch.zeros((K + 1,), dtype=torch.bool, device=dev)
        pen[idx] = out
        return pen[:K]

    pen = run_group(tests.valid & is_small, src_plane_pts[:, :Ms],
                    tgt_plane_pts[:, :Ms])
    pen |= run_group(tests.valid & ~is_small, src_plane_pts, tgt_plane_pts)
    return pen


def rejected_candidates(tests: PenTests, penetrable, num_candidates: int):
    """A candidate is rejected if any of its tests penetrates."""
    hits = torch.zeros(num_candidates, dtype=torch.int32,
                       device=penetrable.device).scatter_add_(
        0, tests.cand.to(torch.int64),
        (penetrable & tests.valid).to(torch.int32))
    return hits > 0
