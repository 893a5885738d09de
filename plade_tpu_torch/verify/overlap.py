"""Overlap scoring of candidate transforms (``plade_tpu/verify/overlap.py``,
ComputeOverlap, util.h:611-647).

Phase 1 scores every candidate against a dense dilated occupancy bitmap of
the target, a superset of the exact radius test, so its count bounds the
exact one from above.  Phase 2 counts exact (oriented) radius hits with K1
(or K2 for position-only overlap), chunk by chunk down the bound ranking,
until the best exact score meets the next chunk's bound.  That bound loop
is a Python loop with one host sync per chunk.
"""
from __future__ import annotations

import torch

from ..core.ops import scalar
from ..core.types import host_value
from ..kernels.nn import min_dist_sq, oriented_min_dist_sq


def build_occupancy(tgt_points, tmask, radius, grid: int = 256,
                    cell_divisor: int = 1):
    """Dense dilated occupancy bitmap of the target cloud.

    Returns (bitmap (grid^3,) bool, origin (3,), cell ()); the cell is
    ``radius / cell_divisor`` (stretched when the cloud spans more than
    ``grid`` cells) and the bitmap dilates by ``cell_divisor`` cells."""
    pmin = torch.amin(torch.where(tmask[:, None], tgt_points, 1e30), dim=0)
    pmax = torch.amax(torch.where(tmask[:, None], tgt_points, -1e30), dim=0)
    extent = torch.amax(pmax - pmin)
    cell = torch.maximum(scalar(radius, tgt_points.device) / cell_divisor,
                         extent / (grid - 1))
    ijk = torch.clamp(torch.floor((tgt_points - pmin) / cell)
                      .clamp(-1, grid).to(torch.int64), 0, grid - 1)
    flat = (ijk[:, 0] * grid + ijk[:, 1]) * grid + ijk[:, 2]
    occ = torch.zeros((grid ** 3 + 1,), dtype=torch.bool,
                      device=tgt_points.device)
    occ[torch.where(tmask, flat, grid ** 3)] = True
    occ3 = occ[:-1].reshape(grid, grid, grid)
    for _ in range(cell_divisor):
        for axis in range(3):
            fwd = torch.zeros_like(occ3)
            bwd = torch.zeros_like(occ3)
            fwd.narrow(axis, 0, grid - 1).copy_(occ3.narrow(axis, 1, grid - 1))
            bwd.narrow(axis, 1, grid - 1).copy_(occ3.narrow(axis, 0, grid - 1))
            occ3 = occ3 | fwd | bwd
    return occ3.reshape(-1), pmin, cell


def approx_overlap_counts(bitmap, origin, cell, R, t, src_points, smask,
                          grid: int = 256):
    """(C,) counts of source points whose dilated voxel test passes, for
    all candidates at once.  Out-of-grid queries are clamped to the
    boundary cells, not dropped (that keeps the test a superset)."""
    q = torch.einsum("cij,sj->csi", R, src_points) + t[:, None, :]
    ijk = torch.clamp(torch.floor((q - origin) / cell)
                      .clamp(-1, grid).to(torch.int64), 0, grid - 1)
    flat = (ijk[..., 0] * grid + ijk[..., 1]) * grid + ijk[..., 2]
    hit = bitmap[flat] & smask[None, :]
    return torch.sum(hit.to(torch.int32), dim=1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def exact_overlap_counts(R, t, src_points, smask, tgt_points, r2,
                         src_normals=None, tgt_normals=None,
                         normal_cos: float = 0.0):
    """Exact per-candidate inlier counts, R: (K,3,3), t: (K,3).  All K
    transformed source clouds go to the kernel as one query array; with
    ``normal_cos > 0`` a hit also needs a normal that agrees (K1),
    otherwise it is position-only (K2)."""
    K = R.shape[0]
    S = src_points.shape[0]
    q = (torch.einsum("kij,sj->ksi", R, src_points)
         + t[:, None, :]).reshape(K * S, 3).contiguous()
    if normal_cos > 0.0 and src_normals is not None \
            and tgt_normals is not None:
        qn = torch.einsum("kij,sj->ksi", R, _unit(src_normals)) \
            .reshape(K * S, 3).contiguous()
        d2 = oriented_min_dist_sq(q, qn, tgt_points,
                                  _unit(tgt_normals).contiguous(),
                                  normal_cos).reshape(K, S)
    else:
        d2 = min_dist_sq(q, tgt_points).reshape(K, S)
    return torch.sum(((d2 <= r2) & smask[None, :]).to(torch.int32), dim=1)


def overlap_scores(R, t, cand_valid, src_points, src_count,
                   tgt_points, tgt_count, inlier_distance,
                   plane_frac=None, face_weight: float = 0.2,
                   exact_k: int = 16, grid: int = 256,
                   src_normals=None, tgt_normals=None,
                   normal_cos: float = 0.0):
    """((C,) overlap ratios with an exact final argmax, (C,) phase-1
    ratios): phase 1 bounds every candidate's combined score
    ``face_weight * plane_frac + (1 - face_weight) * overlap`` from above,
    phase 2 evaluates exact overlap in chunks of ``exact_k`` down the bound
    ranking until no unevaluated candidate can win.  Unevaluated
    candidates return 0 overlap.  (The reference returns the phase-1
    ratios only with ``return_approx=True``; its one caller sets it.)"""
    C = R.shape[0]
    dev = R.device
    tmask = torch.arange(tgt_points.shape[0], device=dev) < tgt_count
    smask = torch.arange(src_points.shape[0], device=dev) < src_count
    r = scalar(inlier_distance, dev)
    bitmap, origin, cell = build_occupancy(tgt_points, tmask, r, grid,
                                           cell_divisor=2)
    counts = approx_overlap_counts(bitmap, origin, cell, R, t,
                                   src_points, smask, grid)
    denom = torch.clamp(torch.minimum(src_count, tgt_count), min=1) \
        .to(torch.float32)
    approx = counts.to(torch.float32) / denom
    pf = torch.zeros(C, dtype=torch.float32, device=dev) \
        if plane_frac is None else plane_frac
    fw = 0.0 if plane_frac is None else face_weight
    bound = fw * pf + (1.0 - fw) * approx
    bound = torch.where(cand_valid, bound, -float("inf"))

    K = min(exact_k, C)
    nchunks = (C + K - 1) // K
    order = torch.sort(-bound, stable=True).indices         # desc by bound
    pad = nchunks * K - C
    order_p = torch.cat([order, torch.zeros(pad, dtype=order.dtype,
                                            device=dev)])
    bound_sorted = torch.cat([bound[order],
                              torch.full((pad + K,), -float("inf"),
                                         device=dev)])
    out = torch.zeros(C, dtype=torch.float32, device=dev)
    best = scalar(-float("inf"), dev)
    live_k = torch.arange(K, device=dev)
    i = 0
    while i < nchunks and host_value(best < bound_sorted[i * K]):
        sel = order_p[i * K:(i + 1) * K]
        exact = exact_overlap_counts(R[sel], t[sel], src_points, smask,
                                     tgt_points, r * r,
                                     src_normals=src_normals,
                                     tgt_normals=tgt_normals,
                                     normal_cos=normal_cos)
        ovr = exact.to(torch.float32) / denom
        # padded slots alias candidate 0 with an identical value
        out[sel] = torch.where(cand_valid[sel], ovr, 0.0)
        combined = torch.where(cand_valid[sel],
                               fw * pf[sel] + (1.0 - fw) * ovr,
                               -float("inf"))
        combined = torch.where(live_k + i * K < C, combined, -float("inf"))
        best = torch.maximum(best, torch.amax(combined))
        i += 1
    return (torch.where(cand_valid, out, 0.0),
            torch.where(cand_valid, approx, 0.0))
