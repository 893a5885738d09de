"""Overlap scoring of candidate transforms (``plade_tpu/verify/overlap.py``,
ComputeOverlap, util.h:611-647).

Phase 1 scores every candidate against a dense dilated occupancy bitmap of
the target, a superset of the exact radius test, so its count bounds the
exact one from above.  Phase 2 counts exact (oriented) radius hits with K1
(or K2 for position-only overlap), chunk by chunk down the bound ranking,
until the best exact score meets the next chunk's bound.  That bound loop
is a Python loop with one host sync per chunk.  Every function takes one
pair or a leading axis of pairs.
"""
from __future__ import annotations

import torch

from ..core.ops import drop, flat_rows, lift, per_pair, take
from ..core.types import host_value
from ..knn.bruteforce import ONE_DEVICE, NNPasses


def build_occupancy(tgt_points, tmask, radius, grid: int = 256,
                    cell_divisor: int = 1):
    """Dense dilated occupancy bitmap of the target cloud.

    Returns (bitmap (grid^3,) bool, origin (3,), cell ()); the cell is
    ``radius / cell_divisor`` (stretched when the cloud spans more than
    ``grid`` cells) and the bitmap dilates by ``cell_divisor`` cells.  With
    a leading axis of P pairs on the inputs (``radius`` a number or (P,))
    every output has it too."""
    single = tgt_points.dim() == 2
    if single:
        tgt_points, tmask = lift((tgt_points, tmask))
    P = tgt_points.shape[0]
    dev = tgt_points.device
    pmin = torch.amin(torch.where(tmask[..., None], tgt_points, 1e30), dim=1)
    pmax = torch.amax(torch.where(tmask[..., None], tgt_points, -1e30), dim=1)
    extent = torch.amax(pmax - pmin, dim=-1)
    cell = torch.maximum(per_pair(radius, P, dev) / cell_divisor,
                         extent / (grid - 1))
    ijk = torch.clamp(torch.floor((tgt_points - pmin[:, None, :])
                                  / cell[:, None, None])
                      .clamp(-1, grid).to(torch.int64), 0, grid - 1)
    flat = (ijk[..., 0] * grid + ijk[..., 1]) * grid + ijk[..., 2]
    G3 = grid ** 3
    occ = torch.zeros((P * (G3 + 1),), dtype=torch.bool, device=dev)
    occ[flat_rows(torch.where(tmask, flat, G3), G3 + 1)] = True
    occ3 = occ.reshape(P, G3 + 1)[:, :-1].reshape(P, grid, grid, grid)
    for _ in range(cell_divisor):
        for axis in range(1, 4):
            fwd = torch.zeros_like(occ3)
            bwd = torch.zeros_like(occ3)
            fwd.narrow(axis, 0, grid - 1).copy_(occ3.narrow(axis, 1, grid - 1))
            bwd.narrow(axis, 1, grid - 1).copy_(occ3.narrow(axis, 0, grid - 1))
            occ3 = occ3 | fwd | bwd
    out = (occ3.reshape(P, G3), pmin, cell)
    return drop(out) if single else out


def approx_overlap_counts(bitmap, origin, cell, R, t, src_points, smask,
                          grid: int = 256):
    """(C,) counts of source points whose dilated voxel test passes, for
    all candidates at once.  Out-of-grid queries are clamped to the
    boundary cells, not dropped (that keeps the test a superset).  (P, C)
    over a leading axis of P pairs when the inputs have one."""
    single = R.dim() == 3
    if single:
        bitmap, origin, cell, R, t, src_points, smask = lift(
            (bitmap, origin, cell, R, t, src_points, smask))
    q = torch.einsum("...cij,...sj->...csi", R, src_points) \
        + t[:, :, None, :]
    ijk = torch.clamp(torch.floor((q - origin[:, None, None, :])
                                  / cell[:, None, None, None])
                      .clamp(-1, grid).to(torch.int64), 0, grid - 1)
    flat = (ijk[..., 0] * grid + ijk[..., 1]) * grid + ijk[..., 2]
    hit = take(bitmap, flat) & smask[:, None, :]
    counts = torch.sum(hit.to(torch.int32), dim=-1)
    return counts[0] if single else counts


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def exact_overlap_counts(R, t, src_points, smask, tgt_points, r2,
                         src_normals=None, tgt_normals=None,
                         normal_cos: float = 0.0,
                         nn: NNPasses = ONE_DEVICE):
    """Exact per-candidate inlier counts, R: (K,3,3), t: (K,3), or with a
    leading axis of P pairs (``r2`` a number or (P,)).  All K transformed
    source clouds of every pair go to ``nn``'s kernel as one launch; with
    ``normal_cos > 0`` a hit also needs a normal that agrees (K1),
    otherwise it is position-only (K2)."""
    single = R.dim() == 3
    if single:
        R, t, src_points, smask, tgt_points, src_normals, tgt_normals = lift(
            (R, t, src_points, smask, tgt_points, src_normals, tgt_normals))
    P, K = R.shape[:2]
    S = src_points.shape[1]
    q = (torch.einsum("...kij,...sj->...ksi", R, src_points)
         + t[:, :, None, :]).reshape(P, K * S, 3).contiguous()
    if normal_cos > 0.0 and src_normals is not None \
            and tgt_normals is not None:
        qn = torch.einsum("...kij,...sj->...ksi", R, _unit(src_normals)) \
            .reshape(P, K * S, 3).contiguous()
        d2 = nn.oriented_min_dist_sq(q, qn, tgt_points.contiguous(),
                                     _unit(tgt_normals).contiguous(),
                                     normal_cos).reshape(P, K, S)
    else:
        d2 = nn.min_dist_sq(q, tgt_points.contiguous()).reshape(P, K, S)
    r2 = per_pair(r2, P, R.device)[:, None, None]
    counts = torch.sum(((d2 <= r2) & smask[:, None, :]).to(torch.int32),
                       dim=-1)
    return counts[0] if single else counts


def overlap_scores(R, t, cand_valid, src_points, src_count,
                   tgt_points, tgt_count, inlier_distance,
                   plane_frac=None, face_weight: float = 0.2,
                   exact_k: int = 16, grid: int = 256,
                   src_normals=None, tgt_normals=None,
                   normal_cos: float = 0.0,
                   nn: NNPasses = ONE_DEVICE):
    """((C,) overlap ratios with an exact final argmax, (C,) phase-1
    ratios): phase 1 bounds every candidate's combined score
    ``face_weight * plane_frac + (1 - face_weight) * overlap`` from above,
    phase 2 evaluates exact overlap in chunks of ``exact_k`` down the bound
    ranking until no unevaluated candidate can win.  Unevaluated
    candidates return 0 overlap.  (The reference returns the phase-1
    ratios only with ``return_approx=True``; its one caller sets it.)

    With a leading axis of P pairs (``inlier_distance`` a number or (P,))
    the chunks of all pairs go to one kernel launch each, and the bound
    loop runs while any pair can still improve; a pair that cannot is
    frozen, as the reference's vmapped ``while_loop`` freezes it: later
    chunks write nothing of it (their exact overlaps, which its own run
    leaves at 0, could move an argmax tie).  Phase 2 runs
    ``nn``'s passes (:func:`exact_overlap_counts`)."""
    single = R.dim() == 3
    if single:
        (R, t, cand_valid, src_points, src_count, tgt_points, tgt_count,
         plane_frac, src_normals, tgt_normals) = lift(
            (R, t, cand_valid, src_points, src_count, tgt_points, tgt_count,
             plane_frac, src_normals, tgt_normals))
    P, C = R.shape[:2]
    dev = R.device
    tmask = torch.arange(tgt_points.shape[1], device=dev) < tgt_count[:, None]
    smask = torch.arange(src_points.shape[1], device=dev) < src_count[:, None]
    r = per_pair(inlier_distance, P, dev)
    bitmap, origin, cell = build_occupancy(tgt_points, tmask, r, grid,
                                           cell_divisor=2)
    counts = approx_overlap_counts(bitmap, origin, cell, R, t,
                                   src_points, smask, grid)
    denom = torch.clamp(torch.minimum(src_count, tgt_count), min=1) \
        .to(torch.float32)[:, None]
    approx = counts.to(torch.float32) / denom
    pf = torch.zeros((P, C), dtype=torch.float32, device=dev) \
        if plane_frac is None else plane_frac
    fw = 0.0 if plane_frac is None else face_weight
    bound = fw * pf + (1.0 - fw) * approx
    bound = torch.where(cand_valid, bound, -float("inf"))

    K = min(exact_k, C)
    nchunks = (C + K - 1) // K
    order = torch.sort(-bound, stable=True).indices         # desc by bound
    pad = nchunks * K - C
    order_p = torch.cat([order, torch.zeros((P, pad), dtype=order.dtype,
                                            device=dev)], dim=1)
    bound_sorted = torch.cat([torch.gather(bound, 1, order),
                              torch.full((P, pad + K), -float("inf"),
                                         device=dev)], dim=1)
    out = torch.zeros((P, C), dtype=torch.float32, device=dev)
    best = torch.full((P,), -float("inf"), device=dev)
    live_k = torch.arange(K, device=dev)
    flat_out = out.view(-1)
    i = 0
    while i < nchunks:
        # the best exact score only rises and the bounds only fall, so a
        # pair that stops here stays stopped: ``go`` is the loop's
        # predicate per pair
        go = best < bound_sorted[:, i * K]
        flags = host_value(go)
        if not any(flags):
            break
        sel = order_p[:, i * K:(i + 1) * K]
        exact = exact_overlap_counts(take(R, sel), take(t, sel), src_points,
                                     smask, tgt_points, r * r,
                                     src_normals=src_normals,
                                     tgt_normals=tgt_normals,
                                     normal_cos=normal_cos, nn=nn)
        ovr = exact.to(torch.float32) / denom
        valid_sel = torch.gather(cand_valid, 1, sel)
        upd = torch.where(valid_sel, ovr, 0.0)
        combined = torch.where(valid_sel,
                               fw * torch.gather(pf, 1, sel)
                               + (1.0 - fw) * ovr, -float("inf"))
        combined = torch.where(live_k + i * K < C, combined, -float("inf"))
        new_best = torch.maximum(best, torch.amax(combined, dim=1))
        if not all(flags):
            upd = torch.where(go[:, None], upd, torch.gather(out, 1, sel))
            new_best = torch.where(go, new_best, best)
        # padded slots alias candidate 0 with an identical value
        flat_out[flat_rows(sel, C)] = upd.reshape(-1)
        best = new_best
        i += 1
    res = (torch.where(cand_valid, out, 0.0),
           torch.where(cand_valid, approx, 0.0))
    return drop(res) if single else res
