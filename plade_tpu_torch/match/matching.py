"""Descriptor matching, pose hypotheses, pose clustering, plane consistency
(``plade_tpu/match/matching.py``).

Differences from the reference package, none of which changes a result:

* Per-row neighbours are selected exactly: a stable sort of each distance
  row (ascending distance, lower target index first on ties).  The
  reference selects with ``lax.approx_min_k`` and repairs rows where the
  approximation dropped a hit with an exact second pass; with an exact
  selection that pass has nothing to repair and is left out.
* The cluster sweeps run until the labels stop changing as a Python loop,
  one host sync per sweep; ``cluster_poses`` is the reference's
  ``_cluster_impl``.
* Every function takes one pair or a leading axis of pairs (the
  reference's ``jax.vmap`` of the pair step); the single-pair call is the
  one-pair call of the batched code.
* The cluster-centroid sums are float scatter-adds through
  :func:`..core.ops.index_sum`, in the same order on every run.  The
  packed representative argmin is an int32 ``scatter_reduce("amin")`` and
  is deterministic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.ops import (drop, flat_rows, index_sum, lift, per_pair, scalar,
                        take)
from ..core.types import PairDescriptors, host_value
from ..geometry.transforms import euler_angles, rotation_from_two_vecs


class Matches(NamedTuple):
    q_idx: torch.Tensor   # (M,) int32 — query row
    t_idx: torch.Tensor   # (M,) int32 — target row
    valid: torch.Tensor   # (M,) bool
    count: torch.Tensor   # () int32 (pre-cap true count)
    saturated: torch.Tensor  # () int32 — query rows that kept fewer radius
    # hits than exist (0 certifies the match set radius-exact)


def match_descriptors(query: PairDescriptors, target: PairDescriptors,
                      radius: float, max_matches: int,
                      block: int = 1024, per_query: int = 64) -> Matches:
    """All (query, target) descriptor pairs within ``radius`` (Euclidean
    over the descriptor width: 8-D, or 6-D for the degraded families;
    |q|^2 - 2 q.t + |t|^2 form), at most ``per_query`` per query row (the
    nearest), compacted in (query row, distance rank) order into a
    fixed-size buffer.  One descriptor pair, or a leading axis of P (each
    pair's queries against its own targets; ``block`` query rows of every
    pair a block)."""
    single = query.desc.dim() == 2
    if single:
        query, target = lift((query, target))
    P, Q = query.desc.shape[:2]
    T = target.desc.shape[1]
    dev = query.desc.device
    r2 = scalar(radius * radius, dev)
    td = target.desc
    tt = torch.sum(td * td, dim=-1)
    k = min(per_query, T)
    vals, idx, nh = [], [], []
    for s in range(0, Q, block):
        qb = query.desc[:, s:s + block]
        qq = torch.sum(qb * qb, dim=-1, keepdim=True)
        d2 = qq - 2.0 * (qb @ td.transpose(-1, -2)) + tt[:, None, :]
        srt = torch.sort(d2, dim=-1, stable=True)
        vals.append(srt.values[..., :k])
        idx.append(srt.indices[..., :k])
        nh.append(torch.sum((d2 <= r2).to(torch.int32), dim=-1))
    vals = torch.cat(vals, dim=1)
    idx = torch.cat(idx, dim=1)
    nh = torch.cat(nh, dim=1)

    hit = vals <= r2                                     # (P, Q, k)
    hi = hit.to(torch.int64)
    flat_hit = hi.reshape(P, -1)
    dest = torch.cumsum(flat_hit, 1) - flat_hit          # rank-order slot
    write = hit.reshape(P, -1) & (dest < max_matches)
    dest_safe = torch.where(write, dest, max_matches)
    qi = torch.arange(Q, dtype=torch.int32, device=dev)[:, None] \
        .expand(Q, k).reshape(-1)
    buf_q = torch.zeros((P, max_matches + 1), dtype=torch.int32, device=dev)
    buf_q.scatter_(1, dest_safe, torch.where(write, qi, 0))
    buf_t = torch.zeros((P, max_matches + 1), dtype=torch.int32, device=dev)
    buf_t.scatter_(1, dest_safe,
                   torch.where(write, idx.reshape(P, -1).to(torch.int32), 0))
    total = torch.sum(hi.reshape(P, -1), dim=1).to(torch.int32)
    m = torch.arange(max_matches, device=dev) \
        < torch.clamp(total, max=max_matches)[:, None]
    kept_hits = torch.sum(hi, dim=-1)
    out = Matches(q_idx=buf_q[:, :max_matches], t_idx=buf_t[:, :max_matches],
                  valid=m, count=total,
                  saturated=torch.sum(nh > kept_hits, dim=1,
                                      dtype=torch.int32))
    return drop(out) if single else out


def stitch_hypotheses(segments):
    """Front-compact hypothesis segments into one (R, t, valid) buffer.

    ``segments``: list of ``(R (Mi, 3, 3), t (Mi, 3), count ())`` whose
    valid rows sit in a front prefix (the ``match_descriptors``
    convention), or each with a leading axis of P pairs.  Each segment is
    copied at the running valid count, so all valid rows land in one prefix
    that clustering's prefix covers.  The write offsets stay on the device.
    Returns (R, t, valid, total)."""
    single = segments[0][0].dim() == 3
    if single:
        segments = lift(segments)
    H = sum(int(seg[0].shape[1]) for seg in segments)
    R0, t0, c0 = segments[0]
    P, M0 = R0.shape[:2]
    dev = R0.device
    R = torch.zeros((P, H, 3, 3), dtype=R0.dtype, device=dev)
    t = torch.zeros((P, H, 3), dtype=t0.dtype, device=dev)
    R[:, :M0] = R0
    t[:, :M0] = t0
    total = torch.clamp(c0, max=M0).to(torch.int64)
    Rf, tf = R.view(P * H, 3, 3), t.view(P * H, 3)
    for Ri, ti, ci in segments[1:]:
        Mi = Ri.shape[1]
        # start = running count <= the previous segments' sizes, so
        # start + Mi <= H
        pos = flat_rows(total[:, None] + torch.arange(Mi, device=dev), H)
        Rf.index_copy_(0, pos, Ri.reshape(P * Mi, 3, 3))
        tf.index_copy_(0, pos, ti.reshape(P * Mi, 3))
        total = total + torch.clamp(ci, max=Mi)
    valid = torch.arange(H, device=dev) < total[:, None]
    out = (R, t, valid, total.to(torch.int32))
    return drop(out) if single else out


def hypothesis_poses(query: PairDescriptors, target: PairDescriptors,
                     matches: Matches):
    """(R, t) per match: R aligns the canonicalized source line directions
    onto the target's; t = target_anchor - R @ source_anchor
    (util.cpp:303-327, 604-624).  One pair, or a leading axis of P."""
    single = query.desc.dim() == 2
    if single:
        query, target, matches = lift((query, target, matches))
    qi = matches.q_idx.to(torch.int64)
    ti = matches.t_idx.to(torch.int64)
    R = rotation_from_two_vecs(take(query.line_vec1, qi),
                               take(query.line_vec2, qi),
                               take(target.line_vec1, ti),
                               take(target.line_vec2, ti))
    t = take(target.anchor, ti) - torch.einsum("...mij,...mj->...mi", R,
                                               take(query.anchor, qi))
    return (R[0], t[0]) if single else (R, t)


#: above this many hypotheses the cluster adjacency is recomputed in row
#: chunks every sweep instead of held whole (8192^2 bools = 64 MB)
FULL_ADJACENCY_MAX = 8192
#: most elements of one (pair, row, hypothesis) block of the adjacency's
#: float temporaries: one pair's full 8192^2 (256 MiB a float32 temporary),
#: and fewer rows a block for several pairs
_ADJ_BLOCK_ELEMS = FULL_ADJACENCY_MAX ** 2


class Clusters(NamedTuple):
    rep: torch.Tensor      # (C,) int32 — hypothesis index of representative
    size: torch.Tensor     # (C,) int32 — cluster member count
    valid: torch.Tensor    # (C,) bool


def cluster_poses(R: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                  dist_tol, euler_tol, max_clusters: int,
                  chunk: int = 1024) -> Clusters:
    """Exact single-linkage pose clustering over the 6-D (t, euler)
    embedding (ClusterTransformation + EnforceSimilarity,
    util.cpp:1232-1277): hypotheses link when their translations are
    within ``dist_tol`` and their Euler vectors within ``euler_tol``;
    clusters are the connected components, ranked by size descending;
    the representative is the member nearest the cluster's 6-D centroid
    (lowest index on ties).

    One pair's hypotheses, or a leading axis of P pairs (``dist_tol`` and
    ``euler_tol`` numbers or (P,)).  The sweeps run until no pair's labels
    change, one host read of the pairs' flags a sweep; a pair whose labels
    stopped changing is frozen, as the reference's vmapped ``while_loop``
    freezes it.  The adjacency's rows are computed in blocks of at most
    ``_ADJ_BLOCK_ELEMS`` (pair, row, hypothesis) elements: held for the
    sweeps up to ``FULL_ADJACENCY_MAX`` hypotheses, recomputed every sweep
    above it (blocks of at most ``chunk`` rows)."""
    single = R.dim() == 3
    if single:
        R, t, valid = lift((R, t, valid))
    P, H = R.shape[:2]
    dev = R.device
    if H > 65536:
        raise ValueError(f"cluster_poses packs indices into 16 bits; "
                         f"H={H} > 65536")
    roll, pitch, yaw = euler_angles(R)
    e = torch.stack([roll, pitch, yaw], dim=-1)
    tt = torch.sum(t * t, dim=-1)
    ee = torch.sum(e * e, dim=-1)
    d2t_tol = per_pair(dist_tol, P, dev) ** 2
    d2e_tol = per_pair(euler_tol, P, dev) ** 2
    idx = torch.arange(H, dtype=torch.int64, device=dev)

    def adjacency(rows: slice) -> torch.Tensor:
        d2t = tt[:, rows, None] - 2.0 * (t[:, rows] @ t.transpose(-1, -2)) \
            + tt[:, None, :]
        d2e = ee[:, rows, None] - 2.0 * (e[:, rows] @ e.transpose(-1, -2)) \
            + ee[:, None, :]
        return (d2t <= d2t_tol[:, None, None]) \
            & (d2e < d2e_tol[:, None, None]) \
            & valid[:, rows, None] & valid[:, None, :]

    held = H <= FULL_ADJACENCY_MAX
    step = max(1, min(H if held else chunk, _ADJ_BLOCK_ELEMS // (P * H)))
    blocks = [(slice(s, min(s + step, H)),) for s in range(0, H, step)]
    if held:
        blocks = [(rows, adjacency(rows)) for rows, in blocks]

    def sweep(labels):
        lab32 = labels.to(torch.int32)[:, None, :]
        new = torch.cat([
            torch.amin(torch.where(b[1] if held else adjacency(b[0]),
                                   lab32, H), dim=-1)
            for b in blocks], dim=1)
        lab = torch.minimum(labels, new.to(torch.int64))
        lab = torch.minimum(lab, torch.gather(lab, 1, lab))  # pointer jump x2
        return torch.minimum(lab, torch.gather(lab, 1, lab))

    labels = sweep(idx.expand(P, H))
    prev = idx.expand(P, H)
    it = 1
    while it < 32:
        changed = torch.any(labels != prev, dim=1)
        flags = host_value(changed)
        if not any(flags):
            break
        new = sweep(labels)
        if not all(flags):
            # a converged pair is frozen (a converged sweep is idempotent,
            # so this is the reference's rule rather than a repair)
            new = torch.where(changed[:, None], new, labels)
        labels, prev = new, labels
        it += 1

    counts = torch.zeros((P, H), dtype=torch.int32, device=dev).scatter_add_(
        1, labels, valid.to(torch.int32))

    # representative = member nearest the cluster's 6-D centroid
    # (deliberate deviation of the reference package, see plade_tpu)
    vf = valid.to(torch.float32)[..., None]
    cnt_f = torch.clamp(counts.to(torch.float32), min=1.0)
    flat = flat_rows(labels, H)
    tsum = index_sum(torch.zeros((P * H, 3), dtype=torch.float32, device=dev),
                     flat, (t * vf).reshape(-1, 3)).reshape(P, H, 3)
    esum = index_sum(torch.zeros((P * H, 3), dtype=torch.float32, device=dev),
                     flat, (e * vf).reshape(-1, 3)).reshape(P, H, 3)
    tmean = take(tsum / cnt_f[..., None], labels)
    emean = take(esum / cnt_f[..., None], labels)
    d = torch.sum((t - tmean) ** 2, -1) \
        / torch.clamp(d2t_tol, min=1e-12)[:, None] \
        + torch.sum((e - emean) ** 2, -1) \
        / torch.clamp(d2e_tol, min=1e-12)[:, None]
    # scatter-argmin via packed (quantized distance, index) int32 keys
    imax = 2 ** 31 - 1
    q = torch.clamp(d * 4096.0, 0.0, 32766.0).to(torch.int32)
    packed = torch.where(valid, (q << 16) | idx.to(torch.int32), imax)
    best = torch.full((P, H), imax, dtype=torch.int32, device=dev) \
        .scatter_reduce_(1, labels, packed, reduce="amin", include_self=True)
    rep_of_root = best & 0xFFFF

    # top-k by size, lower root label first among equal sizes
    k = min(max_clusters, H)
    srt = torch.sort(counts, dim=1, descending=True, stable=True)
    top_counts = srt.values[:, :k]
    top_root = srt.indices[:, :k]
    if k < max_clusters:
        top_counts = torch.nn.functional.pad(top_counts, (0, max_clusters - k))
        top_root = torch.nn.functional.pad(top_root, (0, max_clusters - k))
    cvalid = top_counts > 0
    rep = torch.where(cvalid, torch.gather(rep_of_root, 1, top_root), 0)
    out = Clusters(rep=rep.to(torch.int32), size=top_counts, valid=cvalid)
    return drop(out) if single else out


def plane_consistency(R, t, cvalid,
                      src_coeffs, src_centers, src_radii, src_pmask,
                      tgt_coeffs, tgt_centers, tgt_radii, tgt_pmask,
                      src_bounding_center, tgt_bounding_center,
                      max_radius, length_threshold, cos_angle_threshold):
    """Per-candidate consistent-plane count + matched pair mask
    (util.cpp:352-401).  Returns (counts (C,), pair_mask (C, Ps, Pt)), or
    with a leading axis of P pairs when the inputs have one
    (``max_radius`` and ``length_threshold`` numbers or (P,))."""
    single = R.dim() == 3
    if single:
        (R, t, cvalid, src_coeffs, src_centers, src_radii, src_pmask,
         tgt_coeffs, tgt_centers, tgt_radii, tgt_pmask, src_bounding_center,
         tgt_bounding_center) = lift(
            (R, t, cvalid, src_coeffs, src_centers, src_radii, src_pmask,
             tgt_coeffs, tgt_centers, tgt_radii, tgt_pmask,
             src_bounding_center, tgt_bounding_center))
    P = R.shape[0]
    max_radius = per_pair(max_radius, P, R.device)
    length_threshold = per_pair(length_threshold, P, R.device)
    ns = src_coeffs[..., :3]
    ds = src_coeffs[..., 3]
    rn = torch.einsum("...cij,...pj->...cpi", R, ns)        # (P, C, Ps, 3)
    rd = ds[:, None, :] - torch.einsum("...cpi,...ci->...cp", rn, t)
    sc = torch.einsum("...cij,...pj->...cpi", R, src_centers) \
        + t[:, :, None, :]

    nt = tgt_coeffs[..., :3]
    dt = tgt_coeffs[..., 3]

    ang = torch.einsum("...cpi,...qi->...cpq", rn, nt)      # (P, C, Ps, Pt)
    d_a = torch.abs(torch.einsum("...qi,...cpi->...cpq", nt, sc)
                    + dt[:, None, None, :])
    d_b = torch.abs(torch.einsum("...cpi,...qi->...cpq", rn, tgt_centers)
                    + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    center_dist = torch.linalg.vector_norm(
        sc[:, :, :, None, :] - tgt_centers[:, None, None, :, :], dim=-1)
    rad_sum = src_radii[:, None, :, None] + tgt_radii[:, None, None, :]

    ok = (ang >= cos_angle_threshold) \
        & (c2pd <= length_threshold[:, None, None, None]) \
        & (center_dist <= rad_sum) \
        & src_pmask[:, None, :, None] & tgt_pmask[:, None, None, :]

    # bounding-center sanity (util.cpp:359-363)
    tc = torch.einsum("...cij,...j->...ci", R, src_bounding_center) + t
    center_ok = torch.linalg.vector_norm(
        tc - tgt_bounding_center[:, None, :], dim=-1) <= max_radius[:, None]

    matched_src = torch.any(ok, dim=-1)                     # (P, C, Ps)
    counts = torch.sum(matched_src.to(torch.int32), dim=-1)
    counts = torch.where(cvalid & center_ok, counts, 0).to(torch.int32)
    # "break" on first target match: keep only the first matching target
    first = torch.argmax(ok.to(torch.uint8), dim=-1)
    pair_mask = (torch.arange(ok.shape[-1], device=ok.device)
                 == first[..., None]) & ok
    pair_mask &= (cvalid & center_ok)[..., None, None]
    return (counts[0], pair_mask[0]) if single else (counts, pair_mask)


def select_candidates(counts, cluster_order_rank, max_candidates: int):
    """Order candidates by (match count desc, cluster-size rank asc) and
    keep the top ``max_candidates`` with count >= 2 (util.cpp:404-459).
    counts (C,) or (P, C) per pair."""
    C = counts.shape[-1]
    eligible = counts >= 2
    key = torch.where(eligible,
                      counts.to(torch.int32) * C - cluster_order_rank, -1)
    order = torch.sort(-key, stable=True).indices
    sel = order[..., :max_candidates]
    return sel.to(torch.int32), torch.gather(eligible, -1, sel)
