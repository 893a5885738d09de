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
* The cluster-centroid sums are float scatter-adds, which use atomics on
  the card: their last bits may differ from run to run.  The packed
  representative argmin is an int32 ``scatter_reduce("amin")`` and is
  deterministic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.ops import scalar
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
    fixed-size buffer."""
    Q = query.desc.shape[0]
    T = target.desc.shape[0]
    dev = query.desc.device
    r2 = scalar(radius * radius, dev)
    td = target.desc
    tt = torch.sum(td * td, dim=-1)
    k = min(per_query, T)
    vals, idx, nh = [], [], []
    for s in range(0, Q, block):
        qb = query.desc[s:s + block]
        qq = torch.sum(qb * qb, dim=-1, keepdim=True)
        d2 = qq - 2.0 * (qb @ td.T) + tt[None, :]
        srt = torch.sort(d2, dim=1, stable=True)
        vals.append(srt.values[:, :k])
        idx.append(srt.indices[:, :k])
        nh.append(torch.sum((d2 <= r2).to(torch.int32), dim=-1))
    vals = torch.cat(vals)
    idx = torch.cat(idx)
    nh = torch.cat(nh)

    hit = vals <= r2                                     # (Q, k)
    hi = hit.to(torch.int64)
    flat_hit = hi.reshape(-1)
    dest = torch.cumsum(flat_hit, 0) - flat_hit          # rank-order slot
    write = hit.reshape(-1) & (dest < max_matches)
    dest_safe = torch.where(write, dest, max_matches)
    qi = torch.arange(Q, dtype=torch.int32, device=dev)[:, None] \
        .expand(Q, k).reshape(-1)
    buf_q = torch.zeros(max_matches + 1, dtype=torch.int32, device=dev)
    buf_q.scatter_(0, dest_safe, torch.where(write, qi, 0))
    buf_t = torch.zeros(max_matches + 1, dtype=torch.int32, device=dev)
    buf_t.scatter_(0, dest_safe,
                   torch.where(write, idx.reshape(-1).to(torch.int32), 0))
    total = torch.sum(hi).to(torch.int32)
    m = torch.arange(max_matches, device=dev) \
        < torch.clamp(total, max=max_matches)
    kept_hits = torch.sum(hi, dim=1)
    return Matches(q_idx=buf_q[:max_matches], t_idx=buf_t[:max_matches],
                   valid=m, count=total,
                   saturated=torch.sum((nh > kept_hits).to(torch.int32)))


def stitch_hypotheses(segments):
    """Front-compact hypothesis segments into one (R, t, valid) buffer.

    ``segments``: list of ``(R (Mi, 3, 3), t (Mi, 3), count ())`` whose
    valid rows sit in a front prefix (the ``match_descriptors``
    convention).  Each segment is copied at the running valid count, so all
    valid rows land in one prefix that clustering's prefix covers.  The
    write offsets stay on the device.  Returns (R, t, valid, total)."""
    H = sum(int(s[0].shape[0]) for s in segments)
    R0, t0, c0 = segments[0]
    dev = R0.device
    R = torch.zeros((H, 3, 3), dtype=R0.dtype, device=dev)
    t = torch.zeros((H, 3), dtype=t0.dtype, device=dev)
    R[:R0.shape[0]] = R0
    t[:t0.shape[0]] = t0
    total = torch.clamp(c0, max=R0.shape[0]).to(torch.int64)
    for Ri, ti, ci in segments[1:]:
        # start = running count <= the previous segments' sizes, so
        # start + Mi <= H
        pos = total + torch.arange(Ri.shape[0], device=dev)
        R.index_copy_(0, pos, Ri)
        t.index_copy_(0, pos, ti)
        total = total + torch.clamp(ci, max=Ri.shape[0])
    valid = torch.arange(H, device=dev) < total
    return R, t, valid, total.to(torch.int32)


def hypothesis_poses(query: PairDescriptors, target: PairDescriptors,
                     matches: Matches):
    """(R, t) per match: R aligns the canonicalized source line directions
    onto the target's; t = target_anchor - R @ source_anchor
    (util.cpp:303-327, 604-624)."""
    qi = matches.q_idx.to(torch.int64)
    ti = matches.t_idx.to(torch.int64)
    R = rotation_from_two_vecs(query.line_vec1[qi], query.line_vec2[qi],
                               target.line_vec1[ti], target.line_vec2[ti])
    t = target.anchor[ti] - torch.einsum("mij,mj->mi", R, query.anchor[qi])
    return R, t


#: above this many hypotheses the cluster adjacency is recomputed in row
#: chunks every sweep instead of held whole (8192^2 bools = 64 MB)
FULL_ADJACENCY_MAX = 8192


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
    (lowest index on ties)."""
    H = R.shape[0]
    dev = R.device
    if H > 65536:
        raise ValueError(f"cluster_poses packs indices into 16 bits; "
                         f"H={H} > 65536")
    roll, pitch, yaw = euler_angles(R)
    e = torch.stack([roll, pitch, yaw], dim=-1)
    tt = torch.sum(t * t, dim=-1)
    ee = torch.sum(e * e, dim=-1)
    d2t_tol = scalar(dist_tol, dev) ** 2
    d2e_tol = scalar(euler_tol, dev) ** 2
    idx = torch.arange(H, dtype=torch.int64, device=dev)

    def adjacency(rows: slice) -> torch.Tensor:
        d2t = tt[rows, None] - 2.0 * (t[rows] @ t.T) + tt[None, :]
        d2e = ee[rows, None] - 2.0 * (e[rows] @ e.T) + ee[None, :]
        return (d2t <= d2t_tol) & (d2e < d2e_tol) \
            & valid[rows, None] & valid[None, :]

    if H <= FULL_ADJACENCY_MAX:
        adj_full = adjacency(slice(0, H))
        blocks = [(slice(0, H), adj_full)]
    else:
        blocks = [(slice(s, min(s + chunk, H)), None)
                  for s in range(0, H, chunk)]

    def sweep(labels):
        lab32 = labels.to(torch.int32)[None, :]
        new = torch.cat([
            torch.amin(torch.where(adj if adj is not None
                                   else adjacency(rows), lab32, H), dim=1)
            for rows, adj in blocks])
        lab = torch.minimum(labels, new.to(torch.int64))
        lab = torch.minimum(lab, lab[lab])     # pointer jump x2
        return torch.minimum(lab, lab[lab])

    labels = sweep(idx)
    prev = idx
    it = 1
    while it < 32 and host_value(torch.any(labels != prev)):
        labels, prev = sweep(labels), labels
        it += 1

    counts = torch.zeros(H, dtype=torch.int32, device=dev).scatter_add_(
        0, labels, valid.to(torch.int32))

    # representative = member nearest the cluster's 6-D centroid
    # (deliberate deviation of the reference package, see plade_tpu)
    vf = valid.to(torch.float32)[:, None]
    cnt_f = torch.clamp(counts.to(torch.float32), min=1.0)
    tsum = torch.zeros((H, 3), dtype=torch.float32, device=dev) \
        .index_add_(0, labels, t * vf)
    esum = torch.zeros((H, 3), dtype=torch.float32, device=dev) \
        .index_add_(0, labels, e * vf)
    tmean = (tsum / cnt_f[:, None])[labels]
    emean = (esum / cnt_f[:, None])[labels]
    d = torch.sum((t - tmean) ** 2, -1) / torch.clamp(d2t_tol, min=1e-12) \
        + torch.sum((e - emean) ** 2, -1) / torch.clamp(d2e_tol, min=1e-12)
    # scatter-argmin via packed (quantized distance, index) int32 keys
    imax = 2 ** 31 - 1
    q = torch.clamp(d * 4096.0, 0.0, 32766.0).to(torch.int32)
    packed = torch.where(valid, (q << 16) | idx.to(torch.int32), imax)
    best = torch.full((H,), imax, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, labels, packed, reduce="amin", include_self=True)
    rep_of_root = best & 0xFFFF

    # top-k by size, lower root label first among equal sizes
    k = min(max_clusters, H)
    srt = torch.sort(counts, descending=True, stable=True)
    top_counts = srt.values[:k]
    top_root = srt.indices[:k]
    if k < max_clusters:
        top_counts = torch.nn.functional.pad(top_counts, (0, max_clusters - k))
        top_root = torch.nn.functional.pad(top_root, (0, max_clusters - k))
    cvalid = top_counts > 0
    rep = torch.where(cvalid, rep_of_root[top_root], 0)
    return Clusters(rep=rep.to(torch.int32), size=top_counts,
                    valid=cvalid)


def plane_consistency(R, t, cvalid,
                      src_coeffs, src_centers, src_radii, src_pmask,
                      tgt_coeffs, tgt_centers, tgt_radii, tgt_pmask,
                      src_bounding_center, tgt_bounding_center,
                      max_radius, length_threshold, cos_angle_threshold):
    """Per-candidate consistent-plane count + matched pair mask
    (util.cpp:352-401).  Returns (counts (C,), pair_mask (C, Ps, Pt))."""
    ns = src_coeffs[:, :3]
    ds = src_coeffs[:, 3]
    rn = torch.einsum("cij,pj->cpi", R, ns)                 # (C, Ps, 3)
    rd = ds[None, :] - torch.einsum("cpi,ci->cp", rn, t)    # (C, Ps)
    sc = torch.einsum("cij,pj->cpi", R, src_centers) + t[:, None, :]

    nt = tgt_coeffs[:, :3]
    dt = tgt_coeffs[:, 3]

    ang = torch.einsum("cpi,qi->cpq", rn, nt)               # (C, Ps, Pt)
    d_a = torch.abs(torch.einsum("qi,cpi->cpq", nt, sc) + dt[None, None, :])
    d_b = torch.abs(torch.einsum("cpi,qi->cpq", rn, tgt_centers)
                    + rd[..., None])
    c2pd = 0.5 * (d_a + d_b)
    center_dist = torch.linalg.vector_norm(
        sc[:, :, None, :] - tgt_centers[None, None, :, :], dim=-1)
    rad_sum = src_radii[None, :, None] + tgt_radii[None, None, :]

    ok = (ang >= cos_angle_threshold) & (c2pd <= length_threshold) \
        & (center_dist <= rad_sum) \
        & src_pmask[None, :, None] & tgt_pmask[None, None, :]

    # bounding-center sanity (util.cpp:359-363)
    tc = torch.einsum("cij,j->ci", R, src_bounding_center) + t
    center_ok = torch.linalg.vector_norm(tc - tgt_bounding_center,
                                         dim=-1) <= max_radius

    matched_src = torch.any(ok, dim=2)                      # (C, Ps)
    counts = torch.sum(matched_src.to(torch.int32), dim=1)
    counts = torch.where(cvalid & center_ok, counts, 0).to(torch.int32)
    # "break" on first target match: keep only the first matching target
    first = torch.argmax(ok.to(torch.uint8), dim=2)
    pair_mask = (torch.arange(ok.shape[2], device=ok.device)[None, None, :]
                 == first[..., None]) & ok
    pair_mask &= (cvalid & center_ok)[:, None, None]
    return counts, pair_mask


def select_candidates(counts, cluster_order_rank, max_candidates: int):
    """Order candidates by (match count desc, cluster-size rank asc) and
    keep the top ``max_candidates`` with count >= 2 (util.cpp:404-459)."""
    C = counts.shape[0]
    eligible = counts >= 2
    key = torch.where(eligible,
                      counts.to(torch.int32) * C - cluster_order_rank, -1)
    order = torch.sort(-key, stable=True).indices
    sel = order[:max_candidates]
    return sel.to(torch.int32), eligible[sel]
