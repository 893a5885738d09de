"""Pair registration from given planes (``plade_tpu/pipeline.py``).

The registration core of the reference (plade.cpp:31-580) for callers who
bring their own plane segmentation:

  prepare_cloud (per cloud):  downsample -> OBB -> per-plane geometry ->
                              plane-pair intersection lines
  register_pair:              pair-line descriptors -> radius match ->
                              pose hypotheses -> pose clustering ->
                              plane consistency -> top candidates ->
                              penetration filter -> two-phase overlap ->
                              pose-diverse top-K rescore (short ICP, then a
                              tight oriented overlap)
  register_with_planes:       the public entry: numpy or tensors in,
                              (4x4 numpy transform, info dict) out

The tensors live on the device of the inputs (or ``device``).  Options
whose path is not ported raise ``NotImplementedError`` naming their
ROADMAP item: degraded descriptor families, line-confidence culling and
the final ICP.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .core.config import PladeConfig
from .core.ops import nonzero_static, scalar
from .core.types import (BIG, Cloud, LineSet, PlaneGeometry, PlaneSet,
                         RegistrationResult, host_value, pad_cloud,
                         se3_matrix)
from .descriptors.pairlines import pair_descriptors
from .geometry.lines import intersect_planes, project_points_to_plane
from .geometry.obb import compute_obb
from .geometry.voxel import voxel_downsample, voxel_downsample_by_plane
from .knn.bruteforce import average_spacing
from .match import matching
from .refine.icp import refine_icp
from .verify import overlap as overlap_mod
from .verify import penetration


def _stage(name: str):
    """Label a stage for ``torch.profiler`` (its ranges name the layers of
    the time breakdown; the label costs next to nothing when no profiler
    runs)."""
    return torch.profiler.record_function(f"plade.{name}")


def check_supported(cfg: PladeConfig) -> None:
    """Raise for options whose path this package does not have yet."""
    if cfg.enable_degraded_families:
        raise NotImplementedError(
            "enable_degraded_families is not ported (ROADMAP Queue 1, "
            "features off the main path: degraded families)")
    if cfg.min_line_confidence > 0.0:
        raise NotImplementedError(
            "min_line_confidence > 0 is not ported (ROADMAP Queue 1, "
            "features off the main path: line confidence)")
    if cfg.enable_icp:
        raise NotImplementedError(
            "enable_icp is not ported (ROADMAP Queue 1, features off the "
            "main path: final ICP)")


class PreparedCloud(NamedTuple):
    ds: Cloud                        # downsampled full cloud
    bounding_center: torch.Tensor    # (3,)
    bounding_radius: torch.Tensor    # ()
    planes: PlaneSet
    geom: PlaneGeometry
    lines: LineSet


def prepare_cloud(cloud: Cloud, planes: PlaneSet, dsd,
                  cfg: PladeConfig) -> PreparedCloud:
    """Downsample, OBB, per-plane geometry and plane-pair intersection lines
    of one cloud (plade.cpp:77-172)."""
    check_supported(cfg)
    dev = cloud.points.device
    ds = voxel_downsample(cloud.points, cloud.mask, dsd, cfg.max_ds_points,
                          normals=cloud.normals)
    box = compute_obb(ds.points, ds.mask)
    # enclosing-sphere radius (OBB half-diagonal), see
    # PladeConfig.line_radius_factor
    sphere_radius = cfg.line_radius_factor * 0.5 \
        * torch.linalg.vector_norm(box.extents)

    P = planes.coeffs.shape[0]
    pts, counts = voxel_downsample_by_plane(
        cloud.points, cloud.mask, planes.point_plane, dsd, P,
        cfg.max_plane_points)
    pmasks = torch.arange(cfg.max_plane_points, device=dev)[None, :] \
        < counts[:, None]
    pboxes = compute_obb(pts, pmasks)
    corners = project_points_to_plane(pboxes.corners[:, :4],
                                      planes.coeffs[:, None, :])
    centers = 0.5 * (corners[:, 0] + corners[:, 2])
    radii = 0.5 * torch.linalg.vector_norm(corners[:, 0] - corners[:, 2],
                                           dim=-1)
    geom = PlaneGeometry(ds_points=pts, ds_counts=counts, corners=corners,
                         centers=centers, radii=radii)

    # plane-pair intersection lines (plade.cpp:130-172)
    coeffs = planes.coeffs
    ar = torch.arange(P, device=dev)
    ii, jj = torch.meshgrid(ar, ar, indexing="ij")
    direction, point, lvalid = intersect_planes(coeffs[ii], coeffs[jj],
                                                cfg.plane_pair_max_cos)
    pm = planes.mask
    lvalid = lvalid & (jj > ii) & pm[ii] & pm[jj]
    # lines far from the bounding center are dropped (plade.cpp:137-142,
    # radius relaxed to the enclosing sphere)
    w = point - box.center
    along = torch.sum(w * direction, dim=-1)
    dist = torch.sqrt(torch.clamp(torch.sum(w * w, -1) - along * along,
                                  min=0.0))
    lvalid = lvalid & (dist <= sphere_radius)

    flat = lvalid.reshape(-1)
    total = P * P
    idx = nonzero_static(flat, cfg.max_lines, total)
    ok = idx < total
    idx_safe = torch.clamp(idx, max=total - 1)
    li = idx_safe // P
    lj = idx_safe % P
    lines = LineSet(
        direction=torch.where(ok[:, None],
                              direction.reshape(total, 3)[idx_safe], 0.0),
        point=torch.where(ok[:, None], point.reshape(total, 3)[idx_safe],
                          BIG),
        support=torch.where(ok[:, None], torch.stack([li, lj], -1), 0)
        .to(torch.int32),
        count=torch.clamp(torch.sum(flat.to(torch.int32)),
                          max=cfg.max_lines).to(torch.int32),
    )
    return PreparedCloud(ds=ds, bounding_center=box.center,
                         bounding_radius=sphere_radius, planes=planes,
                         geom=geom, lines=lines)


def register_pair(tgt: PreparedCloud, src: PreparedCloud, dparams,
                  cfg: PladeConfig) -> RegistrationResult:
    """Register two prepared clouds; ``dparams`` = (scale,
    length_threshold, down_sample_distance) as float32 0-d tensors."""
    check_supported(cfg)
    scale, length_threshold, dsd = dparams
    dev = tgt.ds.points.device
    ninf = -float("inf")
    cos10 = math.cos(cfg.line_pair_min_angle)
    with _stage("descriptors"):
        tgt_desc = pair_descriptors(
            tgt.lines, tgt.planes.coeffs[:, :3], scale, cfg.max_target_pairs,
            ordered=True, min_angle_cos=cos10, pad_value=-1e6)
        src_desc = pair_descriptors(
            src.lines, src.planes.coeffs[:, :3], scale, cfg.max_query_pairs,
            ordered=False, min_angle_cos=cos10, pad_value=1e6)

    with _stage("match"):
        matches = matching.match_descriptors(
            src_desc, tgt_desc, cfg.descriptor_match_radius, cfg.max_matches,
            per_query=cfg.match_per_query)
        R, t = matching.hypothesis_poses(src_desc, tgt_desc, matches)
        hyp_valid = matches.valid
        total_matches = torch.clamp(matches.count, max=cfg.max_matches)

    with _stage("cluster"):
        # cluster at half the length/angle thresholds (util.cpp:331) over the
        # front-compacted prefix; overflow is counted (cluster_truncated)
        euler_tol = math.sqrt(cfg.angle_threshold / 2.0)
        HB = min(cfg.max_cluster_hypotheses, R.shape[0])
        cluster_truncated = torch.clamp(total_matches - HB, min=0)
        clusters = matching.cluster_poses(
            R[:HB], t[:HB], hyp_valid[:HB], length_threshold / 2.0, euler_tol,
            cfg.max_pose_clusters)
        rep = clusters.rep.to(torch.int64)
        cR = R[rep]
        ct = t[rep]

    with _stage("consistency"):
        counts, _ = matching.plane_consistency(
            cR, ct, clusters.valid,
            src.planes.coeffs, src.geom.centers, src.geom.radii,
            src.planes.mask,
            tgt.planes.coeffs, tgt.geom.centers, tgt.geom.radii,
            tgt.planes.mask,
            src.bounding_center, tgt.bounding_center,
            tgt.bounding_radius, length_threshold,
            math.cos(cfg.angle_threshold))

        C = counts.shape[0]
        sel, sel_valid = matching.select_candidates(
            counts, torch.arange(C, dtype=torch.int32, device=dev),
            cfg.max_candidate_results)
        sel = sel.to(torch.int64)
        sR = cR[sel]
        st = ct[sel]
        sel_counts = counts[sel]

    with _stage("penetration"):
        pen_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.enable_penetration_filter:
            tests = penetration.build_tests(
                sR, st, sel_valid,
                src.planes.coeffs, src.geom.corners, src.geom.centers,
                src.planes.mask,
                tgt.planes.coeffs, tgt.geom.corners, tgt.geom.centers,
                tgt.planes.mask,
                length_threshold, cfg.angle_threshold,
                max_tests=cfg.max_penetration_tests)
            pen = penetration.run_tests(
                tests, sR, st,
                src.geom.ds_points, src.geom.ds_counts,
                tgt.geom.ds_points, tgt.geom.ds_counts,
                src.planes.coeffs, tgt.planes.coeffs,
                search_radius=length_threshold,
                min_points=cfg.penetration_min_points,
                min_distance=length_threshold / 2.0,
                n_samples=cfg.penetration_samples,
                max_ratio=cfg.penetration_ratio)
            rejected = penetration.rejected_candidates(
                tests, pen, cfg.max_candidate_results)
            sel_valid = sel_valid & ~rejected
            pen_overflow = tests.overflow

    with _stage("overlap"):
        plane_frac = sel_counts.to(torch.float32) / torch.clamp(
            src.planes.count.to(torch.float32), min=1.0)
        ov, ov_approx = overlap_mod.overlap_scores(
            sR, st, sel_valid, src.ds.points, src.ds.count,
            tgt.ds.points, tgt.ds.count, dsd,
            plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
            exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid,
            src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
            normal_cos=cfg.overlap_normal_cos)
        fw = cfg.face_matches_weight
        score = fw * plane_frac + (1.0 - fw) * ov
        score = torch.where(sel_valid, score, ninf)
        # 1-element index tensors throughout: indexing with a 0-d tensor
        # would read it on the host
        best = torch.argmax(score).reshape(1)

    with _stage("rescore"):
        if cfg.rescore_top_k > 0:
            # tight-radius rescore of the top-K pose-distinct coarse candidates
            # (a framework addition of the reference package; see
            # plade_tpu/pipeline.py for the rationale)
            K = cfg.rescore_top_k
            rank_score = torch.where(sel_valid, fw * plane_frac
                                     + (1.0 - fw) * ov_approx, ninf)
            C2 = score.shape[0]
            cosag = torch.einsum("aij,bij->ab", sR, sR)      # tr(Ra Rb^T)
            near_pose = (torch.linalg.vector_norm(
                st[:, None, :] - st[None, :, :], dim=-1) < length_threshold) \
                & (cosag > 1.0 + 2.0 * math.cos(2.0 * cfg.angle_threshold))
            banned = torch.zeros((C2,), dtype=torch.bool, device=dev)
            picks = []
            for _ in range(K):
                avail = (rank_score > ninf) & ~banned
                i = torch.argmax(torch.where(avail, rank_score, ninf)) \
                    .reshape(1)
                ok = avail[i]
                picks.append(torch.where(ok, i, C2))
                banned = banned | (near_pose[i][0] & ok)
                banned[i] = True
            sel_k = torch.cat(picks)
            kvalid = sel_k < C2
            top_idx = torch.clamp(sel_k, max=C2 - 1)
            # re-center each picked pose with a short point-to-plane ICP, all
            # modes batched: one K2 launch per nearest-neighbour pass
            icp_sub = max(1, cfg.rescore_icp_subsample)
            Rr, tr, _, _ = refine_icp(
                sR[top_idx], st[top_idx], src.ds.points[::icp_sub],
                src.ds.mask[::icp_sub], tgt.ds.points, tgt.ds.normals, dsd,
                cfg.rescore_icp_iters)
            r_fine = cfg.rescore_radius_factor * dsd / cfg.downsample_factor
            smask = src.ds.mask
            tmask = tgt.ds.mask
            cnt_f = overlap_mod.exact_overlap_counts(
                Rr, tr, src.ds.points, smask, tgt.ds.points, r_fine * r_fine,
                src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
                normal_cos=cfg.overlap_normal_cos)
            # co-visible normalization: aligned counts over the source points
            # inside the target's dilated occupancy at length_threshold
            bm_cv, org_cv, cell_cv = overlap_mod.build_occupancy(
                tgt.ds.points, tmask, length_threshold, cfg.overlap_grid)
            covis = overlap_mod.approx_overlap_counts(
                bm_cv, org_cv, cell_cv, Rr, tr, src.ds.points, smask,
                cfg.overlap_grid)
            denom = torch.clamp(torch.minimum(src.ds.count, tgt.ds.count),
                                min=1).to(torch.float32)
            denom_k = torch.maximum(covis.to(torch.float32),
                                    cfg.rescore_covis_floor * denom)
            ov_f = cnt_f.to(torch.float32) / denom_k
            score_f = fw * plane_frac[top_idx] + (1.0 - fw) * ov_f
            score_f = torch.where(kvalid, score_f, ninf)
            bestk = torch.argmax(score_f).reshape(1)
            best = top_idx[bestk]
            best_R = Rr[bestk][0]
            best_t = tr[bestk][0]
            rep_score = score_f[bestk][0]
            rep_overlap = ov_f[bestk][0]
        else:
            best_R = sR[best][0]
            best_t = st[best][0]
            rep_score = score[best][0]
            rep_overlap = ov[best][0]

    success = torch.any(sel_valid) & (total_matches > 0)
    Rb = torch.where(success, best_R, torch.eye(3, device=dev))
    tb = torch.where(success, best_t, torch.zeros(3, device=dev))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return RegistrationResult(
        transform=se3_matrix(Rb, tb),
        score=torch.where(success, rep_score, zero),
        overlap=torch.where(success, rep_overlap, zero),
        matched_planes=torch.where(success, sel_counts[best][0], 0)
        .to(torch.int32),
        success=success,
        match_saturated=matches.saturated,
        pen_overflow=pen_overflow,
        cluster_truncated=cluster_truncated.to(torch.int32),
    )


def _pad_size(n: int, minimum: int = 4096, maximum: int | None = None) -> int:
    size = minimum
    while size < n:
        size *= 2
    if maximum is not None:
        size = min(size, maximum)
    return size


def _as_planes(planes, pad: int, device) -> PlaneSet:
    """A PlaneSet (fields as numpy arrays or tensors) on ``device``, with
    ``point_plane`` padded with -1 (or cut) to ``pad`` rows."""
    def arr(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.array(x)
    pp = arr(planes.point_plane).astype(np.int32)
    if pp.shape[0] < pad:
        pp = np.concatenate([pp, np.full(pad - pp.shape[0], -1, np.int32)])
    return PlaneSet(
        coeffs=torch.as_tensor(arr(planes.coeffs), dtype=torch.float32,
                               device=device),
        sizes=torch.as_tensor(arr(planes.sizes), dtype=torch.int32,
                              device=device),
        count=torch.as_tensor(arr(planes.count), dtype=torch.int32,
                              device=device),
        point_plane=torch.as_tensor(pp[:pad], device=device))


def _device_of(*xs):
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return torch.device("cpu")


def register_with_planes(tgt_points, tgt_normals, src_points, src_normals,
                         tgt_planes, src_planes,
                         cfg: PladeConfig = PladeConfig(), device=None):
    """Registration given already-extracted planes — the reference's core
    overload (plade.cpp:31-580).  No target/source swap is applied.

    Points and normals are (n, 3) numpy arrays or tensors; ``*_planes``
    are PlaneSets (numpy or tensor fields, e.g. ``convert.to_numpy`` of the
    reference package's) padded to ``cfg.max_planes`` whose
    ``point_plane`` indexes the respective cloud rows.  The work runs on
    ``device``, by default the device of the first tensor among the inputs
    (else the CPU).

    Returns (transform 4x4 np.ndarray, info dict)."""
    check_supported(cfg)
    if device is None:
        device = _device_of(tgt_points, src_points, tgt_planes.coeffs,
                            src_planes.coeffs)
    device = torch.device(device)
    n_max = max(tgt_points.shape[0], src_points.shape[0])
    if n_max > cfg.max_points:
        raise ValueError(
            f"cloud size {n_max} exceeds cfg.max_points={cfg.max_points}; "
            "register_with_planes cannot subsample (plane point indices "
            "would dangle) — raise max_points or downsample the input")
    pad = _pad_size(n_max, maximum=cfg.max_points)
    tgt_cloud = pad_cloud(tgt_points, tgt_normals, pad, device)
    src_cloud = pad_cloud(src_points, src_normals, pad, device)
    tgt_planes = _as_planes(tgt_planes, pad, device)
    src_planes = _as_planes(src_planes, pad, device)
    info = {"tgt_planes": host_value(tgt_planes.count),
            "src_planes": host_value(src_planes.count)}
    if info["tgt_planes"] < cfg.min_planes or \
            info["src_planes"] < cfg.min_planes:
        info["failure"] = "too few planes"
        return np.eye(4, dtype=np.float32), info

    with _stage("spacing"):
        sp = host_value(average_spacing(src_cloud.points, src_cloud.mask,
                                        cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(sp)
    info["average_spacing"] = sp

    dsd = scalar(dp.down_sample_distance, device)
    with _stage("prepare"):
        tgt_prep = prepare_cloud(tgt_cloud, tgt_planes, dsd, cfg)
        src_prep = prepare_cloud(src_cloud, src_planes, dsd, cfg)
    dparams = (scalar(dp.scale, device), scalar(dp.length_threshold, device),
               dsd)
    result = register_pair(tgt_prep, src_prep, dparams, cfg)
    info["score"] = host_value(result.score)
    info["overlap"] = host_value(result.overlap)
    info["matched_planes"] = host_value(result.matched_planes)
    info["success"] = bool(host_value(result.success))
    info["match_saturated"] = host_value(result.match_saturated)
    info["pen_overflow"] = host_value(result.pen_overflow)
    info["cluster_truncated"] = host_value(result.cluster_truncated)
    return result.transform.cpu().numpy(), info
