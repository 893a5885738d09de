"""Pair registration (``plade_tpu/pipeline.py``).

  register_clouds / register_files: the file-level entry of the reference
                              (plade.cpp:665-707): target/source swap,
                              RANSAC plane extraction with auto-tuned (or
                              pinned) support per cloud, then the
                              registration core
  build_register_device_fn /  the device step (plade.cpp:638-662 plus the
  register_pair_device:       core) for one pair or B pairs in lockstep
                              (the reference's vmap of it): all clouds
                              extracted together, then selection, spacing,
                              preparation and registration with no host
                              read of their results; the unit the batch
                              entry (``dist/mesh.py``) runs
  prepare_cloud (per cloud):  downsample -> OBB -> per-plane geometry ->
                              plane-pair intersection lines (-> optional
                              line-confidence cull)
  register_pair:              pair-line descriptors (+ optional degraded
                              families) -> radius match -> pose hypotheses
                              -> pose clustering -> plane consistency ->
                              top candidates -> penetration filter ->
                              two-phase overlap -> pose-diverse top-K
                              rescore (short ICP, then a tight oriented
                              overlap) (-> optional final ICP)
  register_with_planes:       the core overload (plade.cpp:31-580) for
                              callers who bring their own planes

The public entries take numpy arrays or tensors and return a (4x4 numpy
transform, info dict); the device step takes padded ``Cloud``s and returns
a ``RegistrationResult`` of tensors.  ``prepare_cloud`` and
``register_pair`` take one cloud / pair or a leading axis of them; the
one-pair call is the one-pair case of the batched code.  They run on ``device``, by default
CUDA whatever the inputs are (inputs are moved there); without a CUDA
device they raise ``RuntimeError`` unless the caller passes
``device="cpu"``, which runs the kernels' plain versions.  Each public
entry is one call of the port's recorder (``utils/timing.py``), in which
its staging, the device step's set-up, every stage and its reads of the
results are spans.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .core.config import PladeConfig
from .core.ops import (drop, lift, nonzero_static, per_pair, scalar, take,
                       tree_map)
from .core.types import (BIG, Cloud, LineSet, PlaneGeometry, PlaneSet,
                         RegistrationResult, host_copy, host_value,
                         pad_cloud, se3_matrix)
from .descriptors.pairlines import degraded_descriptors, pair_descriptors
from .extract import ransac
from .geometry.lines import intersect_planes, project_points_to_plane
from .geometry.obb import compute_obb
from .dist.intra import on_group
from .geometry.voxel import voxel_downsample, voxel_downsample_by_plane
from .knn.bruteforce import ONE_DEVICE, NNPasses, average_spacing
from .match import matching
from .refine.icp import refine_icp
from .utils import timing
from .verify import overlap as overlap_mod
from .verify import penetration


def _line_confidence(lines: LineSet, geom: PlaneGeometry, dsd,
                     cfg: PladeConfig) -> torch.Tensor:
    """(L,) per-line confidence = min over the two supporting planes of
    ``|plane ds points| * dsd^2 / mean-squared line-to-plane distance``
    (ComputeMeanDistanceOfLine2Plane, util.h:389-426; confidence per
    plade.cpp:153-160): the plane's bounding corners projected onto the
    line give the span walked at ``line_conf_interval`` steps (stretched so
    that ``line_conf_samples`` cover it); each sample's squared distance to
    the nearest downsampled point of the plane is averaged.  The distances
    are plain (c, 2, S, M) blocks over chunks of c = 32 lines, as in the
    reference.  One cloud's lines, or (B, L) over a leading axis of clouds
    (``dsd`` then a number or (B,))."""
    single = lines.direction.dim() == 2
    if single:
        lines, geom = lift((lines, geom))
    S = cfg.line_conf_samples
    dev = lines.direction.device
    B = lines.direction.shape[0]
    dsd = per_pair(dsd, B, dev)[:, None]
    u = lines.direction                                      # (B, L, 3)
    p = lines.point
    sup = lines.support.to(torch.int64)                      # (B, L, 2)
    corners = take(geom.corners, sup)                        # (B, L, 2, 4, 3)
    tproj = torch.sum((corners - p[..., None, None, :])
                      * u[..., None, None, :], dim=-1)       # (B, L, 2, 4)
    lo = torch.amin(tproj, dim=-1)
    hi = torch.amax(tproj, dim=-1)
    step = torch.clamp((hi - lo) / S, min=cfg.line_conf_interval)
    pos = lo[..., None] + torch.arange(S, dtype=torch.float32, device=dev) \
        * step[..., None]                                    # (B, L, 2, S)
    smask = pos < hi[..., None]
    smask[..., 0] = True                                     # >= 1 sample
    q = p[..., None, None, :] + pos[..., None] * u[..., None, None, :]
    cnt = take(geom.ds_counts, sup)                          # (B, L, 2)
    M = geom.ds_points.shape[-2]
    L = u.shape[1]
    c = max(1, min(32, L))
    d2min = []
    for s in range(0, L, c):
        qc = q[:, s:s + c]                                   # (B, c, 2, S, 3)
        pts = take(geom.ds_points, sup[:, s:s + c])          # (B, c, 2, M, 3)
        pmask = torch.arange(M, device=dev) < cnt[:, s:s + c, :, None]
        d2 = (torch.sum(qc * qc, dim=-1)[..., None]
              - 2.0 * torch.einsum("...lksi,...lkmi->...lksm", qc, pts)
              + torch.sum(pts * pts, dim=-1)[..., None, :])  # (B, c, 2, S, M)
        d2 = torch.where(pmask[..., None, :], d2, float("inf"))
        d2min.append(torch.amin(d2, dim=-1))
    d2min = torch.cat(d2min, dim=1)                          # (B, L, 2, S)
    nsamp = torch.clamp(torch.sum(smask.to(torch.float32), dim=-1), min=1.0)
    mean_d2 = torch.sum(torch.where(smask, d2min, 0.0), dim=-1) / nsamp
    conf = cnt.to(torch.float32) * dsd[..., None] * dsd[..., None] \
        / torch.clamp(mean_d2, min=1e-12)
    conf = torch.where(cnt > 0, conf, 0.0)
    conf = torch.amin(conf, dim=-1)
    return conf[0] if single else conf


class PreparedCloud(NamedTuple):
    ds: Cloud                        # downsampled full cloud
    bounding_center: torch.Tensor    # (3,)
    bounding_radius: torch.Tensor    # ()
    planes: PlaneSet
    geom: PlaneGeometry
    lines: LineSet


def _compact_lines(lines: LineSet, keep: torch.Tensor, size: int,
                   count) -> LineSet:
    """The rows of ``lines`` (B, n, ...) where ``keep`` (B, n), front
    compacted to ``size`` rows (padding: zero direction, BIG point, support
    (0, 0)), with ``count``."""
    n = keep.shape[1]
    idx = nonzero_static(keep, size, n)
    ok = (idx < n)[..., None]
    safe = torch.clamp(idx, max=n - 1)
    return LineSet(
        direction=torch.where(ok, take(lines.direction, safe), 0.0),
        point=torch.where(ok, take(lines.point, safe), BIG),
        support=torch.where(ok, take(lines.support, safe), 0)
        .to(torch.int32),
        count=count)


def prepare_cloud(cloud: Cloud, planes: PlaneSet, dsd,
                  cfg: PladeConfig) -> PreparedCloud:
    """Downsample, OBB, per-plane geometry and plane-pair intersection lines
    of one cloud (plade.cpp:77-172); with ``cfg.min_line_confidence > 0``
    the lines under that confidence are culled (plade.cpp:144-162).  Over a
    leading axis of B clouds (the reference's vmapped preparation) when
    ``cloud`` and ``planes`` have one; ``dsd`` is then a number or (B,)."""
    single = cloud.points.dim() == 2
    if single:
        cloud, planes = lift((cloud, planes))
    dev = cloud.points.device
    B = cloud.points.shape[0]
    dsd = per_pair(dsd, B, dev)
    ds = voxel_downsample(cloud.points, cloud.mask, dsd, cfg.max_ds_points,
                          normals=cloud.normals)
    box = compute_obb(ds.points, ds.mask)
    # enclosing-sphere radius (OBB half-diagonal), see
    # PladeConfig.line_radius_factor
    sphere_radius = cfg.line_radius_factor * 0.5 \
        * torch.linalg.vector_norm(box.extents, dim=-1)

    P = planes.coeffs.shape[1]
    pts, counts = voxel_downsample_by_plane(
        cloud.points, cloud.mask, planes.point_plane, dsd, P,
        cfg.max_plane_points)
    pmasks = torch.arange(cfg.max_plane_points, device=dev) \
        < counts[..., None]
    pboxes = compute_obb(pts, pmasks)
    corners = project_points_to_plane(pboxes.corners[..., :4, :],
                                      planes.coeffs[..., None, :])
    centers = 0.5 * (corners[..., 0, :] + corners[..., 2, :])
    radii = 0.5 * torch.linalg.vector_norm(
        corners[..., 0, :] - corners[..., 2, :], dim=-1)
    geom = PlaneGeometry(ds_points=pts, ds_counts=counts, corners=corners,
                         centers=centers, radii=radii)

    # plane-pair intersection lines (plade.cpp:130-172)
    coeffs = planes.coeffs
    direction, point, lvalid = intersect_planes(
        coeffs[:, :, None, :].expand(B, P, P, 4),
        coeffs[:, None, :, :].expand(B, P, P, 4), cfg.plane_pair_max_cos)
    pm = planes.mask
    ar = torch.arange(P, device=dev)
    lvalid = lvalid & (ar[None, :] > ar[:, None]) & pm[:, :, None] \
        & pm[:, None, :]
    # lines far from the bounding center are dropped (plade.cpp:137-142,
    # radius relaxed to the enclosing sphere)
    w = point - box.center[:, None, None, :]
    along = torch.sum(w * direction, dim=-1)
    dist = torch.sqrt(torch.clamp(torch.sum(w * w, -1) - along * along,
                                  min=0.0))
    lvalid = lvalid & (dist <= sphere_radius[:, None, None])

    flat = lvalid.reshape(B, P * P)
    ii = ar[:, None].expand(P, P).reshape(-1)
    all_lines = LineSet(direction=direction.reshape(B, P * P, 3),
                        point=point.reshape(B, P * P, 3),
                        support=torch.stack([ii, ar.repeat(P)], -1)
                        .expand(B, P * P, 2), count=None)
    lines = _compact_lines(
        all_lines, flat, cfg.max_lines,
        torch.clamp(torch.sum(flat.to(torch.int32), dim=1),
                    max=cfg.max_lines).to(torch.int32))
    if cfg.min_line_confidence > 0.0:
        # line-confidence cull (the reference computes the confidence but
        # ships the cull commented out; see PladeConfig.min_line_confidence)
        conf = _line_confidence(lines, geom, dsd, cfg)
        keep2 = lines.mask & (conf >= cfg.min_line_confidence)
        lines = _compact_lines(lines, keep2, cfg.max_lines,
                               torch.sum(keep2, dim=1, dtype=torch.int32))
    out = PreparedCloud(ds=ds, bounding_center=box.center,
                        bounding_radius=sphere_radius, planes=planes,
                        geom=geom, lines=lines)
    return drop(out) if single else out


def register_pair(tgt: PreparedCloud, src: PreparedCloud, dparams,
                  cfg: PladeConfig,
                  nn: NNPasses = ONE_DEVICE) -> RegistrationResult:
    """Register two prepared clouds; ``dparams`` = (scale,
    length_threshold, down_sample_distance) as float32 0-d tensors.  With
    a leading axis of P pairs on both prepared clouds (``dparams`` then
    (P,) tensors or numbers) every stage runs once for all pairs and the
    result has the axis too: the reference's ``jax.vmap`` of its pair
    registration, each host loop run to the slowest pair with the finished
    pairs frozen.  K1 and K2 (overlap phase 2, the rescore, the final ICP)
    are ``nn``'s."""
    single = tgt.ds.points.dim() == 2
    if single:
        tgt, src = lift((tgt, src))
    P = tgt.ds.points.shape[0]
    dev = tgt.ds.points.device
    scale, length_threshold, dsd = (per_pair(x, P, dev) for x in dparams)
    ninf = -float("inf")
    cos10 = math.cos(cfg.line_pair_min_angle)
    with timing.stage("descriptors"):
        tgt_desc = pair_descriptors(
            tgt.lines, tgt.planes.coeffs[..., :3], scale,
            cfg.max_target_pairs, ordered=True, min_angle_cos=cos10,
            pad_value=-1e6)
        src_desc = pair_descriptors(
            src.lines, src.planes.coeffs[..., :3], scale, cfg.max_query_pairs,
            ordered=False, min_angle_cos=cos10, pad_value=1e6)

    with timing.stage("match"):
        matches = matching.match_descriptors(
            src_desc, tgt_desc, cfg.descriptor_match_radius, cfg.max_matches,
            per_query=cfg.match_per_query)
        R, t = matching.hypothesis_poses(src_desc, tgt_desc, matches)
        hyp_valid = matches.valid
        total_matches = torch.clamp(matches.count, max=cfg.max_matches)
        if cfg.enable_degraded_families:
            # the 22-21 / 22-12 degraded 6-D families only add hypotheses;
            # the three segments are stitched front-compacted so clustering
            # sees every live one (see plade_tpu/pipeline.py)
            segments = [(R, t, matches.count)]
            for fam in ("2221", "2212"):
                tgt_d6 = degraded_descriptors(
                    tgt.lines, tgt.planes.coeffs[..., :3], scale,
                    cfg.max_target_pairs, ordered=True, min_angle_cos=cos10,
                    family=fam, pad_value=-1e6)
                src_d6 = degraded_descriptors(
                    src.lines, src.planes.coeffs[..., :3], scale,
                    cfg.max_query_pairs, ordered=False, min_angle_cos=cos10,
                    family=fam, pad_value=1e6)
                m6 = matching.match_descriptors(
                    src_d6, tgt_d6, cfg.descriptor_match_radius,
                    cfg.max_degraded_matches, per_query=cfg.match_per_query)
                R6, t6 = matching.hypothesis_poses(src_d6, tgt_d6, m6)
                segments.append((R6, t6, m6.count))
            R, t, hyp_valid, total_matches = matching.stitch_hypotheses(
                segments)

    with timing.stage("cluster"):
        # cluster at half the length/angle thresholds (util.cpp:331) over the
        # front-compacted prefix; overflow is counted (cluster_truncated)
        euler_tol = math.sqrt(cfg.angle_threshold / 2.0)
        HB = min(cfg.max_cluster_hypotheses, R.shape[1])
        cluster_truncated = torch.clamp(total_matches - HB, min=0)
        clusters = matching.cluster_poses(
            R[:, :HB], t[:, :HB], hyp_valid[:, :HB], length_threshold / 2.0,
            euler_tol, cfg.max_pose_clusters)
        rep = clusters.rep.to(torch.int64)
        cR = take(R, rep)
        ct = take(t, rep)

    with timing.stage("consistency"):
        counts, _ = matching.plane_consistency(
            cR, ct, clusters.valid,
            src.planes.coeffs, src.geom.centers, src.geom.radii,
            src.planes.mask,
            tgt.planes.coeffs, tgt.geom.centers, tgt.geom.radii,
            tgt.planes.mask,
            src.bounding_center, tgt.bounding_center,
            tgt.bounding_radius, length_threshold,
            math.cos(cfg.angle_threshold))

        C = counts.shape[1]
        sel, sel_valid = matching.select_candidates(
            counts, torch.arange(C, dtype=torch.int32, device=dev),
            cfg.max_candidate_results)
        sel = sel.to(torch.int64)
        sR = take(cR, sel)
        st = take(ct, sel)
        sel_counts = torch.gather(counts, 1, sel)

    with timing.stage("penetration"):
        pen_overflow = torch.zeros((P,), dtype=torch.int32, device=dev)
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

    with timing.stage("overlap"):
        plane_frac = sel_counts.to(torch.float32) / torch.clamp(
            src.planes.count.to(torch.float32), min=1.0)[:, None]
        ov, ov_approx = overlap_mod.overlap_scores(
            sR, st, sel_valid, src.ds.points, src.ds.count,
            tgt.ds.points, tgt.ds.count, dsd,
            plane_frac=plane_frac, face_weight=cfg.face_matches_weight,
            exact_k=cfg.overlap_exact_k, grid=cfg.overlap_grid,
            src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
            normal_cos=cfg.overlap_normal_cos, nn=nn)
        fw = cfg.face_matches_weight
        score = fw * plane_frac + (1.0 - fw) * ov
        score = torch.where(sel_valid, score, ninf)
        # (P, 1) index tensors throughout: indexing with a 0-d tensor would
        # read it on the host
        best = torch.argmax(score, dim=1, keepdim=True)

    with timing.stage("rescore"):
        if cfg.rescore_top_k > 0:
            # tight-radius rescore of the top-K pose-distinct coarse candidates
            # (a framework addition of the reference package; see
            # plade_tpu/pipeline.py for the rationale), K greedy picks per
            # pair
            K = cfg.rescore_top_k
            rank_score = torch.where(sel_valid, fw * plane_frac
                                     + (1.0 - fw) * ov_approx, ninf)
            C2 = score.shape[1]
            cosag = torch.einsum("...aij,...bij->...ab", sR, sR)  # tr(RaRb^T)
            near_pose = (torch.linalg.vector_norm(
                st[:, :, None, :] - st[:, None, :, :], dim=-1)
                < length_threshold[:, None, None]) \
                & (cosag > 1.0 + 2.0 * math.cos(2.0 * cfg.angle_threshold))
            banned = torch.zeros((P, C2), dtype=torch.bool, device=dev)
            picks = []
            for _ in range(K):
                avail = (rank_score > ninf) & ~banned
                i = torch.argmax(torch.where(avail, rank_score, ninf), dim=1,
                                 keepdim=True)
                ok = torch.gather(avail, 1, i)
                picks.append(torch.where(ok, i, C2))
                banned = banned | (take(near_pose, i)[:, 0] & ok)
                banned.scatter_(1, i, True)
            sel_k = torch.cat(picks, dim=1)
            kvalid = sel_k < C2
            top_idx = torch.clamp(sel_k, max=C2 - 1)
            # re-center each picked pose with a short point-to-plane ICP, all
            # modes of all pairs batched: one K2 launch per nearest-neighbour
            # pass
            icp_sub = max(1, cfg.rescore_icp_subsample)
            Rr, tr, _, _ = refine_icp(
                take(sR, top_idx), take(st, top_idx),
                src.ds.points[:, ::icp_sub], src.ds.mask[:, ::icp_sub],
                tgt.ds.points, tgt.ds.normals, dsd, cfg.rescore_icp_iters,
                nn)
            r_fine = cfg.rescore_radius_factor * dsd / cfg.downsample_factor
            smask = src.ds.mask
            tmask = tgt.ds.mask
            cnt_f = overlap_mod.exact_overlap_counts(
                Rr, tr, src.ds.points, smask, tgt.ds.points, r_fine * r_fine,
                src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
                normal_cos=cfg.overlap_normal_cos, nn=nn)
            # co-visible normalization: aligned counts over the source points
            # inside the target's dilated occupancy at length_threshold
            bm_cv, org_cv, cell_cv = overlap_mod.build_occupancy(
                tgt.ds.points, tmask, length_threshold, cfg.overlap_grid)
            covis = overlap_mod.approx_overlap_counts(
                bm_cv, org_cv, cell_cv, Rr, tr, src.ds.points, smask,
                cfg.overlap_grid)
            denom = torch.clamp(torch.minimum(src.ds.count, tgt.ds.count),
                                min=1).to(torch.float32)[:, None]
            denom_k = torch.maximum(covis.to(torch.float32),
                                    cfg.rescore_covis_floor * denom)
            ov_f = cnt_f.to(torch.float32) / denom_k
            score_f = fw * torch.gather(plane_frac, 1, top_idx) \
                + (1.0 - fw) * ov_f
            score_f = torch.where(kvalid, score_f, ninf)
            bestk = torch.argmax(score_f, dim=1, keepdim=True)
            best = torch.gather(top_idx, 1, bestk)
            best_R = take(Rr, bestk)[:, 0]
            best_t = take(tr, bestk)[:, 0]
            rep_score = torch.gather(score_f, 1, bestk)[:, 0]
            rep_overlap = torch.gather(ov_f, 1, bestk)[:, 0]
        else:
            best_R = take(sR, best)[:, 0]
            best_t = take(st, best)[:, 0]
            rep_score = torch.gather(score, 1, best)[:, 0]
            rep_overlap = torch.gather(ov, 1, best)[:, 0]

    success = torch.any(sel_valid, dim=1) & (total_matches > 0)
    Rb = torch.where(success[:, None, None], best_R, torch.eye(3, device=dev))
    tb = torch.where(success[:, None], best_t, torch.zeros(3, device=dev))
    if cfg.enable_icp:
        with timing.stage("icp"):
            # point-to-plane refinement of the winning pose over the full
            # downsampled source (a framework addition of the reference
            # package): one K2 launch per iteration and one after, for all
            # pairs
            max_corr = cfg.icp_max_corr_factor * dsd / cfg.downsample_factor
            Ri, ti, _, _ = refine_icp(
                Rb[:, None], tb[:, None], src.ds.points, src.ds.mask,
                tgt.ds.points, tgt.ds.normals, max_corr, cfg.icp_iters,
                nn)
            Rb = torch.where(success[:, None, None], Ri[:, 0], Rb)
            tb = torch.where(success[:, None], ti[:, 0], tb)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = RegistrationResult(
        transform=se3_matrix(Rb, tb),
        score=torch.where(success, rep_score, zero),
        overlap=torch.where(success, rep_overlap, zero),
        matched_planes=torch.where(success, torch.gather(
            sel_counts, 1, best)[:, 0], 0).to(torch.int32),
        success=success,
        match_saturated=matches.saturated,
        pen_overflow=pen_overflow,
        cluster_truncated=cluster_truncated.to(torch.int32),
    )
    return drop(out) if single else out


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


def _run_device(device) -> torch.device:
    """The device an entry point runs on: ``device``, by default CUDA.
    Raises ``RuntimeError`` for CUDA when no CUDA device is available,
    rather than running on the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "plade_tpu_torch runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU')
    return device


def _register_planes(tgt_cloud: Cloud, src_cloud: Cloud,
                     tgt_planes: PlaneSet, src_planes: PlaneSet,
                     cfg: PladeConfig, device, info: dict):
    """Spacing, preparation and pair registration of two padded clouds
    with their planes; fills ``info`` and returns the 4x4 numpy transform
    (identity with ``info["failure"]`` when a cloud has too few planes)."""
    with timing.stage("entry.read_out"):
        info["tgt_planes"] = host_value(tgt_planes.count)
        info["src_planes"] = host_value(src_planes.count)
    if info["tgt_planes"] < cfg.min_planes or \
            info["src_planes"] < cfg.min_planes:
        # too few planes (plade.cpp:646-657)
        info["failure"] = "too few planes"
        return np.eye(4, dtype=np.float32)

    # parameters derived from the source cloud's spacing (plade.cpp:41-56)
    with timing.stage("spacing"):
        sp = host_value(average_spacing(src_cloud.points, src_cloud.mask,
                                        cfg.spacing_k, cfg.spacing_samples))
    dp = cfg.derived(sp)
    info["average_spacing"] = sp

    dsd = scalar(dp.down_sample_distance, device)
    with timing.stage("prepare"):
        tgt_prep = prepare_cloud(tgt_cloud, tgt_planes, dsd, cfg)
        src_prep = prepare_cloud(src_cloud, src_planes, dsd, cfg)
    dparams = (scalar(dp.scale, device), scalar(dp.length_threshold, device),
               dsd)
    result = register_pair(tgt_prep, src_prep, dparams, cfg)
    with timing.stage("entry.read_out"):
        info["score"] = host_value(result.score)
        info["overlap"] = host_value(result.overlap)
        info["matched_planes"] = host_value(result.matched_planes)
        info["success"] = bool(host_value(result.success))
        info["match_saturated"] = host_value(result.match_saturated)
        info["pen_overflow"] = host_value(result.pen_overflow)
        info["cluster_truncated"] = host_value(result.cluster_truncated)
        return host_copy(result.transform).numpy()


def register_with_planes(tgt_points, tgt_normals, src_points, src_normals,
                         tgt_planes, src_planes,
                         cfg: PladeConfig = PladeConfig(), device=None):
    """Registration given already-extracted planes — the reference's core
    overload (plade.cpp:31-580).  No target/source swap is applied.

    Points and normals are (n, 3) numpy arrays or tensors; ``*_planes``
    are PlaneSets (numpy or tensor fields, e.g. ``convert.to_numpy`` of the
    reference package's) padded to ``cfg.max_planes`` whose
    ``point_plane`` indexes the respective cloud rows.  The work runs on
    ``device``, by default CUDA (``device="cpu"`` for the CPU); the inputs
    are moved there.

    Returns (transform 4x4 np.ndarray, info dict)."""
    device = _run_device(device)
    n_max = max(tgt_points.shape[0], src_points.shape[0])
    if n_max > cfg.max_points:
        raise ValueError(
            f"cloud size {n_max} exceeds cfg.max_points={cfg.max_points}; "
            "register_with_planes cannot subsample (plane point indices "
            "would dangle) — raise max_points or downsample the input")
    pad = _pad_size(n_max, maximum=cfg.max_points)
    with timing.call("register_with_planes", 1):
        with timing.stage("entry.stage_in"):
            tgt_cloud = pad_cloud(tgt_points, tgt_normals, pad, device)
            src_cloud = pad_cloud(src_points, src_normals, pad, device)
            planes = (_as_planes(tgt_planes, pad, device),
                      _as_planes(src_planes, pad, device))
        info = {}
        T = _register_planes(tgt_cloud, src_cloud, *planes, cfg, device,
                             info)
    return T, info


def _cap_cloud(points, normals, max_points: int, seed: int = 0):
    """Uniform random subsample when a cloud exceeds the static-shape budget
    (``cfg.max_points``), drawn by numpy from ``seed`` as in the reference
    package.  Returns (points, normals, capped)."""
    n = points.shape[0]
    if n <= max_points:
        return points, normals, False
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=max_points, replace=False))
    return points[idx], normals[idx], True


def _generators(seed: int, device) -> list:
    """One ``torch.Generator`` per cloud (target, source) on ``device``,
    seeded from ``seed`` through numpy's SeedSequence."""
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in np.random.SeedSequence(seed).generate_state(2)]


def build_register_device_fn(cfg: PladeConfig, num_points: int,
                             with_stats: bool = False, device=None,
                             intra=()):
    """The full-pipeline step for clouds padded to ``num_points`` rows, on
    ``device`` (by default CUDA): the reference's
    ``build_register_device_fn`` (the core ``registration`` overload,
    plade.cpp:638-662, extraction with auto-tuning and the failure below
    ``min_planes``, then the pipeline of plade.cpp:31-580), and over a
    batch of pairs its ``jax.vmap``.

    Returns ``step(tgt, src, seed, draws=None)``.  For one pair: padded
    ``Cloud``s in (moved to the device), a ``RegistrationResult`` of device
    tensors out, or ``(result, stats)`` with ``with_stats`` (``stats`` the
    per-cloud ``ExtractStats``, leading axis (target, source)).  For B
    pairs in lockstep: ``Cloud``s with a leading pair axis, a sequence of
    B seeds, every output with the leading pair axis (``stats`` (B, 2)).
    All 2B clouds are extracted in lockstep, with one draw generator each,
    derived from its pair's seed as :func:`register_clouds` derives them
    (``draws``, a list of 2B ``draws(state)`` functions in the order
    target 0, source 0, target 1, ..., replaces them); every later stage
    runs once for all pairs.  Plane counts, spacing and the derived radii
    stay on the device, one per pair; the registration runs whether or not
    both clouds have ``min_planes`` planes, and a pair's result is masked
    to identity (``success`` False) when not, the other pairs unaffected.
    No target/source swap and no cap: the caller pads.

    ``device`` is the home of the pairs' group and ``intra`` lists the
    group's other devices (``()``: none; a device may repeat): the spacing's
    top-k and every K1 and K2 launch split their query rows over the group
    (``dist/intra.on_group``), and every other stage runs on ``device``.
    The result is the one-device step's, bit for bit.  Groups of distinct
    cards have not been run yet."""
    device = _run_device(device)
    nn = on_group([device, *(_run_device(d) for d in intra)])

    def step(tgt_cloud: Cloud, src_cloud: Cloud, seed, draws=None):
        single = tgt_cloud.points.dim() == 2
        if single:
            tgt_cloud, src_cloud = lift((tgt_cloud, src_cloud))
            seed = [seed]
        B = tgt_cloud.points.shape[0]
        if len(seed) != B or (draws is not None and len(draws) != 2 * B):
            raise ValueError(f"step: {B} pairs, {len(seed)} seeds, "
                             f"{None if draws is None else len(draws)} draws")
        with timing.stage("step.setup"):
            # the clouds' axis: the B targets, then the B sources
            clouds = Cloud(*(torch.cat([a, b]).to(device)
                             for a, b in zip(tgt_cloud, src_cloud)))
            gens = [g for s in seed for g in _generators(int(s), device)]
        order = list(range(0, 2 * B, 2)) + list(range(1, 2 * B, 2))
        with timing.stage("extract"):
            planes, stats = ransac._cached_extractor(cfg, num_points)(
                clouds.points, clouds.normals, clouds.count,
                cfg.ransac_min_allowed_support,
                generator=[gens[k] for k in order],
                draws=None if draws is None else [draws[k] for k in order])
            planes = ransac.select_planes_device(planes, cfg)
        enough = (planes.count[:B] >= cfg.min_planes) \
            & (planes.count[B:] >= cfg.min_planes)
        # parameters derived from each source cloud's spacing
        # (plade.cpp:41-56), float32 on the device
        with timing.stage("spacing"):
            sp = average_spacing(clouds.points[B:], clouds.mask[B:],
                                 cfg.spacing_k, cfg.spacing_samples, nn)
        dsd = cfg.downsample_factor * sp
        lt = cfg.length_factor * sp
        scale = lt / math.cos(math.pi / 2 - cfg.angle_threshold)
        with timing.stage("prepare"):
            prep = prepare_cloud(clouds, planes, torch.cat([dsd, dsd]), cfg)
        res = register_pair(tree_map(lambda x: x[:B], prep),
                            tree_map(lambda x: x[B:], prep),
                            (scale, lt, dsd), cfg, nn)
        success = res.success & enough
        zero = torch.zeros((), dtype=torch.float32, device=device)
        out = RegistrationResult(
            transform=torch.where(success[:, None, None], res.transform,
                                  torch.eye(4, device=device)),
            score=torch.where(success, res.score, zero),
            overlap=torch.where(success, res.overlap, zero),
            matched_planes=torch.where(success, res.matched_planes, 0)
            .to(torch.int32),
            success=success,
            match_saturated=res.match_saturated,
            pen_overflow=res.pen_overflow,
            cluster_truncated=res.cluster_truncated)
        # (2B,) -> (B, 2): (target, source) per pair
        stats = ransac.ExtractStats(*(x.reshape(2, B).T for x in stats))
        if single:
            out, stats = drop((out, stats))
        return (out, stats) if with_stats else out

    return step


@functools.lru_cache(maxsize=8)
def register_pair_device(cfg: PladeConfig, num_points: int, device=None,
                         intra=()):
    """The device step of :func:`build_register_device_fn`, cached per
    config, cloud size, device and the group's other devices (``intra``, a
    tuple): one pair, or a batch of pairs in lockstep."""
    return build_register_device_fn(cfg, num_points, device=device,
                                    intra=intra)


def register_clouds(tgt_points, tgt_normals, src_points, src_normals,
                    cfg: PladeConfig = PladeConfig(), seed: int = 0,
                    ransac_min_support=None, device=None):
    """Register source onto target from raw clouds (numpy arrays or
    tensors).

    Mirrors the file-level reference entry (plade.cpp:665-707): swaps
    target/source when the source is >= 1.2x larger (the result is inverted
    back), caps each cloud at ``cfg.max_points``, extracts planes with the
    auto-tuned support (random draws from generators seeded by ``seed``),
    then registers.  The work runs on ``device``, by default CUDA
    (``device="cpu"`` for the CPU); the inputs are moved there.

    ``ransac_min_support`` mirrors the explicit-min-support overload
    (plade.cpp:583-599): an int or a (target, source) pair pins the RANSAC
    support (floor and start of the extraction) instead of auto-tuning,
    and every extracted plane is kept (``select_planes_pinned``).

    Returns (transform 4x4 np.ndarray, info dict)."""
    device = _run_device(device)
    with timing.call("register_clouds", 1):
        with timing.stage("entry.stage_in"):
            swapped = False
            if src_points.shape[0] >= \
                    tgt_points.shape[0] * cfg.swap_size_ratio:
                tgt_points, src_points = src_points, tgt_points
                tgt_normals, src_normals = src_normals, tgt_normals
                swapped = True
            tgt_points, tgt_normals, tgt_capped = _cap_cloud(
                tgt_points, tgt_normals, cfg.max_points, seed)
            src_points, src_normals, src_capped = _cap_cloud(
                src_points, src_normals, cfg.max_points, seed + 1)
            pad = _pad_size(max(tgt_points.shape[0], src_points.shape[0]),
                            maximum=cfg.max_points)
            tgt_cloud = pad_cloud(tgt_points, tgt_normals, pad, device)
            src_cloud = pad_cloud(src_points, src_normals, pad, device)

        if ransac_min_support is None:
            pinned = (None, None)
        elif isinstance(ransac_min_support, int):
            pinned = (ransac_min_support,) * 2
        else:
            pinned = tuple(ransac_min_support)
        if swapped:
            pinned = pinned[::-1]
        planes = []
        for cloud, gen, m in zip((tgt_cloud, src_cloud),
                                 _generators(seed, device), pinned):
            with timing.stage("extract"):
                if m is None:
                    planes.append(ransac.auto_extract(
                        cloud.points, cloud.normals, cloud.count, cfg, pad,
                        generator=gen))
                else:
                    # pinned support: the floor and start of the
                    # extraction, no auto-tune halving, no threshold
                    # re-selection
                    planes.append(ransac.select_planes_pinned(
                        ransac._cached_extractor(cfg, pad)(
                            cloud.points, cloud.normals, cloud.count, m,
                            generator=gen, init_support=m)[0], cfg))

        info = {"swapped": swapped}
        if tgt_capped or src_capped:
            info["cloud_capped"] = {"target": tgt_capped,
                                    "source": src_capped,
                                    "max_points": cfg.max_points}
        T = _register_planes(tgt_cloud, src_cloud, *planes, cfg, device,
                             info)
    if swapped:
        T = np.linalg.inv(T)
    return T, info


def register_files(target_file: str, source_file: str,
                   cfg: PladeConfig = PladeConfig(), seed: int = 0,
                   device=None):
    """File-level entry (reference plade.cpp:665-707; PLY only): reads
    both files and calls :func:`register_clouds` on ``device`` (by default
    CUDA)."""
    from .io.ply import read_ply
    with timing.call("register_files", 1):
        tp, tn = read_ply(target_file)
        sp_, sn = read_ply(source_file)
        if tn is None or sn is None:
            raise ValueError(
                "registration requires point normals in both clouds")
        return register_clouds(tp, tn, sp_, sn, cfg, seed, device=device)
