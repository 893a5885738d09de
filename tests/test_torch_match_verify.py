"""The port's descriptors, matching, clustering, verification and ICP
against the reference package, stage by stage on one real scene (the
``test_register_with_planes_overload`` pair, planes from the reference's
extractor): each port stage gets the reference's inputs, converted through
numpy, and is held to the reference's outputs.

Tolerances, with their reasons:

* integer outputs (counts, indices, verdicts, bitmaps) are compared
  exactly: the float inputs they threshold are the same arrays;
* float outputs of closed forms agree to 1e-5 (1e-4 for coordinates a few
  units from the origin);
* match results are compared as sets: the compacted buffer is ordered by
  query row and then distance rank, and a near-tie can reorder it;
* exact overlap counts: the port takes distances in the kernels'
  difference form and the reference's CPU path in the expansion form, so
  points within rounding of the radius may count differently: at most
  0.5% of the source points per candidate; against float64, whose
  transformed points round differently, at most 0.1%;
* refine_icp: R and t within 1e-4 (three Gauss-Newton steps, each a 6x6
  solve and two SVD projections, in float32).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.descriptors import pairlines as jpl
from plade_tpu.extract import ransac
from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu.knn.bruteforce import average_spacing
from plade_tpu.match import matching as jm
from plade_tpu.pipeline import _pad_size, prepare_cloud
from plade_tpu.refine import icp as jicp
from plade_tpu.verify import overlap as jov
from plade_tpu.verify import penetration as jpen
from plade_tpu_torch.core.convert import from_numpy
from plade_tpu_torch.descriptors import pairlines
from plade_tpu_torch.match import matching
from plade_tpu_torch.refine import icp
from plade_tpu_torch.verify import overlap, penetration
from test_pipeline import SMALL_CFG

CFG = SMALL_CFG


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(_n(got), _n(want), rtol=0, atol=atol)


def _eq(got, want):
    np.testing.assert_array_equal(_n(got), _n(want))


def _stages(tgt, src, scale, lt):
    """The reference's register_pair stages up to the penetration tests
    (pipeline.py:197-279), returning every intermediate."""
    s = {}
    cos10 = math.cos(CFG.line_pair_min_angle)
    s["tgt_desc"] = jpl.pair_descriptors(
        tgt.lines, tgt.planes.coeffs[:, :3], scale, CFG.max_target_pairs,
        ordered=True, min_angle_cos=cos10, pad_value=-1e6)
    s["src_desc"] = jpl.pair_descriptors(
        src.lines, src.planes.coeffs[:, :3], scale, CFG.max_query_pairs,
        ordered=False, min_angle_cos=cos10, pad_value=1e6)
    s["matches"] = m = jm.match_descriptors(
        s["src_desc"], s["tgt_desc"], CFG.descriptor_match_radius,
        CFG.max_matches, per_query=CFG.match_per_query)
    s["R"], s["t"] = jm.hypothesis_poses(s["src_desc"], s["tgt_desc"], m)
    HB = min(CFG.max_cluster_hypotheses, s["R"].shape[0])
    s["cluster_args"] = (s["R"][:HB], s["t"][:HB], m.valid[:HB], lt / 2.0)
    s["clusters"] = cl = jm.cluster_poses(*s["cluster_args"], *_CL_STATIC)
    cR, ct = s["R"][cl.rep], s["t"][cl.rep]
    s["pc_args"] = (
        cR, ct, cl.valid,
        src.planes.coeffs, src.geom.centers, src.geom.radii, src.planes.mask,
        tgt.planes.coeffs, tgt.geom.centers, tgt.geom.radii, tgt.planes.mask,
        src.bounding_center, tgt.bounding_center, tgt.bounding_radius, lt)
    s["counts"], _ = jm.plane_consistency(*s["pc_args"], _COS_ANGLE)
    C = s["counts"].shape[0]
    sel, s["sel_valid"] = jm.select_candidates(
        s["counts"], jnp.arange(C, dtype=jnp.int32), CFG.max_candidate_results)
    s["sR"], s["st"] = cR[sel], ct[sel]
    s["bt_args"] = (
        s["sR"], s["st"], s["sel_valid"],
        src.planes.coeffs, src.geom.corners, src.geom.centers,
        src.planes.mask,
        tgt.planes.coeffs, tgt.geom.corners, tgt.geom.centers,
        tgt.planes.mask, lt)
    s["tests"] = jpen.build_tests(*s["bt_args"], CFG.angle_threshold,
                                  max_tests=CFG.max_penetration_tests)
    return s


_CL_STATIC = (math.sqrt(CFG.angle_threshold / 2.0), CFG.max_pose_clusters)
_COS_ANGLE = math.cos(CFG.angle_threshold)


@pytest.fixture(scope="module")
def scene():
    """The reference's prepared clouds and its register_pair stages on the
    scene, run as one jitted program (eager dispatch is slower)."""
    rng = np.random.default_rng(0)
    pts, nrm, _ = make_room(rng, n_per_plane=1200, noise=0.002,
                            extra_planes=2)
    R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    pad = _pad_size(max(pts.shape[0], spts.shape[0]))
    tc = jpad_cloud(pts, nrm, pad)
    sc = jpad_cloud(spts, snrm, pad)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp = ransac.auto_extract(tc.points, tc.normals, tc.count, k1, CFG, pad)
    sp = ransac.auto_extract(sc.points, sc.normals, sc.count, k2, CFG, pad)
    dp = CFG.derived(float(average_spacing(sc.points, sc.mask, CFG.spacing_k,
                                           CFG.spacing_samples)))
    s = dict(R_gt=R, t_gt=t,
             scale=jnp.float32(dp.scale), lt=jnp.float32(dp.length_threshold),
             dsd=jnp.float32(dp.down_sample_distance))
    s["tgt"] = prepare_cloud(tc, tp, s["dsd"], CFG)
    s["src"] = prepare_cloud(sc, sp, s["dsd"], CFG)
    s.update(jax.jit(_stages)(s["tgt"], s["src"], s["scale"], s["lt"]))
    s["cluster_args"] = s["cluster_args"] + _CL_STATIC
    s["pc_args"] = s["pc_args"] + (_COS_ANGLE,)
    s["bt_args"] = s["bt_args"] + (CFG.angle_threshold,)
    src, tgt = s["src"], s["tgt"]
    s["rt_args"] = (src.geom.ds_points, src.geom.ds_counts,
                    tgt.geom.ds_points, tgt.geom.ds_counts,
                    src.planes.coeffs, tgt.planes.coeffs)
    s["rt_kw"] = dict(search_radius=s["lt"],
                      min_points=CFG.penetration_min_points,
                      min_distance=s["lt"] / 2.0,
                      n_samples=CFG.penetration_samples,
                      max_ratio=CFG.penetration_ratio)
    return s


def _port(x):
    return from_numpy(x)


@pytest.mark.parametrize("side", ["target", "query"])
def test_pair_descriptors_match(scene, side):
    prep = scene["tgt" if side == "target" else "src"]
    want = scene["tgt_desc" if side == "target" else "src_desc"]
    got = pairlines.pair_descriptors(
        _port(prep.lines), _port(prep.planes.coeffs[:, :3]),
        _port(scene["scale"]),
        CFG.max_target_pairs if side == "target" else CFG.max_query_pairs,
        ordered=side == "target",
        min_angle_cos=math.cos(CFG.line_pair_min_angle),
        pad_value=-1e6 if side == "target" else 1e6)
    assert int(got.count) == int(want.count) > 0
    _eq(got.line_idx, want.line_idx)
    _close(got.desc, want.desc)
    _close(got.line_vec1, want.line_vec1)
    _close(got.line_vec2, want.line_vec2)
    _close(got.anchor, want.anchor, atol=1e-4)


def _match_set(m):
    v = _n(m.valid)
    return set(zip(_n(m.q_idx)[v].tolist(), _n(m.t_idx)[v].tolist()))


def test_match_descriptors_sets_match(scene):
    want = scene["matches"]
    got = matching.match_descriptors(
        _port(scene["src_desc"]), _port(scene["tgt_desc"]),
        CFG.descriptor_match_radius, CFG.max_matches,
        per_query=CFG.match_per_query)
    assert int(got.count) == int(want.count) > 0
    assert int(got.saturated) == int(want.saturated) == 0
    _eq(got.valid, want.valid)
    assert _match_set(got) == _match_set(want)


def test_hypothesis_poses_match(scene):
    R, t = matching.hypothesis_poses(_port(scene["src_desc"]),
                                     _port(scene["tgt_desc"]),
                                     _port(scene["matches"]))
    _close(R, scene["R"])
    _close(t, scene["t"], atol=1e-4)


def test_cluster_poses_match(scene):
    want = scene["clusters"]
    a = scene["cluster_args"]
    got = matching.cluster_poses(_port(a[0]), _port(a[1]), _port(a[2]),
                                 _port(a[3]), a[4], a[5])
    _eq(got.valid, want.valid)
    _eq(got.size, want.size)
    _eq(got.rep, want.rep)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_poses_match_random(seed):
    """Random pose sets with many equal-size clusters: sizes, ranking ties
    (lower root first) and representatives as in the reference."""
    rng = np.random.default_rng(seed)
    H = 96
    centers = rng.uniform(-1, 1, size=(12, 3)).astype(np.float32)
    t = (centers[rng.integers(0, 12, size=H)]
         + rng.normal(scale=0.02, size=(H, 3))).astype(np.float32)
    ang = rng.uniform(-0.3, 0.3, size=H)
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]] for a in ang]).astype(np.float32)
    valid = rng.uniform(size=H) < 0.9
    want = jm.cluster_poses(jnp.asarray(R), jnp.asarray(t),
                            jnp.asarray(valid), 0.1, 0.5, max_clusters=32)
    got = matching.cluster_poses(_t(R), _t(t), _t(valid), 0.1, 0.5,
                                 max_clusters=32)
    for f in ("rep", "size", "valid"):
        _eq(getattr(got, f), getattr(want, f))


def test_cluster_poses_chunked_adjacency_matches_full(monkeypatch):
    """The row-chunked adjacency (taken above FULL_ADJACENCY_MAX
    hypotheses) gives the clusters of the whole one."""
    rng = np.random.default_rng(3)
    H = 300
    t = rng.uniform(-1, 1, size=(H, 3)).astype(np.float32) * 0.3
    R = np.stack([np.eye(3, dtype=np.float32)] * H)
    valid = rng.uniform(size=H) < 0.9
    args = (_t(R), _t(t), _t(valid), 0.08, 0.5, 64)
    full = matching.cluster_poses(*args)
    monkeypatch.setattr(matching, "FULL_ADJACENCY_MAX", 100)
    chunked = matching.cluster_poses(*args, chunk=64)
    for f in ("rep", "size", "valid"):
        _eq(getattr(chunked, f), getattr(full, f))
    assert int(full.valid.sum()) > 5


def test_plane_consistency_and_selection_match(scene):
    counts, pair_mask = matching.plane_consistency(
        *[_port(x) if not isinstance(x, float) else x
          for x in scene["pc_args"]])
    want_counts, want_mask = jm.plane_consistency(*scene["pc_args"])
    _eq(counts, want_counts)
    _eq(pair_mask, want_mask)
    C = counts.shape[0]
    sel, sel_valid = matching.select_candidates(
        counts, torch.arange(C, dtype=torch.int32), CFG.max_candidate_results)
    jsel, jvalid = jm.select_candidates(
        want_counts, jnp.arange(C, dtype=jnp.int32),
        CFG.max_candidate_results)
    _eq(sel, jsel)
    _eq(sel_valid, jvalid)


def _port_args(args):
    return [_port(x) if not isinstance(x, (float, int)) else x for x in args]


def test_penetration_build_tests_match(scene):
    got = penetration.build_tests(*_port_args(scene["bt_args"]),
                                  max_tests=CFG.max_penetration_tests)
    want = scene["tests"]
    for f in ("cand", "src", "tgt", "valid", "overflow"):
        _eq(getattr(got, f), getattr(want, f))
    v = _n(want.valid)
    assert v.sum() > 0
    # segment ends come from line-edge intersections whose 1 - b^2
    # denominators amplify float32 rounding (the reference runs fused under
    # jit): 1e-3 on coordinates of a few units
    _close(_n(got.start)[v], _n(want.start)[v], atol=1e-3)
    _close(_n(got.direc)[v], _n(want.direc)[v], atol=1e-4)
    _close(_n(got.length)[v], _n(want.length)[v], atol=1e-3)


@pytest.mark.parametrize("small_points", [512, 16, 1 << 20])
def test_penetration_verdicts_match_both_tiers(scene, small_points):
    """small_points 512: the reference's two tiers; 16: nearly every test
    in the full tier; 2^20: every test in the sliced tier."""
    tests = scene["tests"]
    want = jpen.run_tests(tests, scene["sR"], scene["st"], *scene["rt_args"],
                          small_points=small_points, **scene["rt_kw"])
    kw = {k: _port(v) if not isinstance(v, (int, float)) else v
          for k, v in scene["rt_kw"].items()}
    got = penetration.run_tests(_port(tests), _port(scene["sR"]),
                                _port(scene["st"]),
                                *_port_args(scene["rt_args"]),
                                small_points=small_points, **kw)
    v = _n(tests.valid)
    _eq(_n(got)[v], _n(want)[v])
    C = CFG.max_candidate_results
    _eq(penetration.rejected_candidates(_port(tests), got, C),
        jpen.rejected_candidates(tests, want, C))


def test_penetration_crossing_planes_both_tiers(rng):
    """The reference's tier-parity case (one small and one big crossing
    plane pair): both penetrate in both packages."""
    ex, ey, ez = np.eye(3, dtype=np.float32)

    def cloud(n, u, v, c):
        uv = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
        return (np.asarray(c, np.float32) + uv[:, :1] * u
                + uv[:, 1:] * v).astype(np.float32)

    def quad(c, u, v):
        c = np.asarray(c, np.float32)
        return np.stack([c - u - v, c + u - v, c + u + v, c - u + v])

    M = 2048
    src = [cloud(300, ex, ey, [0, 0, 0]), cloud(1500, ex, ey, [0, 0, 5])]
    tgt = [cloud(300, ey, ez, [0, 0, 0]), cloud(1500, ey, ez, [0, 0, 5])]
    sc = np.array([[0, 0, 1, 0], [0, 0, 1, -5.0]], np.float32)
    tc = np.array([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    scorn = np.stack([quad([0, 0, 0], ex, ey), quad([0, 0, 5], ex, ey)])
    tcorn = np.stack([quad([0, 0, 0], ey, ez), quad([0, 0, 5], ey, ez)])
    pad = [np.pad(c, ((0, M - len(c)), (0, 0)), constant_values=1e8)
           for c in src + tgt]
    spts, tpts = np.stack(pad[:2]), np.stack(pad[2:])
    scnt = np.array([300, 1500], np.int32)
    R = np.eye(3, dtype=np.float32)[None]
    t = np.zeros((1, 3), np.float32)
    bt = (R, t, np.ones(1, bool), sc, scorn, scorn.mean(1), np.ones(2, bool),
          tc, tcorn, tcorn.mean(1), np.ones(2, bool))
    jtests = jpen.build_tests(*[jnp.asarray(x) for x in bt],
                              jnp.float32(0.1), 5.0 / 180.0 * math.pi,
                              max_tests=16)
    ttests = penetration.build_tests(*[_t(x) for x in bt],
                                     torch.tensor(0.1), 5.0 / 180.0 * math.pi,
                                     max_tests=16)
    for f in ("cand", "src", "tgt", "valid"):
        _eq(getattr(ttests, f), getattr(jtests, f))
    kw = dict(min_points=10, n_samples=32)
    for sp_ in (512, M):
        want = jpen.run_tests(jtests, jnp.asarray(R), jnp.asarray(t),
                              jnp.asarray(spts), jnp.asarray(scnt),
                              jnp.asarray(tpts), jnp.asarray(scnt),
                              jnp.asarray(sc), jnp.asarray(tc),
                              search_radius=jnp.float32(0.1),
                              min_distance=jnp.float32(0.05),
                              small_points=sp_, **kw)
        got = penetration.run_tests(ttests, _t(R), _t(t), _t(spts), _t(scnt),
                                    _t(tpts), _t(scnt), _t(sc), _t(tc),
                                    search_radius=torch.tensor(0.1),
                                    min_distance=torch.tensor(0.05),
                                    small_points=sp_, **kw)
        v = _n(jtests.valid)
        _eq(_n(got)[v], _n(want)[v])
        assert bool(penetration.rejected_candidates(ttests, got, 1)[0])


@pytest.mark.parametrize("divisor", [1, 2])
def test_occupancy_and_approx_counts_exact(scene, divisor):
    tgt, src = scene["tgt"], scene["src"]
    r = scene["dsd"] if divisor == 2 else scene["lt"]
    want = jov.build_occupancy(tgt.ds.points, tgt.ds.mask, r,
                               CFG.overlap_grid, cell_divisor=divisor)
    got = overlap.build_occupancy(_port(tgt.ds.points), _port(tgt.ds.mask),
                                  _port(r), CFG.overlap_grid,
                                  cell_divisor=divisor)
    for g, w in zip(got, want):
        _eq(g, w)
    wc = jov.approx_overlap_counts(*want, scene["sR"], scene["st"],
                                   src.ds.points, src.ds.mask,
                                   CFG.overlap_grid)
    gc = overlap.approx_overlap_counts(*got, _port(scene["sR"]),
                                       _port(scene["st"]),
                                       _port(src.ds.points),
                                       _port(src.ds.mask), CFG.overlap_grid)
    _eq(gc, wc)


@pytest.mark.parametrize("normal_cos", [0.7071067811865476, 0.0])
def test_exact_overlap_counts(scene, normal_cos):
    """Against float64 (exact) and against the reference (its expansion
    form: at most 0.5% of the source points apart)."""
    tgt, src = scene["tgt"], scene["src"]
    K = 8
    R, t = scene["sR"][:K], scene["st"][:K]
    r2 = (scene["dsd"] / 2) ** 2
    args = (R, t, src.ds.points, src.ds.mask, tgt.ds.points, r2)
    kw = dict(src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
              normal_cos=normal_cos)
    want = _n(jov.exact_overlap_counts(*args, **kw))
    got = _n(overlap.exact_overlap_counts(
        *[_port(x) for x in args],
        **{k: _port(v) if k != "normal_cos" else v for k, v in kw.items()}))
    n_src = int(src.ds.count)
    assert np.abs(got - want).max() <= 0.005 * n_src
    # float64 ground truth on the same float32 inputs
    sp = _n(src.ds.points)[:n_src].astype(np.float64)
    tp = _n(tgt.ds.points)[:int(tgt.ds.count)].astype(np.float64)
    sn = _n(src.ds.normals)[:n_src].astype(np.float64)
    tn = _n(tgt.ds.normals)[:int(tgt.ds.count)].astype(np.float64)
    sn /= np.maximum(np.linalg.norm(sn, axis=1, keepdims=True), 1e-12)
    tn /= np.maximum(np.linalg.norm(tn, axis=1, keepdims=True), 1e-12)
    for k in range(K):
        Rk, tk = _n(R[k]).astype(np.float64), _n(t[k]).astype(np.float64)
        q = sp @ Rk.T + tk
        d2 = ((q[:, None, :] - tp[None, :, :]) ** 2).sum(-1)
        if normal_cos > 0:
            d2 = np.where((sn @ Rk.T) @ tn.T >= normal_cos, d2, np.inf)
        # float32 rounding of the transformed points moves a point within
        # rounding of the radius across it: at most 0.1% of the points
        want64 = int((d2.min(1) <= float(r2)).sum())
        assert abs(int(got[k]) - want64) <= max(1, 0.001 * n_src)


def test_overlap_scores_match(scene):
    tgt, src = scene["tgt"], scene["src"]
    sel_valid = scene["sel_valid"]
    pf = jnp.linspace(0.2, 0.9, sel_valid.shape[0], dtype=jnp.float32)
    args = (scene["sR"], scene["st"], sel_valid, src.ds.points, src.ds.count,
            tgt.ds.points, tgt.ds.count, scene["dsd"])
    kw = dict(plane_frac=pf, face_weight=CFG.face_matches_weight,
              exact_k=CFG.overlap_exact_k, grid=CFG.overlap_grid,
              src_normals=src.ds.normals, tgt_normals=tgt.ds.normals,
              normal_cos=CFG.overlap_normal_cos)
    wov, wapx = jov.overlap_scores(*args, return_approx=True, **kw)
    pkw = {k: _port(v) if k in ("plane_frac", "src_normals", "tgt_normals")
           else v for k, v in kw.items()}
    gov, gapx = overlap.overlap_scores(*[_port(x) for x in args], **pkw)
    _eq(gapx, wapx)
    # the same candidates evaluated, scores within the count tolerance
    _eq(_n(gov) > 0, _n(wov) > 0)
    _close(gov, wov, atol=0.005 * int(src.ds.count)
           / max(min(int(src.ds.count), int(tgt.ds.count)), 1))
    w = CFG.face_matches_weight
    assert int(np.argmax(w * _n(pf) + (1 - w) * _n(gov))) \
        == int(np.argmax(w * _n(pf) + (1 - w) * _n(wov)))


def test_refine_icp_batched_matches_vmapped(scene):
    """16 poses near the true one, refined together (one K2 pass per
    iteration for all poses) against the reference's vmapped refine_icp."""
    tgt, src = scene["tgt"], scene["src"]
    rng = np.random.default_rng(5)
    R_gt, t_gt = scene["R_gt"], scene["t_gt"]
    R0, t0 = [], []
    for _ in range(16):
        w = rng.normal(scale=0.02, size=3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        dR = np.eye(3) + K + K @ K / 2
        u, _, vt = np.linalg.svd(dR)
        R0.append((u @ vt) @ R_gt)
        t0.append(t_gt + rng.normal(scale=0.03, size=3))
    R0 = np.stack(R0).astype(np.float32)
    t0 = np.stack(t0).astype(np.float32)
    sub = CFG.rescore_icp_subsample
    sp, sm = src.ds.points[::sub], src.ds.mask[::sub]
    want = jax.vmap(lambda a, b: jicp.refine_icp(
        a, b, sp, sm, tgt.ds.points, tgt.ds.normals, scene["dsd"],
        CFG.rescore_icp_iters))(jnp.asarray(R0), jnp.asarray(t0))
    got = icp.refine_icp(_t(R0), _t(t0), _port(sp), _port(sm),
                         _port(tgt.ds.points), _port(tgt.ds.normals),
                         _port(scene["dsd"]), CFG.rescore_icp_iters)
    _close(got[0], want[0], atol=1e-4)
    _close(got[1], want[1], atol=1e-4)
    _close(got[2], want[2], atol=1e-4)
    assert np.abs(_n(got[3]) - _n(want[3])).max() <= 0.005 * int(
        src.ds.count)
