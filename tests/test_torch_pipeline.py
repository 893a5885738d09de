"""The port's ``register_with_planes`` against the reference package's, end
to end on CPU at ``SMALL_CFG`` sizes: the two synthetic rooms of
``test_register_synthetic_room`` (seeds 0 and 1) and the
``test_register_with_planes_overload`` pair.  Both packages get the same
clouds and the reference extractor's planes, as numpy arrays.

Required agreement: transform within 0.1 deg and 1e-3; matched planes and
the three truncation counters equal; score and overlap within 1e-3 (the
port's exact overlap uses the kernels' difference form where the
reference's CPU path uses the |q|^2 - 2 q.r + |r|^2 expansion, so a point
within rounding of a radius may count differently)."""
import jax
import numpy as np
import pytest
import torch

from plade_tpu.core.types import PlaneSet as JPlaneSet
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.extract import ransac
from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu.knn.bruteforce import average_spacing as javg
from plade_tpu.pipeline import _pad_size
from plade_tpu.pipeline import prepare_cloud as jprepare
from plade_tpu.pipeline import register_with_planes as jregister
from plade_tpu_torch.core.config import PladeConfig
from plade_tpu_torch.core.convert import config_from, to_numpy
from plade_tpu_torch.core.types import PlaneSet, pad_cloud
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.knn.bruteforce import average_spacing
from plade_tpu_torch.pipeline import prepare_cloud, register_with_planes
from test_pipeline import SMALL_CFG

CASES = ["room_seed0", "room_seed1", "planes_overload"]


def _scene(case):
    """(target pts, normals, source pts, normals, R, t, extraction seed),
    built as the reference's own tests build them."""
    if case == "planes_overload":
        rng = np.random.default_rng(0)
        pts, nrm, _ = make_room(rng, n_per_plane=1200, noise=0.002,
                                extra_planes=2)
        R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
        spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
        return pts, nrm, spts, snrm, R, t, 0
    seed = int(case[-1])
    rng = np.random.default_rng(seed)
    pts, nrm, _ = make_room(rng, n_per_plane=1400, noise=0.003,
                            extra_planes=3)
    R, t = random_rigid(rng, max_angle=2.5, max_trans=1.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    spts = spts + rng.normal(scale=0.002, size=spts.shape).astype(np.float32)
    return pts, nrm, spts, snrm, R, t, seed


@pytest.fixture(scope="module")
def reference():
    """Per case: the scene, the reference extractor's planes (numpy) and
    the reference's register_with_planes result."""
    out = {}
    for case in CASES:
        pts, nrm, spts, snrm, R, t, seed = _scene(case)
        pad = _pad_size(max(pts.shape[0], spts.shape[0]))
        tc = jpad_cloud(pts, nrm, pad)
        sc = jpad_cloud(spts, snrm, pad)
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        tp = ransac.auto_extract(tc.points, tc.normals, tc.count, k1,
                                 SMALL_CFG, pad)
        sp = ransac.auto_extract(sc.points, sc.normals, sc.count, k2,
                                 SMALL_CFG, pad)
        T, info = jregister(pts, nrm, spts, snrm, tp, sp, SMALL_CFG)
        out[case] = dict(
            clouds=(pts, nrm, spts, snrm), gt=(R, t), pad=pad, T=T,
            info=info, jplanes=(tp, sp),
            planes=tuple(PlaneSet(*[np.asarray(x) for x in p])
                         for p in (tp, sp)))
    return out


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@pytest.mark.parametrize("case", CASES)
def test_register_with_planes_matches_reference(reference, case):
    ref = reference[case]
    before = dict(nn.LAUNCHES)
    T, info = register_with_planes(*ref["clouds"], *ref["planes"],
                                   config_from(SMALL_CFG))
    assert nn.LAUNCHES == before              # CPU tensors: plain versions
    want_T, want = ref["T"], ref["info"]
    assert info["success"] and want["success"]
    assert T.shape == (4, 4) and np.isfinite(T).all()
    assert _rot_deg(T[:3, :3], want_T[:3, :3]) < 0.1
    assert np.linalg.norm(T[:3, 3] - want_T[:3, 3]) < 1e-3
    for key in ("matched_planes", "match_saturated", "pen_overflow",
                "cluster_truncated", "tgt_planes", "src_planes"):
        assert info[key] == want[key], key
    assert abs(info["score"] - want["score"]) < 1e-3
    assert abs(info["overlap"] - want["overlap"]) < 1e-3
    # and the pose is the true one, as the reference tests require
    R, t = ref["gt"]
    assert _rot_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.15


@pytest.mark.parametrize("case", CASES)
def test_prepare_cloud_matches_reference(reference, case):
    """Downsampled cloud, per-plane geometry and intersection lines of the
    source cloud (counts and supports exact, coordinates to 1e-4)."""
    ref = reference[case]
    pts, nrm, spts, snrm = ref["clouds"]
    pad = ref["pad"]
    jcloud = jpad_cloud(spts, snrm, pad)
    cloud = pad_cloud(spts, snrm, pad, "cpu")
    sp = float(javg(jcloud.points, jcloud.mask, SMALL_CFG.spacing_k,
                    SMALL_CFG.spacing_samples))
    mine = float(average_spacing(cloud.points, cloud.mask,
                                 SMALL_CFG.spacing_k,
                                 SMALL_CFG.spacing_samples))
    assert mine == pytest.approx(sp, rel=1e-5)
    dsd = np.float32(SMALL_CFG.derived(sp).down_sample_distance)
    jplanes = ref["jplanes"][1]
    want = to_numpy(jprepare(jcloud, jplanes, jax.numpy.float32(dsd),
                             SMALL_CFG))
    planes = PlaneSet(*[torch.as_tensor(np.array(x)) for x in jplanes])
    got = to_numpy(prepare_cloud(cloud, planes, torch.tensor(dsd),
                                 config_from(SMALL_CFG)))
    assert int(got.ds.count) == int(want.ds.count)
    np.testing.assert_allclose(got.ds.points, want.ds.points, atol=1e-4)
    np.testing.assert_allclose(got.ds.normals, want.ds.normals, atol=1e-4)
    np.testing.assert_array_equal(got.geom.ds_counts, want.geom.ds_counts)
    np.testing.assert_allclose(got.geom.ds_points, want.geom.ds_points,
                               atol=1e-4)
    for f in ("corners", "centers", "radii"):
        np.testing.assert_allclose(getattr(got.geom, f),
                                   getattr(want.geom, f), atol=1e-4)
    assert int(got.lines.count) == int(want.lines.count) > 0
    np.testing.assert_array_equal(got.lines.support, want.lines.support)
    np.testing.assert_allclose(got.lines.direction, want.lines.direction,
                               atol=1e-5)
    np.testing.assert_allclose(got.bounding_radius, want.bounding_radius,
                               rtol=1e-5)


def test_register_with_planes_too_few_planes(reference):
    """Fewer than ``min_planes`` planes: identity and a failure note, as in
    the reference."""
    ref = reference["planes_overload"]
    tp, sp = ref["planes"]
    few = tp._replace(count=np.int32(2))
    T, info = register_with_planes(*ref["clouds"], few, sp,
                                   config_from(SMALL_CFG))
    want_T, want = jregister(*ref["clouds"], JPlaneSet(*few),
                             ref["jplanes"][1], SMALL_CFG)
    np.testing.assert_array_equal(T, want_T)
    assert info == want == {"tgt_planes": 2, "src_planes": int(sp.count),
                            "failure": "too few planes"}


def test_register_with_planes_rejects_oversized_cloud():
    cfg = PladeConfig(max_points=64)
    pts = np.zeros((65, 3), np.float32)
    planes = PlaneSet(np.zeros((2, 4), np.float32), np.zeros(2, np.int32),
                      np.int32(0), np.full(65, -1, np.int32))
    with pytest.raises(ValueError, match="max_points"):
        register_with_planes(pts, pts, pts, pts, planes, planes, cfg)
