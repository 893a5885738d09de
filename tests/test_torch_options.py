"""The port's ``PladeConfig`` options off the main path against the reference
package on the CPU: the final ICP (``enable_icp``) and the line-confidence
cull (``min_line_confidence > 0``); ``tests/test_torch_degraded.py`` has
the degraded descriptor families on the same scene.

* Each option end to end through ``register_with_planes`` on the same
  clouds and the reference extractor's planes, at a ``SMALL_CFG`` with
  buffers sized to the scene: transform within 0.1 deg and 1e-3, score
  and overlap within 1e-3, matched planes and counters equal, and the pose
  the true one; the final ICP refines one pose after the rescore's.
* ``_line_confidence`` on the reference's prepared lines within 1e-4
  relative; ``prepare_cloud`` with a threshold that culls part of the lines
  keeps the reference's line set.

CPU tensors never count a kernel launch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu import pipeline as jp
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.extract import ransac as jr
from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu_torch import pipeline
from plade_tpu_torch.core.convert import config_from, from_numpy
from plade_tpu_torch.core.types import PlaneSet, pad_cloud
from plade_tpu_torch.kernels import nn
from test_pipeline import SMALL_CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

#: SMALL_CFG with a 2-mode rescore and descriptor buffers that hold every
#: pair of the scene's 8 planes (28 lines at most)
CFG = dataclasses.replace(SMALL_CFG, rescore_top_k=2, max_lines=64,
                          max_query_pairs=512, max_target_pairs=1024,
                          max_matches=2048, max_degraded_matches=2048)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@pytest.fixture(scope="module")
def scene():
    """A room pair, the reference extractor's planes of both clouds, the
    reference's preparation of the source cloud and its line
    confidences."""
    rng = np.random.default_rng(0)
    pts, nrm, _ = make_room(rng, n_per_plane=800, noise=0.002,
                            extra_planes=2)
    R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    pad = jp._pad_size(pts.shape[0])
    tc, sc = jpad_cloud(pts, nrm, pad), jpad_cloud(spts, snrm, pad)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jplanes = (jr.auto_extract(tc.points, tc.normals, tc.count, k1, CFG, pad),
               jr.auto_extract(sc.points, sc.normals, sc.count, k2, CFG,
                               pad))
    sp = float(jax.numpy.asarray(
        jp.average_spacing(sc.points, sc.mask, CFG.spacing_k,
                           CFG.spacing_samples)))
    dsd = np.float32(CFG.derived(sp).down_sample_distance)
    prep = jp.prepare_cloud(sc, jplanes[1], jnp.float32(dsd), CFG)
    conf = np.asarray(jp._line_confidence(prep.lines, prep.geom,
                                          jnp.float32(dsd), CFG))
    return dict(clouds=(pts, nrm, spts, snrm), gt=(R, t), pad=pad, sc=sc,
                jplanes=jplanes,
                planes=tuple(PlaneSet(*[np.asarray(x) for x in p])
                             for p in jplanes),
                dsd=dsd, prep=prep, conf=conf[:int(prep.lines.count)])


def _culling_threshold(scene):
    """A confidence between the source's lowest and highest, so that the
    cull drops part of the lines and keeps the rest."""
    return float(np.quantile(scene["conf"], 0.3))


@pytest.mark.parametrize("option", ["enable_icp", "min_line_confidence"])
def test_option_matches_reference(scene, option, monkeypatch):
    value = _culling_threshold(scene) if option == "min_line_confidence" \
        else True
    poses = []        # the batch of poses of every refine_icp call
    refine = pipeline.refine_icp
    # R0 is (pairs, poses, 3, 3): register_pair is the one-pair call of the
    # batched code
    monkeypatch.setattr(pipeline, "refine_icp",
                        lambda R0, *a: poses.append(R0.shape[-3])
                        or refine(R0, *a))
    register_both(scene, dataclasses.replace(CFG, **{option: value}))
    # the rescore refines its modes; the final ICP one pose after it
    assert poses == [CFG.rescore_top_k] + [1] * (option == "enable_icp")


def register_both(scene, cfg):
    """``register_with_planes`` of both packages on the scene's clouds and
    planes at ``cfg``, held to each other and to the true pose."""
    want_T, want = jp.register_with_planes(*scene["clouds"],
                                           *scene["jplanes"], cfg)
    T, info = pipeline.register_with_planes(
        *scene["clouds"], *scene["planes"], config_from(cfg), device="cpu")
    assert info["success"] and want["success"]
    assert _rot_deg(T[:3, :3], want_T[:3, :3]) < 0.1
    assert np.linalg.norm(T[:3, 3] - want_T[:3, 3]) < 1e-3
    for key in ("matched_planes", "match_saturated", "pen_overflow",
                "cluster_truncated", "tgt_planes", "src_planes"):
        assert info[key] == want[key], key
    assert abs(info["score"] - want["score"]) < 1e-3
    assert abs(info["overlap"] - want["overlap"]) < 1e-3
    R, t = scene["gt"]
    assert _rot_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.15


def test_line_confidence_matches_reference(scene):
    prep = from_numpy(scene["prep"])
    conf = pipeline._line_confidence(prep.lines, prep.geom,
                                     torch.tensor(scene["dsd"]),
                                     config_from(CFG))
    n = int(prep.lines.count)
    assert n >= 6
    np.testing.assert_allclose(conf[:n].numpy(), scene["conf"], rtol=1e-4)


def test_line_confidence_cull_matches_reference(scene):
    thresh = _culling_threshold(scene)
    cfg = dataclasses.replace(CFG, min_line_confidence=thresh)
    want = jp.prepare_cloud(scene["sc"], scene["jplanes"][1],
                            jnp.float32(scene["dsd"]), cfg).lines
    cloud = pad_cloud(*scene["clouds"][2:], scene["pad"], "cpu")
    got = pipeline.prepare_cloud(cloud, from_numpy(scene["jplanes"][1]),
                                 torch.tensor(scene["dsd"]),
                                 config_from(cfg)).lines
    n = int(want.count)
    assert 0 < n < len(scene["conf"])
    assert int(got.count) == n
    np.testing.assert_array_equal(got.support.numpy(),
                                  np.asarray(want.support))
    np.testing.assert_allclose(got.direction.numpy(),
                               np.asarray(want.direction), atol=1e-5)
    np.testing.assert_allclose(got.point.numpy(), np.asarray(want.point),
                               atol=1e-4)
