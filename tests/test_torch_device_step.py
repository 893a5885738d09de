"""The port's device step and one-card batch entry against the reference
package on the CPU.

* Lockstep extraction (``build_extract_fn`` with a leading cloud axis) of
  two different clouds, one of which finishes rounds before the other, on
  the reference's replayed ``jax.random`` draws (one key chain per cloud):
  against the reference's ``jax.vmap`` of its extractor, plane counts,
  rounds, trials and final support equal, coefficients within 1e-4,
  ``point_plane`` equal on >= 99.9% of the points (products under the
  inlier thresholds round in another order than XLA's); against two
  one-cloud extractions of the port on the same draws, equal bit for bit
  (a finished cloud is frozen, as the reference's vmapped loop freezes
  it).
* ``build_register_device_fn`` against the reference's on a ``SMALL_CFG``
  room pair, the draws replayed from the same key: transform within 0.1
  deg and 1e-3, score and overlap within 1e-3, success, matched planes,
  counters and per-cloud extraction stats equal.  At ``SMALL_CFG``
  (``bitmap_cc_iters=48``) the reference's CPU labelling converges, so it
  agrees with the port's K3 semantics.
* ``register_clouds`` is the step at B = 1: on the same seed, one
  extractor call and one ``prepare_cloud`` call over both clouds, and the
  step's result bit for bit.  ``register_with_planes`` given the planes
  the step's extraction finds gives that result too.
* A blob with no planes: identity, ``success`` False, no exception.
* ``dist.mesh.register_array_pairs`` equals the step pair by pair.
* Without a card the new entry points raise unless asked for the CPU.

CPU tensors never count a kernel launch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from plade_tpu import pipeline as jpipeline
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.extract import ransac as jr
from plade_tpu.io.synthetic import (make_plane_points, make_room,
                                    random_rigid, transform_cloud)
from plade_tpu_torch import pipeline
from plade_tpu_torch.core.convert import config_from
from plade_tpu_torch.core.types import pad_cloud
from plade_tpu_torch.dist import mesh
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.kernels import nn
from test_extract import TEST_CFG
from test_pipeline import SMALL_CFG
from test_torch_device import _blob
from test_torch_extract import _replayed_draws
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CFG = config_from(SMALL_CFG)
#: ``SMALL_CFG`` with a 2-mode rescore, for the runs held to the port's own
#: results: the rescore's ICP scans the padded rows of every mode, which is
#: most of a CPU registration
FAST = dataclasses.replace(CFG, rescore_top_k=2)
PAD = 8192


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


# ------------------------------------------------------ lockstep extraction

@pytest.fixture(scope="module")
def lockstep():
    """Two clouds padded to 4096 (a room of 8 planes and a single plane),
    extracted by the reference's vmapped extractor, by the port's in
    lockstep and by the port's one cloud at a time, on the same draws."""
    rng = np.random.default_rng(5)
    room, room_n, _ = make_room(rng, n_per_plane=480, noise=0.002,
                                extra_planes=2)
    plane, plane_n = make_plane_points(rng, (0, 0, 1.0), (1, 0, 0),
                                       (0, 1, 0), 2.0, 2.0, 3000,
                                       noise=0.002)
    pad, floor, max_extract = 4096, 300, 16
    jc = [jpad_cloud(p, n, pad) for p, n in ((room, room_n), (plane,
                                                             plane_n))]
    keys = jax.random.split(jax.random.PRNGKey(7))
    ext = jr.build_extract_fn(TEST_CFG, pad, max_extract=max_extract)
    jp, js = jax.jit(jax.vmap(lambda p, n, c, k: ext(p, n, c, k, floor)))(
        *(jax.numpy.stack([getattr(c, f) for c in jc])
          for f in ("points", "normals", "count")), keys)
    tcfg = config_from(TEST_CFG)
    fn = ransac.build_extract_fn(tcfg, pad, max_extract=max_extract)
    tc = [pad_cloud(p, n, pad, "cpu") for p, n in ((room, room_n),
                                                    (plane, plane_n))]
    both = fn(*(torch.stack([getattr(c, f) for c in tc])
                for f in ("points", "normals", "count")), floor,
              draws=[_replayed_draws(k, pad, tcfg) for k in keys])
    one = [fn(c.points, c.normals, c.count, floor,
              draws=_replayed_draws(k, pad, tcfg))
           for c, k in zip(tc, keys)]
    return (jp, js), both, one


def test_lockstep_extraction_matches_reference(lockstep):
    (jp, js), (tp, ts), _ = lockstep
    rounds = np.asarray(js.rounds)
    assert rounds[0] != rounds[1], "the clouds must finish apart"
    for c in range(2):
        count = int(jp.count[c])
        assert int(tp.count[c]) == count > 0
        for f in ("rounds", "trials", "min_support"):
            assert int(getattr(ts, f)[c]) == int(getattr(js, f)[c]), f
        np.testing.assert_allclose(tp.coeffs[c, :count].numpy(),
                                   np.asarray(jp.coeffs[c, :count]),
                                   atol=1e-4)
        agree = np.mean(tp.point_plane[c].numpy()
                        == np.asarray(jp.point_plane[c]))
        assert agree >= 0.999, agree
        assert float(ts.drawn[c]) == pytest.approx(float(js.drawn[c]),
                                                   rel=1e-4)


def test_lockstep_extraction_equals_one_cloud_extractions(lockstep):
    _, (tp, ts), one = lockstep
    for c, (p1, s1) in enumerate(one):
        for a, b in zip(tp, p1):
            assert torch.equal(a[c], b)
        for a, b in zip(ts, s1):
            assert torch.equal(a[c], b)


# ------------------------------------------------------------- device step

def _room_pair(seed=0):
    rng = np.random.default_rng(seed)
    pts, nrm, _ = make_room(rng, n_per_plane=800, noise=0.003,
                            extra_planes=3)
    R, t = random_rigid(rng, max_angle=2.5, max_trans=1.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    spts = spts + rng.normal(scale=0.002, size=spts.shape).astype(np.float32)
    return pts, nrm, spts, snrm, R, t


@pytest.fixture(scope="module")
def step_runs():
    """The room pair through the reference's step and the port's (replayed
    draws), the port's step with its own generators, ``register_clouds``
    and the step on a plane-less blob."""
    pts, nrm, spts, snrm, R, t = _room_pair()
    assert jpipeline._pad_size(pts.shape[0]) == PAD
    key = jax.random.PRNGKey(0)
    jres, jstats = jax.jit(jpipeline.build_register_device_fn(
        SMALL_CFG, PAD, with_stats=True))(jpad_cloud(pts, nrm, PAD),
                                          jpad_cloud(spts, snrm, PAD), key)
    step = pipeline.build_register_device_fn(CFG, PAD, with_stats=True,
                                             device="cpu")
    tc, sc = pad_cloud(pts, nrm, PAD, "cpu"), pad_cloud(spts, snrm, PAD,
                                                        "cpu")
    k1, k2 = jax.random.split(key)
    replay = step(tc, sc, 0, draws=[_replayed_draws(k, PAD, CFG)
                                    for k in (k1, k2)])
    fast = pipeline.build_register_device_fn(FAST, PAD, with_stats=True,
                                             device="cpu")
    own = fast(tc, sc, 0)
    calls = {"extract": [], "prepare": []}
    with pytest.MonkeyPatch.context() as mp:
        real_extractor, real_prepare = (ransac._cached_extractor,
                                        pipeline.prepare_cloud)

        def extractor(cfg, num_points):
            fn = real_extractor(cfg, num_points)

            def run(points, *args, **kwargs):
                calls["extract"].append(tuple(points.shape))
                return fn(points, *args, **kwargs)
            return run

        def prepare(cloud, *args):
            calls["prepare"].append(tuple(cloud.points.shape))
            return real_prepare(cloud, *args)
        mp.setattr(ransac, "_cached_extractor", extractor)
        mp.setattr(pipeline, "prepare_cloud", prepare)
        clouds = pipeline.register_clouds(pts, nrm, spts, snrm, FAST,
                                          seed=0, device="cpu")
    # 150 points, fewer than the 200 of the support floor: each cloud's
    # extraction ends in its first round
    bp, bn = _blob(150)
    blob = fast(pad_cloud(bp, bn, PAD, "cpu"),
                pad_cloud(bp + 0.1, bn, PAD, "cpu"), 1)
    return dict(scene=(pts, nrm, spts, snrm), gt=(R, t), jax=(jres, jstats),
                replay=replay, own=own, clouds=clouds, calls=calls,
                blob=(bp, bn, blob))


def test_device_step_matches_reference(step_runs):
    jres, jstats = step_runs["jax"]
    res, stats = step_runs["replay"]
    T, want_T = res.transform.numpy(), np.asarray(jres.transform)
    assert bool(res.success) and bool(jres.success)
    assert _rot_deg(T[:3, :3], want_T[:3, :3]) < 0.1
    assert np.linalg.norm(T[:3, 3] - want_T[:3, 3]) < 1e-3
    for f in ("score", "overlap"):
        assert abs(float(getattr(res, f)) - float(getattr(jres, f))) < 1e-3
    for f in ("matched_planes", "match_saturated", "pen_overflow",
              "cluster_truncated"):
        assert int(getattr(res, f)) == int(getattr(jres, f)), f
    for f in ("rounds", "trials", "min_support"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(jstats, f)))
    np.testing.assert_allclose(stats.drawn.numpy(), np.asarray(jstats.drawn),
                               rtol=1e-4)
    R, t = step_runs["gt"]
    assert _rot_deg(T[:3, :3], R) < 3.0 and np.linalg.norm(T[:3, 3] - t) < 0.15


def _assert_is_step(T, info, res):
    """``(T, info)`` of a one-pair entry is the step's ``res``, bit for
    bit."""
    np.testing.assert_array_equal(T, res.transform.numpy())
    for f in pipeline.RegistrationResult._fields[1:]:
        assert info[f] == getattr(res, f).item(), f


def test_device_step_extracts_register_clouds_planes(step_runs):
    """Same seed, no swap, no cap: ``register_clouds`` runs the step's
    stages at B = 1, so its planes and its result are the step's."""
    res, stats = step_runs["own"]
    T, info = step_runs["clouds"]
    assert info["success"] and bool(res.success)
    _assert_is_step(T, info, res)
    assert stats.rounds.shape == (2,)


def test_register_clouds_runs_both_clouds_at_once(step_runs):
    """One extractor call and one ``prepare_cloud`` call, each over the
    target and the source stacked."""
    assert step_runs["calls"] == {"extract": [(2, PAD, 3)],
                                  "prepare": [(2, PAD, 3)]}


def test_register_with_planes_is_the_step_after_extraction(step_runs):
    """The planes the step's extraction finds for the room pair (its
    generators on seed 0), given to ``register_with_planes``: the step's
    result, bit for bit."""
    pts, nrm, spts, snrm = step_runs["scene"]
    clouds = pipeline._stack(pad_cloud(pts, nrm, PAD, "cpu"),
                             pad_cloud(spts, snrm, PAD, "cpu"))
    planes, _ = pipeline._extract_selected(
        clouds, pipeline._generators(0, "cpu"), FAST, PAD)
    T, info = pipeline.register_with_planes(
        pts, nrm, spts, snrm,
        *(pipeline.PlaneSet(*(x[c] for x in planes)) for c in (0, 1)), FAST,
        device="cpu")
    _assert_is_step(T, info, step_runs["own"][0])
    assert [info["tgt_planes"], info["src_planes"]] == planes.count.tolist()


def test_device_step_without_planes(step_runs):
    """Both clouds of a blob extract no planes: the registration still
    runs on the empty plane sets and the result is masked to identity."""
    _, _, (res, stats) = step_runs["blob"]
    np.testing.assert_array_equal(res.transform.numpy(),
                                  np.eye(4, dtype=np.float32))
    assert not bool(res.success)
    assert float(res.score) == 0.0 and float(res.overlap) == 0.0
    assert int(res.matched_planes) == 0
    np.testing.assert_array_equal(stats.rounds.numpy(), [1, 1])


def test_register_array_pairs_equals_the_step(step_runs):
    pts, nrm, spts, snrm = step_runs["scene"]
    bp, bn, (blob, _) = step_runs["blob"]
    out = mesh.register_array_pairs([(pts, nrm, spts, snrm),
                                     (bp, bn, bp + 0.1, bn)], FAST, seed=0,
                                    device="cpu")
    assert len(out) == 2
    for o, (res, _) in zip(out, (step_runs["own"], (blob, None))):
        assert isinstance(o, mesh.PairOutcome)
        np.testing.assert_array_equal(o.transform, res.transform.numpy())
        assert o.success == bool(res.success)
        assert o.score == float(res.score)
        assert o.overlap == float(res.overlap)
        assert o.matched_planes == int(res.matched_planes)
        assert o.cloud_capped is False
        for f in ("match_saturated", "pen_overflow", "cluster_truncated"):
            assert getattr(o, f) == int(getattr(res, f)), f
    assert out[0].success and not out[1].success


def test_register_array_pairs_caps_and_reports():
    """A cloud over ``max_points`` is capped (and reported); no pairs, no
    outcomes."""
    pts, nrm = _blob(160)
    cfg = dataclasses.replace(FAST, max_points=128, spacing_samples=100,
                              max_ds_points=256)
    out = mesh.register_array_pairs([(pts, nrm, pts[:100], nrm[:100])], cfg,
                                    device="cpu")
    assert out[0].cloud_capped is True and out[0].success is False
    assert mesh.register_array_pairs([], cfg, device="cpu") == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["build_register_device_fn",
                                   "register_pair_device",
                                   "register_array_pairs"])
def test_new_entries_default_to_cuda(entry, no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "register_array_pairs":
            pts, nrm = _blob(16)
            mesh.register_array_pairs([(pts, nrm, pts, nrm)], CFG)
        else:
            getattr(pipeline, entry)(CFG, 4096)
