"""The port's plane extraction (``plade_tpu_torch/extract/ransac.py``)
against the reference package on the CPU.

* Deterministic helpers: ``_plane_basis``, ``_fit_plane`` and
  ``smallest_eigvec3`` to 1e-5 (float32 reductions in another order),
  eigenvector signs aligned; ``select_planes_device`` exactly against the
  reference's ``select_planes`` and ``select_planes_device``, on PlaneSets
  from the reference extractor.
* The greedy extractor with the reference's ``jax.random`` draws replayed
  (the same key chain, ``key, k1, k_lvl, k_g2, k_g3 = split(key, 5)`` per
  round) on the scenes of ``tests/test_extract.py`` at its ``TEST_CFG``:
  plane count and rounds equal, coefficients within 1e-4, sizes within
  max(2, 0.1%), ``point_plane`` equal on >= 99.9% of the points.  The
  products under the inlier thresholds round in another order than XLA's,
  so a point within an ulp of a threshold may fall the other way.  At
  ``TEST_CFG`` both packages' connected-component labels converge, so the
  reference's pointer-jump labelling on the CPU and the port's K3 agree.
* The extractor with its own ``torch.Generator`` passes the assertions of
  the reference's room, noisy-recall and CC-split tests.

CPU tensors never count a kernel launch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu.core.types import PlaneSet as JPlaneSet
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.extract import ransac as jr
from plade_tpu.geometry import eig3 as jeig3
from plade_tpu.io.synthetic import make_plane_points, make_room
from plade_tpu_torch.core.convert import config_from
from plade_tpu_torch.core.types import PlaneSet, pad_cloud
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.geometry import eig3
from plade_tpu_torch.kernels import cc
from test_extract import TEST_CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(cc.LAUNCHES)
    yield
    assert cc.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _align(a, b):
    """Flip the rows of ``a`` whose sign disagrees with ``b``'s."""
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    return a * np.where(s == 0, 1.0, s)


def test_plane_basis_matches_reference(rng):
    n = rng.normal(size=(50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:3] = [[1, 0, 0], [0.95, 0.3122, 0], [0, 0, 1]]
    u, v = ransac._plane_basis(torch.from_numpy(n))
    ju, jv = jax.vmap(jr._plane_basis)(jnp.asarray(n))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


def test_fit_plane_and_smallest_eigvec_match_reference(rng):
    pts = rng.normal(size=(2000, 3)).astype(np.float32) * [2.0, 1.0, 0.01]
    pts = (pts @ np.linalg.qr(rng.normal(size=(3, 3)))[0]).astype(np.float32)
    w = (rng.random((5, 2000)) < np.linspace(0.1, 1.0, 5)[:, None]) \
        .astype(np.float32)
    w[0] = 0.0                                     # empty weights
    n, c = ransac._fit_plane(torch.from_numpy(pts), torch.from_numpy(w))
    jn, jc = jax.vmap(lambda wi: jr._fit_plane(jnp.asarray(pts), wi))(
        jnp.asarray(w))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(_align(n.numpy(), np.asarray(jn))[1:],
                               np.asarray(jn)[1:], atol=1e-5)
    A = rng.normal(size=(20, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    A[0] = np.diag([3.0, 1.0, 1.0])                # repeated eigenvalue
    got = eig3.smallest_eigvec3(torch.from_numpy(A)).numpy()
    want = np.asarray(jeig3.smallest_eigvec3(jnp.asarray(A)))
    np.testing.assert_allclose(_align(got, want), want, atol=1e-5)


# ---------------------------------------------------------------- extractor

def _replayed_draws(key, num_points, cfg):
    """``draws(state)`` replaying the reference's per-round draws from the
    JAX key chain, handed over as tensors."""
    S_cell = cfg.ransac_candidates_per_round // 2
    d_sub = max(max(1, cfg.ransac_score_subset), cfg.ransac_draw_subset)
    n_draw = -(-num_points // d_sub)
    box = [key]

    def draws(state):
        key, k1, k_lvl, k_g2, k_g3 = jax.random.split(box[0], 5)
        box[0] = key
        probs = jnp.asarray(state.level_probs.numpy())
        out = (jax.random.uniform(k1, (num_points,)),
               jax.random.categorical(k_lvl,
                                      jnp.log(jnp.maximum(probs, 1e-9)),
                                      shape=(S_cell,)),
               jax.random.uniform(k_g2, (n_draw,)),
               jax.random.uniform(k_g3, (n_draw,)))
        return tuple(torch.from_numpy(np.array(x)) for x in out)

    return draws


def _scene(rng, name):
    """(points, normals, min_support, max_extract) of the scenes of
    ``tests/test_extract.py``."""
    if name == "single_plane":
        pts, nrm = make_plane_points(rng, (0, 0, 1.0), (1, 0, 0), (0, 1, 0),
                                     2.0, 2.0, 4000, noise=0.002)
        return pts, nrm, 500, 16
    if name == "room":
        pts, nrm, _ = make_room(rng, n_per_plane=1500, noise=0.002,
                                extra_planes=2)
        return pts, nrm, 400, 16
    p1, n1 = make_plane_points(rng, (0, 0, 0), (1, 0, 0), (0, 1, 0),
                               1.0, 1.0, 2000, noise=0.001)
    p2, n2 = make_plane_points(rng, (8, 0, 0), (1, 0, 0), (0, 1, 0),
                               1.0, 1.0, 1000, noise=0.001)
    return np.concatenate([p1, p2]), np.concatenate([n1, n2]), 300, 4


def _extract_both(pts, nrm, min_support, max_extract, cfg=TEST_CFG, seed=0):
    n = pts.shape[0]
    pad = 1 << (n - 1).bit_length()
    jc = jpad_cloud(pts, nrm, pad)
    key = jax.random.PRNGKey(seed)
    jp, js = jr.make_extractor(cfg, pad, max_extract=max_extract)(
        jc.points, jc.normals, jc.count, key, min_support)
    tcfg = config_from(cfg)
    tc = pad_cloud(pts, nrm, pad, "cpu")
    tp, ts = ransac.build_extract_fn(tcfg, pad, max_extract=max_extract)(
        tc.points, tc.normals, tc.count, min_support,
        draws=_replayed_draws(key, pad, tcfg))
    return jp, js, tp, ts


@pytest.mark.parametrize("name", ["single_plane", "room", "cc_split"])
def test_extractor_matches_reference_on_replayed_draws(rng, name):
    pts, nrm, min_support, max_extract = _scene(rng, name)
    jp, js, tp, ts = _extract_both(pts, nrm, min_support, max_extract)
    count = int(jp.count)
    assert int(tp.count) == count > 0
    assert int(ts.rounds) == int(js.rounds)
    assert int(ts.trials) == int(js.trials)
    assert int(ts.min_support) == int(js.min_support)
    np.testing.assert_allclose(tp.coeffs[:count].numpy(),
                               np.asarray(jp.coeffs[:count]), atol=1e-4)
    js_sizes = np.asarray(jp.sizes[:count])
    diff = np.abs(tp.sizes[:count].numpy() - js_sizes)
    assert (diff <= np.maximum(2, 0.001 * js_sizes)).all(), diff
    agree = np.mean(tp.point_plane.numpy() == np.asarray(jp.point_plane))
    assert agree >= 0.999, agree
    assert float(ts.drawn) == pytest.approx(float(js.drawn), rel=1e-4)


def test_extractor_staged_halving_matches_reference(rng):
    """The staged support cascade (``ransac_flat_support=False``), whose
    halvings, level jumps and dormant pool entries flat mode never uses."""
    pts, nrm, _ = make_room(rng, n_per_plane=1200, noise=0.002,
                            extra_planes=0)
    staged = dataclasses.replace(TEST_CFG, ransac_flat_support=False,
                                 ransac_max_trials=10, min_planes=2)
    jp, js, tp, ts = _extract_both(pts, nrm, 400, 16, cfg=staged)
    assert int(ts.trials) == int(js.trials) >= 1
    assert int(ts.rounds) == int(js.rounds)
    count = int(jp.count)
    assert int(tp.count) == count
    np.testing.assert_allclose(tp.coeffs[:count].numpy(),
                               np.asarray(jp.coeffs[:count]), atol=1e-4)


def test_lockstep_freeze_matches_reference_on_replayed_draws(rng):
    """Two clouds in lockstep, one done rounds before the other: every
    pass freezes the done cloud (the freeze runs whether or not a cloud
    is done), and each cloud's planes and stats are the reference's for
    that cloud alone on the same replayed draws (its vmapped while_loop
    leaves a done cloud as it was)."""
    clouds = [_scene(rng, name)[:2] for name in ("single_plane", "room")]
    pad = 1 << (max(p.shape[0] for p, _ in clouds) - 1).bit_length()
    keys = jax.random.split(jax.random.PRNGKey(3))
    tcfg = config_from(TEST_CFG)
    batch = [pad_cloud(p, n, pad, "cpu") for p, n in clouds]
    tp, ts = ransac.build_extract_fn(tcfg, pad, max_extract=16)(
        torch.stack([c.points for c in batch]),
        torch.stack([c.normals for c in batch]),
        torch.stack([c.count for c in batch]), 300,
        draws=[_replayed_draws(k, pad, tcfg) for k in keys])
    rounds = ts.rounds.tolist()
    assert rounds[0] != rounds[1], rounds
    extractor = jr.make_extractor(TEST_CFG, pad, max_extract=16)
    for c, ((pts, nrm), key) in enumerate(zip(clouds, keys)):
        jc = jpad_cloud(pts, nrm, pad)
        jp, js = extractor(jc.points, jc.normals, jc.count, key, 300)
        count = int(jp.count)
        assert int(tp.count[c]) == count > 0
        assert rounds[c] == int(js.rounds)
        assert int(ts.trials[c]) == int(js.trials)
        assert int(ts.min_support[c]) == int(js.min_support)
        np.testing.assert_allclose(tp.coeffs[c, :count].numpy(),
                                   np.asarray(jp.coeffs[:count]), atol=1e-4)
        agree = np.mean(tp.point_plane[c].numpy()
                        == np.asarray(jp.point_plane))
        assert agree >= 0.999, agree
        assert float(ts.drawn[c]) == pytest.approx(float(js.drawn), rel=1e-4)


def _own_extract(pts, nrm, cfg, min_support, max_extract=16, seed=0):
    n = pts.shape[0]
    pad = 1 << (n - 1).bit_length()
    tc = pad_cloud(pts, nrm, pad, "cpu")
    fn = ransac.build_extract_fn(config_from(cfg), pad,
                                 max_extract=max_extract)
    return fn(tc.points, tc.normals, tc.count, min_support,
              generator=torch.Generator().manual_seed(seed))


def _recall(planes, gt_planes, cos, dtol):
    count = int(planes.count)
    got = planes.coeffs[:count].numpy()
    matched = 0
    for n_gt, d_gt in gt_planes:
        dots = got[:, :3] @ n_gt
        dd = np.abs(got[:, 3] - d_gt)
        matched += bool(np.any((dots > cos) & (dd < dtol)))
    return matched


def test_own_draws_room_planes(rng):
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1500, noise=0.002,
                                    extra_planes=2)
    planes, _ = _own_extract(pts, nrm, TEST_CFG, 400)
    assert int(planes.count) >= len(gt_planes) - 1
    assert _recall(planes, gt_planes, 0.99, 0.05) >= len(gt_planes) - 1
    assert (planes.point_plane.numpy() >= 0).sum() > 0.8 * pts.shape[0]


def test_own_draws_noisy_scan_recall(rng):
    size = 4.0
    pts, nrm, gt_planes = make_room(rng, n_per_plane=1500, noise=0.01 * size,
                                    size=size, extra_planes=2,
                                    normal_noise_deg=8.0)
    planes, _ = _own_extract(pts, nrm, TEST_CFG, 400)
    assert _recall(planes, gt_planes, 0.98, 0.1) >= \
        int(np.ceil(0.9 * len(gt_planes)))


def test_own_draws_connected_component_split(rng):
    pts, nrm, min_support, max_extract = _scene(rng, "cc_split")
    planes, _ = _own_extract(pts, nrm, TEST_CFG, min_support, max_extract)
    assert int(planes.count) == 2
    sizes = sorted(int(s) for s in planes.sizes[:2])
    assert 800 < sizes[0] < 1300
    assert 1700 < sizes[1] < 2300


# ---------------------------------------------------------------- selection

@pytest.mark.parametrize("min_planes,max_planes", [(4, 6), (10, 12), (2, 16)])
def test_select_planes_match_reference(rng, min_planes, max_planes):
    pts, nrm, _ = make_room(rng, n_per_plane=900, noise=0.002,
                            extra_planes=2)
    cfg = dataclasses.replace(TEST_CFG, min_planes=min_planes,
                              max_planes=max_planes,
                              ransac_min_allowed_support=200,
                              ransac_init_min_support=10000)
    n = pts.shape[0]
    pad = 1 << (n - 1).bit_length()
    jc = jpad_cloud(pts, nrm, pad)
    jp, _ = jr.make_extractor(cfg, pad, max_extract=16)(
        jc.points, jc.normals, jc.count, jax.random.PRNGKey(0), 200)
    planes = PlaneSet(*[torch.from_numpy(np.array(x)) for x in jp])
    mine = ransac.select_planes_device(planes, config_from(cfg))
    # the reference's host and device selections pick the same planes
    for ref in (jr.select_planes(jp, cfg), jr.select_planes_device(jp, cfg)):
        for f in JPlaneSet._fields:
            a, b = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_support_thresholds_match_reference():
    for cfg in (TEST_CFG, dataclasses.replace(TEST_CFG,
                                              ransac_init_min_support=2000,
                                              ransac_min_allowed_support=300)):
        want = jr._support_thresholds(cfg)
        assert ransac._support_thresholds(config_from(cfg)) == want
        assert ransac._thresholds_on(config_from(cfg), "cpu").tolist() == want
