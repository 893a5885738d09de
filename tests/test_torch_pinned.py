"""The pinned min-support overload of the port
(``register_clouds(ransac_min_support=...)``, plade.cpp:583-599) against
the reference package on the CPU.

* ``select_planes_pinned`` against the reference's with a ``max_planes``
  below, at and above the plane count: exact.
* ``extract(init_support=...)``, the extraction the overload runs (the
  pinned support as floor and start), on the reference's replayed draws,
  in flat and staged support mode: held as the other extractions are
  (``tests/test_torch_extract.py``).
* ``register_clouds`` with a pinned support: the true pose, every plane
  kept, and a (target, source) pair swapped with the clouds.

CPU tensors never count a kernel launch."""
import dataclasses

import jax
import numpy as np
import pytest

from plade_tpu.core.types import PlaneSet as JPlaneSet
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.extract import ransac as jr
from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu_torch import pipeline
from plade_tpu_torch.core.convert import config_from, from_numpy
from plade_tpu_torch.core.types import pad_cloud
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.kernels import nn
from test_extract import TEST_CFG
from test_pipeline import SMALL_CFG, rotation_error_deg
from test_torch_extract import _replayed_draws
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FAST = dataclasses.replace(config_from(SMALL_CFG), rescore_top_k=2)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.mark.parametrize("max_planes", [4, 10, 16])
def test_select_planes_pinned_matches_reference(rng, max_planes):
    """10 planes in a buffer of 16, of random sizes with ties, cut to a
    ``max_planes`` below, at and above their count."""
    sizes = np.zeros(16, np.int32)
    sizes[:10] = rng.choice([300, 450, 600, 900], size=10)
    planes = JPlaneSet(
        coeffs=rng.normal(size=(16, 4)).astype(np.float32),
        sizes=sizes, count=np.int32(10),
        point_plane=rng.integers(-1, 10, size=500).astype(np.int32))
    cfg = dataclasses.replace(TEST_CFG, max_planes=max_planes)
    want = jr.select_planes_pinned(planes, cfg)
    got = ransac.select_planes_pinned(from_numpy(planes), config_from(cfg))
    for f in JPlaneSet._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("flat", [True, False])
def test_pinned_extraction_matches_reference(rng, flat):
    """The room scene of ``tests/test_torch_extract.py`` at a pinned
    support of 400."""
    pts, nrm, _ = make_room(rng, n_per_plane=1500, noise=0.002,
                            extra_planes=2)
    cfg = dataclasses.replace(TEST_CFG, ransac_flat_support=flat)
    support, pad = 400, 16384
    key = jax.random.PRNGKey(3)
    jc = jpad_cloud(pts, nrm, pad)
    jp, js = jr.make_extractor(cfg, pad, max_extract=16)(
        jc.points, jc.normals, jc.count, key, support, init_support=support)
    tcfg = config_from(cfg)
    tc = pad_cloud(pts, nrm, pad, "cpu")
    tp, ts = ransac.build_extract_fn(tcfg, pad, max_extract=16)(
        tc.points, tc.normals, tc.count, support,
        draws=_replayed_draws(key, pad, tcfg), init_support=support)
    count = int(jp.count)
    assert int(tp.count) == count >= 6
    assert int(ts.min_support) == int(js.min_support) == support
    for f in ("rounds", "trials"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    np.testing.assert_allclose(tp.coeffs[:count].numpy(),
                               np.asarray(jp.coeffs[:count]), atol=1e-4)
    assert (tp.sizes[:count].numpy() >= support).all()
    agree = np.mean(tp.point_plane.numpy() == np.asarray(jp.point_plane))
    assert agree >= 0.999, agree


@pytest.mark.parametrize("swap", [False, True])
def test_register_clouds_pinned_support(swap, monkeypatch):
    """The pinned support reaches each cloud's extraction as floor and
    start, swapped with the clouds when the source is the larger one; the
    pose is the true one."""
    rng = np.random.default_rng(2)
    pts, nrm, _ = make_room(rng, n_per_plane=800, noise=0.002,
                            extra_planes=2)
    R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    sp0, sn0 = pts, nrm
    if swap:      # a source >= 1.2x the target swaps the two
        extra = rng.random(pts.shape[0]) < 0.25
        sp0 = np.concatenate([pts, pts[extra] + rng.normal(
            scale=0.002, size=(int(extra.sum()), 3)).astype(np.float32)])
        sn0 = np.concatenate([nrm, nrm[extra]])
    spts, snrm = transform_cloud(sp0, sn0, R.T, -R.T @ t)
    supports = []
    real = ransac._cached_extractor

    def recording(cfg, num_points):
        fn = real(cfg, num_points)

        def run(*args, **kwargs):
            supports.append((args[3], kwargs["init_support"]))
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(ransac, "_cached_extractor", recording)
    T, info = pipeline.register_clouds(pts, nrm, spts, snrm, FAST, seed=0,
                                       ransac_min_support=(300, 400),
                                       device="cpu")
    assert info["swapped"] is swap
    want = [(400, 400), (300, 300)] if swap else [(300, 300), (400, 400)]
    assert supports == want
    assert info["success"], info
    assert rotation_error_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.15
    assert info["tgt_planes"] >= FAST.min_planes
