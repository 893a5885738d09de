"""The port's core against the reference package: the copied config and
scene generators, the numpy converters, the helpers standing in for JAX
primitives, and the rule that the port never imports JAX."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plade_tpu.io.synthetic as jsyn
from plade_tpu.core import types as jtypes
from plade_tpu.core.config import PladeConfig as JConfig
from plade_tpu_torch.core import ops, types
from plade_tpu_torch.core.config import PladeConfig
from plade_tpu_torch.core.convert import config_from, from_numpy, to_numpy
from plade_tpu_torch.io import synthetic as tsyn

REPO = Path(__file__).resolve().parent.parent


def test_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(PladeConfig)]
    assert tf == jf
    # derived parameters are the same python-float arithmetic
    assert dataclasses.asdict(PladeConfig().derived(0.0123)) == \
        dataclasses.asdict(JConfig().derived(0.0123))


def test_config_from_round_trip():
    jcfg = dataclasses.replace(JConfig(), max_planes=12, overlap_grid=64)
    cfg = config_from(jcfg)
    assert isinstance(cfg, PladeConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("name", ["make_room", "make_room_noisy_faces",
                                  "random_rigid", "transform_cloud",
                                  "make_plane_points"])
def test_synthetic_copy_bit_identical(name):
    """Same seed, same arrays, bit for bit (tolerance 0: the copy is the
    same numpy code)."""
    def run(mod):
        rng = np.random.default_rng(7)
        if name == "make_room":
            p, n, planes = mod.make_room(rng, n_per_plane=300)
            return [p, n] + [np.asarray(a) for pl in planes for a in pl]
        if name == "make_room_noisy_faces":
            p, n, planes = mod.make_room(
                rng, n_per_plane=200, noise=0.003, extra_planes=3,
                normal_noise_deg=2.0, faces=("floor", "wall_y-", "wall_x+"))
            return [p, n] + [np.asarray(a) for pl in planes for a in pl]
        if name == "random_rigid":
            return list(mod.random_rigid(rng, max_angle=1.0, max_trans=0.5))
        if name == "transform_cloud":
            R, t = mod.random_rigid(rng)
            pts = rng.normal(size=(50, 3)).astype(np.float32)
            return list(mod.transform_cloud(pts, pts, R, t))
        return list(mod.make_plane_points(rng, (0, 0, 1), (1, 0, 0),
                                          (0, 1, 0), 1.0, 2.0, 100,
                                          noise=0.01, normal_noise_deg=3.0))
    for a, b in zip(run(jsyn), run(tsyn), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_planes(n):
    return jtypes.PlaneSet(
        coeffs=jnp.asarray(np.arange(16, dtype=np.float32).reshape(4, 4)),
        sizes=jnp.asarray(np.array([5, 4, 3, 0], np.int32)),
        count=jnp.asarray(3, jnp.int32),
        point_plane=jnp.asarray(np.arange(n, dtype=np.int32) % 3))


def test_from_numpy_to_numpy_round_trip(rng):
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    jcloud = jtypes.pad_cloud(pts, pts, 16)
    for jobj in (jcloud, _jax_planes(16)):
        tobj = from_numpy(jobj)
        assert type(tobj).__name__ == type(jobj).__name__
        assert type(tobj).__module__ == "plade_tpu_torch.core.types"
        back = to_numpy(tobj)
        for f in type(tobj)._fields:
            a, b = np.asarray(getattr(jobj, f)), getattr(back, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(jobj.mask),
                                      tobj.mask.numpy())


def test_pad_cloud_and_se3_match_reference(rng):
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    nrm = rng.normal(size=(7, 3)).astype(np.float32)
    j = jtypes.pad_cloud(pts, nrm, 12)
    t = types.pad_cloud(pts, nrm, 12, "cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    R = rng.normal(size=(3, 3)).astype(np.float32)
    tr = rng.normal(size=3).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jtypes.se3_matrix(jnp.asarray(R), jnp.asarray(tr))),
        types.se3_matrix(torch.from_numpy(R), torch.from_numpy(tr)).numpy())


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_nonzero_static_matches_jnp(rng, density):
    mask = rng.uniform(size=97) < density
    for size in (5, 40, 120):
        want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                      fill_value=97)[0])
        got = ops.nonzero_static(torch.from_numpy(mask), size, 97).numpy()
        np.testing.assert_array_equal(got, want)


def test_lexsort_matches_jnp(rng):
    """Few distinct values per key, so ties at every level must resolve
    like jnp.lexsort (stable, last key primary)."""
    keys = [rng.integers(-3, 3, size=200).astype(np.int32) for _ in range(3)]
    want = np.asarray(jnp.lexsort([jnp.asarray(k) for k in keys]))
    got = ops.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_imports_without_jax():
    code = ("import sys; import plade_tpu_torch, plade_tpu_torch.pipeline, "
            "plade_tpu_torch.core.convert; "
            "import plade_tpu_torch.io.synthetic; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('plade_tpu.') or m == 'plade_tpu' "
            "for m in sys.modules), 'plade_tpu imported'; "
            "import torch; "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "assert torch.get_float32_matmul_precision() == 'highest'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("flag", [
    dict(enable_degraded_families=True),
    dict(min_line_confidence=1.0),
    dict(enable_icp=True),
])
def test_unported_options_raise(flag):
    from plade_tpu_torch.pipeline import register_with_planes
    cfg = dataclasses.replace(PladeConfig(), **flag)
    pts = np.zeros((4, 3), np.float32)
    planes = types.PlaneSet(np.zeros((2, 4), np.float32),
                            np.zeros(2, np.int32), np.int32(0),
                            np.full(4, -1, np.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        register_with_planes(pts, pts, pts, pts, planes, planes, cfg)
