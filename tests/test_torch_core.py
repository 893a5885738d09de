"""The port's core against the reference package: the copied config, scene
generators and PLY reader/writer, the numpy converters, the helpers
standing in for JAX primitives, and the rule that the port never imports
JAX."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plade_tpu.io.ply as jply
import plade_tpu.io.synthetic as jsyn
from plade_tpu.core import types as jtypes
from plade_tpu.core.config import PladeConfig as JConfig
from plade_tpu_torch.core import ops, types
from plade_tpu_torch.core.config import PladeConfig
from plade_tpu_torch.core.convert import config_from, from_numpy, to_numpy
from plade_tpu_torch.io import ply as tply
from plade_tpu_torch.io import synthetic as tsyn
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

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
                                  "make_plane_points", "make_world",
                                  "make_scan_sequence"])
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
        if name == "make_world":
            return list(mod.make_world(rng, n_rooms=2, n_per_plane=150,
                                       noise=0.01, extra_planes=2,
                                       normal_noise_deg=3.0))
        if name == "make_scan_sequence":
            scans, poses = mod.make_scan_sequence(
                rng, n_scans=3, n_points=800, overlap_radius=3.4, step=2.0,
                n_rooms=3, n_per_plane=300, noise=0.02, extra_planes=3,
                normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)
            return [a for scan in scans for a in scan] + [poses]
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


def _ply_files(tmp_path, rng):
    """PLY files of every kind the readers parse: the reference writer's
    binary and ascii output, with and without normals, and a hand-made
    big-endian file with extra vertex properties and a face list element
    after the vertices."""
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    nrm = rng.normal(size=(57, 3)).astype(np.float32)
    files = {}
    for name, normals, binary in (("bin_normals", nrm, True),
                                  ("ascii_normals", nrm, False),
                                  ("bin_points", None, True),
                                  ("ascii_points", None, False)):
        files[name] = str(tmp_path / f"{name}.ply")
        jply.write_ply(files[name], pts, normals, binary=binary)
    rec = np.zeros(57, dtype=[("x", ">f8"), ("y", ">f8"), ("z", ">f8"),
                              ("red", "u1"), ("nx", ">f4"), ("ny", ">f4"),
                              ("nz", ">f4")])
    for i, f in enumerate("xyz"):
        rec[f] = pts[:, i]
        rec["n" + f] = nrm[:, i]
    header = ("ply\nformat binary_big_endian 1.0\nelement vertex 57\n"
              "property double x\nproperty double y\nproperty double z\n"
              "property uchar red\nproperty float nx\nproperty float ny\n"
              "property float nz\nelement face 1\n"
              "property list uchar int vertex_indices\nend_header\n")
    files["big_endian_extra"] = str(tmp_path / "big_endian_extra.ply")
    with open(files["big_endian_extra"], "wb") as f:
        f.write(header.encode("ascii") + rec.tobytes()
                + np.array([3], ">u1").tobytes()
                + np.array([0, 1, 2], ">i4").tobytes())
    return files


def test_ply_copy_matches_reference(tmp_path, rng):
    """The port's reader returns what the reference's reads (its numpy path
    and its entry point), bit for bit, on every file; the port's writer
    writes the reference writer's bytes."""
    for name, path in _ply_files(tmp_path, rng).items():
        got = tply.read_ply(path)
        for want in (jply._read_ply_numpy(path), jply.read_ply(path)):
            for a, b in zip(got, want, strict=True):
                if b is None:
                    assert a is None, name
                    continue
                assert a.dtype == b.dtype == np.float32, name
                np.testing.assert_array_equal(a, b, err_msg=name)
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    for normals in (pts[::-1].copy(), None):
        for binary in (True, False):
            mine, ref = tmp_path / "mine.ply", tmp_path / "ref.ply"
            tply.write_ply(str(mine), pts, normals, binary=binary)
            jply.write_ply(str(ref), pts, normals, binary=binary)
            assert mine.read_bytes() == ref.read_bytes()
            back = tply.read_ply(str(mine))
            np.testing.assert_array_equal(back[0], pts)
            if normals is not None:
                np.testing.assert_array_equal(back[1], normals)


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


_HOST_CASES = {
    "float32": torch.tensor([[1.5, -0.0, float("nan")],
                             [float("inf"), -float("inf"), 1e-45]]),
    "int32": torch.tensor([2**31 - 1, -(2**31 - 1), 0, -1],
                          dtype=torch.int32),
    "bool": torch.tensor([[True, False], [False, True]]),
    "0-d": torch.tensor(3.25),
}


@pytest.mark.parametrize("name", sorted(_HOST_CASES))
def test_host_tensors_round_trip(name):
    """Each case beside the others, in one host sync: every tensor back
    with its shape, dtype and bits (a float32 compared as int32 bits, so
    NaN and the subnormal count too)."""
    want = [_HOST_CASES[name], torch.tensor([7, -8], dtype=torch.int32),
            torch.tensor(True)]
    syncs = types.HOST_SYNCS["count"]
    got = types.host_tensors(want)
    assert types.HOST_SYNCS["count"] == syncs + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if b.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_host_tensors_refuses_int64():
    with pytest.raises(TypeError):
        types.host_tensors([torch.zeros(3), torch.tensor([2**40])])


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


def test_index_sum_matches_segment_sum(rng):
    """On the CPU ``index_sum`` is ``index_add_`` (rows added in index
    order), and both agree with ``jax.ops.segment_sum``."""
    import jax
    idx = rng.integers(0, 50, size=4000)
    vals = rng.normal(size=(4000, 3)).astype(np.float32)
    got = ops.index_sum(torch.zeros(50, 3), torch.from_numpy(idx),
                        torch.from_numpy(vals))
    want = torch.zeros(50, 3).index_add_(0, torch.from_numpy(idx),
                                         torch.from_numpy(vals))
    assert torch.equal(got, want)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx),
                                         num_segments=50))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_port_imports_without_jax():
    code = ("import sys; import plade_tpu_torch, plade_tpu_torch.pipeline, "
            "plade_tpu_torch.core.convert; "
            "import plade_tpu_torch.io.synthetic, plade_tpu_torch.io.ply, "
            "plade_tpu_torch.extract.ransac, plade_tpu_torch.kernels.cc, "
            "plade_tpu_torch.dist.mesh, plade_tpu_torch.dist.posegraph, "
            "plade_tpu_torch.cli.main, plade_tpu_torch.cli.scene, "
            "plade_tpu_torch.cli.viewer, plade_tpu_torch.io.resso, "
            "plade_tpu_torch.io.native, plade_tpu_torch.io.vg, "
            "plade_tpu_torch.dist.multihost, plade_tpu_torch.utils.timing; "
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
