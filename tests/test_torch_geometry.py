"""The port's geometry against the reference package on the same arrays.

Tolerances: float32 closed forms evaluated by two frameworks agree to a
few ulps of their O(1) inputs, so 1e-5 absolute (1e-4 for eigenvectors of
nearly degenerate spectra, where the closed form loses half its digits).
Voxel cell order and counts are compared exactly: ``max_out`` truncation
keeps a prefix of that order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu.geometry import eig3 as jeig3
from plade_tpu.geometry import lines as jlines
from plade_tpu.geometry import obb as jobb
from plade_tpu.geometry import transforms as jtr
from plade_tpu.geometry import voxel as jvoxel
from plade_tpu_torch.geometry import eig3, lines, obb, transforms, voxel
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
        rtol=0, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_transforms_match(rng):
    a, b, c, d = (_unit(rng, 64) for _ in range(4))
    _close(transforms.rotation_from_two_vecs(_t(a), _t(b), _t(c), _t(d)),
           jtr.rotation_from_two_vecs(a, b, c, d))
    R = np.asarray(jtr.rotation_from_two_vecs(a, b, c, d))
    for got, want in zip(transforms.euler_angles(_t(R)),
                         jtr.euler_angles(jnp.asarray(R))):
        _close(got, want)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    v[0] = 0.0
    _close(transforms.normalize(_t(v)), jtr.normalize(v))


def _sym_cases(rng):
    A = rng.normal(size=(200, 3, 3)).astype(np.float32)
    spd = np.einsum("nij,nkj->nik", A, A) / 3
    degenerate = np.stack([
        np.diag([2.0, 0.0, 0.0]), np.diag([1.0, 1.0, 0.0]),
        np.diag([0.0, 0.0, 0.0]), np.eye(3) * 3.0,
        np.diag([1.0, 2.0, 3.0]), np.diag([5.0, 5.0, 1.0]),
    ]).astype(np.float32)
    # planar covariances: one tiny eigenvalue (plane fits, plane OBBs)
    flat = spd.copy()
    flat[:, 2, :] *= 1e-3
    flat[:, :, 2] *= 1e-3
    return {"spd": spd, "degenerate": degenerate, "flat": flat}


@pytest.mark.parametrize("case", ["spd", "degenerate", "flat"])
def test_sym_eigh3_matches(rng, case):
    A = _sym_cases(rng)[case]
    jv, jV = jeig3.sym_eigh3(jnp.asarray(A))
    tv, tV = eig3.sym_eigh3(_t(A))
    _close(tv, jv, atol=1e-5 * max(1.0, float(np.abs(A).max())))
    # same vectors, same order and same signs: they feed the OBB corners
    _close(tV, jV, atol=1e-4)


def test_compute_obb_matches(rng):
    pts = (rng.normal(size=(6, 300, 3)) * [2.0, 1.0, 0.05]).astype(
        np.float32)
    mask = rng.uniform(size=(6, 300)) < 0.8
    pts[~mask] = 1e8
    j = jobb.compute_obb(jnp.asarray(pts), jnp.asarray(mask))
    t = obb.compute_obb(_t(pts), _t(mask))
    for f in ("center", "axes", "extents", "corners", "radius"):
        _close(getattr(t, f), getattr(j, f), atol=1e-4)


def test_lines_match(rng):
    n1, n2 = _unit(rng, 100), _unit(rng, 100)
    n2[:5] = n1[:5]                                # parallel pairs
    c1 = np.concatenate([n1, rng.normal(size=(100, 1))], 1).astype(
        np.float32)
    c2 = np.concatenate([n2, rng.normal(size=(100, 1))], 1).astype(
        np.float32)
    jd, jp, jv = jlines.intersect_planes(c1, c2, 0.95)
    td, tp, tv = lines.intersect_planes(_t(c1), _t(c2), 0.95)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(td[tv], np.asarray(jd)[np.asarray(jv)])
    _close(tp[tv], np.asarray(jp)[np.asarray(jv)], atol=1e-4)
    p1 = rng.normal(size=(100, 3)).astype(np.float32)
    p2 = rng.normal(size=(100, 3)).astype(np.float32)
    for a, b in zip(lines.closest_points_two_lines(_t(n1), _t(p1), _t(n2),
                                                   _t(p2)),
                    jlines.closest_points_two_lines(n1, p1, n2, p2)):
        _close(a, b, atol=1e-4)
    _close(lines.project_points_to_plane(_t(p1), _t(c1)),
           jlines.project_points_to_plane(p1, c1))


def _voxel_cloud(rng, n, spread):
    """Points over ``spread`` units with a leaf of 0.01: cell indices up to
    spread/0.01, far past the ~30 where ``ix * 73856093`` leaves int32."""
    pts = rng.uniform(0, spread, size=(n, 3)).astype(np.float32)
    # clumps: several points per occupied cell
    pts[n // 2:] = pts[:n - n // 2] + rng.normal(
        scale=0.001, size=(n - n // 2, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    pts[~mask] = 1e8
    return pts, mask


@pytest.mark.parametrize("spread,max_out", [(0.2, 2048), (40.0, 4096),
                                            (40.0, 300)])
def test_voxel_downsample_matches(rng, spread, max_out):
    pts, mask = _voxel_cloud(rng, 4000, spread)
    nrm = _unit(rng, 4000)
    leaf = np.float32(0.01)
    if spread > 1:
        ijk = np.floor((pts[mask] - pts[mask].min(0)) / leaf)
        assert ijk.max() * 73856093 > 2 ** 31      # the hashes wrap
    j = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask),
                                jnp.float32(leaf), max_out,
                                normals=jnp.asarray(nrm))
    t = voxel.voxel_downsample(_t(pts), _t(mask), torch.tensor(leaf),
                               max_out, normals=_t(nrm))
    assert int(t.count) == int(j.count)
    # same cells in the same order: centroids agree to summation order
    _close(t.points, j.points, atol=1e-5 * max(1.0, spread))
    _close(t.normals, j.normals, atol=1e-5)


@pytest.mark.parametrize("spread,max_out", [(0.3, 512), (40.0, 64)])
def test_voxel_downsample_by_plane_matches(rng, spread, max_out):
    pts, mask = _voxel_cloud(rng, 4000, spread)
    P = 7
    pp = rng.integers(-1, P + 1, size=4000).astype(np.int32)  # -1 and P: none
    leaf = np.float32(0.01)
    jp, jc = jvoxel.voxel_downsample_by_plane(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pp),
        jnp.float32(leaf), P, max_out)
    tp, tc = voxel.voxel_downsample_by_plane(
        _t(pts), _t(mask), _t(pp), torch.tensor(leaf), P, max_out)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _close(tp, jp, atol=1e-5 * max(1.0, spread))


def test_cell_hash_wraps_like_int32(rng):
    ijk = rng.integers(0, 2 ** 20, size=(1000, 3)).astype(np.int32)
    want1 = np.asarray(jvoxel._cell_hash(*(jnp.asarray(ijk[:, k])
                                           for k in range(3))))
    want2 = np.asarray(jvoxel._cell_hash2(*(jnp.asarray(ijk[:, k])
                                            for k in range(3))))
    cols = [torch.from_numpy(ijk[:, k].astype(np.int64)) for k in range(3)]
    np.testing.assert_array_equal(voxel._cell_hash(*cols).numpy(), want1)
    np.testing.assert_array_equal(voxel._cell_hash2(*cols).numpy(), want2)
