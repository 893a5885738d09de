"""The JAX package's last public functions and their counterparts in the
port, on the same numpy inputs, on the CPU.

* ``geometry``: ``apply_rigid``, ``kabsch`` (weighted and unweighted),
  ``intersect_two_lines``, ``point_line_distance`` and
  ``point_segment_distance`` within 1e-5 (float32 reductions in another
  order); ``knn.count_within`` and ``core.types.PoseSet`` equal.
* ``extract.ransac.make_extractor``: a cached standalone extractor that
  honours ``max_extract``, on the reference's replayed draws (plane count
  and rounds equal, coefficients within 1e-4); the host-side
  ``select_planes`` bit for bit the reference's on one PlaneSet.
* Every public module-level ``def`` and ``class`` of ``plade_tpu/`` has a
  counterpart of that name in ``plade_tpu_torch/``, but for the five with
  no torch meaning."""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu.core import types as jtypes
from plade_tpu.core.types import PlaneSet as JPlaneSet
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.extract import ransac as jr
from plade_tpu.geometry import lines as jlines
from plade_tpu.geometry import transforms as jtransforms
from plade_tpu.knn import bruteforce as jbf
from plade_tpu_torch.core import types as ptypes
from plade_tpu_torch.core.convert import config_from
from plade_tpu_torch.core.types import PlaneSet, pad_cloud
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.geometry import lines, transforms
from plade_tpu_torch.knn import bruteforce
from test_extract import TEST_CFG
from test_torch_extract import _replayed_draws, _scene
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

#: public names of the JAX package that have no torch meaning: GSPMD
#: partition specs and their jit (the mesh's groups split the work
#: themselves), XLA's compile cache, and the jit of ``average_spacing``
NO_COUNTERPART = {"batch_specs", "result_specs", "make_batch_register",
                  "enable_compile_cache", "average_spacing_jit"}


def _both(*arrays):
    """The arrays as float32 jnp arrays and as CPU tensors."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(mine, ref, atol=1e-5):
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=atol)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


# ------------------------------------------------------------ geometry

def test_apply_rigid(rng):
    R = np.stack([_rotation(rng) for _ in range(4)])
    j, t = _both(R, rng.normal(size=(4, 3)), rng.normal(size=(4, 50, 3)))
    _close(transforms.apply_rigid(*t), jtransforms.apply_rigid(*j))


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch(rng, weighted):
    src = rng.normal(size=(200, 3))
    R, t = _rotation(rng), rng.normal(size=3)
    dst = src @ R.T + t + rng.normal(scale=0.01, size=src.shape)
    w = rng.uniform(0.1, 1.0, size=200)
    j, p = _both(src, dst, w)
    jR, jt = jtransforms.kabsch(j[0], j[1], j[2] if weighted else None)
    pR, pt = transforms.kabsch(p[0], p[1], p[2] if weighted else None)
    _close(pR, jR)
    _close(pt, jt)
    np.testing.assert_allclose(pR.numpy(), R, atol=0.01)
    assert np.linalg.det(pR.numpy()) == pytest.approx(1.0, abs=1e-5)


def test_intersect_two_lines(rng):
    u1, p1, u2, p2 = (rng.normal(size=(64, 3)) for _ in range(4))
    u2[:8] = u1[:8] * 3.0                       # parallel: invalid
    j, t = _both(u1, p1, u2, p2)
    jpt, jvalid = jlines.intersect_two_lines(*j)
    pt, valid = lines.intersect_two_lines(*t)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid[:8].any() and valid[8:].all()
    _close(pt, jpt, atol=1e-4)


def test_point_line_and_segment_distance(rng):
    pts, u, p, a, b = (rng.normal(size=(64, 3)) for _ in range(5))
    b[:4] = a[:4]                               # degenerate segments
    j, t = _both(pts, u, p, a, b)
    _close(lines.point_line_distance(*t[:3]),
           jlines.point_line_distance(*j[:3]))
    _close(lines.point_segment_distance(t[0], t[3], t[4]),
           jlines.point_segment_distance(j[0], j[3], j[4]))


@pytest.mark.parametrize("Q, T, radius, block", [(300, 1000, 0.4, 2048),
                                                 (57, 5000, 0.25, 512)])
def test_count_within(rng, Q, T, radius, block):
    j, t = _both(rng.normal(size=(Q, 3)), rng.normal(size=(T, 3)))
    mine = bruteforce.count_within(*t, radius, block)
    want = np.asarray(jbf.count_within(*j, radius, block))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), want)
    assert want.sum() > 0


def test_pose_set():
    assert ptypes.PoseSet._fields == jtypes.PoseSet._fields
    ps = ptypes.PoseSet(torch.eye(3)[None], torch.zeros(1, 3),
                        torch.ones(1, dtype=torch.bool))
    assert ps.R.shape == (1, 3, 3) and bool(ps.valid[0])


# ------------------------------------------------------------ extraction

def test_make_extractor_honours_max_extract(rng):
    pts, nrm, min_support, _ = _scene(rng, "room")
    max_extract = 4
    n = pts.shape[0]
    pad = 1 << (n - 1).bit_length()
    jc = jpad_cloud(pts, nrm, pad)
    key = jax.random.PRNGKey(0)
    jp, js = jr.make_extractor(TEST_CFG, pad, max_extract=max_extract)(
        jc.points, jc.normals, jc.count, key, min_support)
    tcfg = config_from(TEST_CFG)
    extract = ransac.make_extractor(tcfg, pad, max_extract)
    assert ransac.make_extractor(tcfg, pad, max_extract) is extract
    tc = pad_cloud(pts, nrm, pad, "cpu")
    tp, ts = extract(tc.points, tc.normals, tc.count, min_support,
                     draws=_replayed_draws(key, pad, tcfg))
    assert tp.coeffs.shape == (max_extract, 4)
    count = int(jp.count)
    assert int(tp.count) == count == max_extract
    assert int(ts.rounds) == int(js.rounds)
    np.testing.assert_allclose(tp.coeffs.numpy(), np.asarray(jp.coeffs),
                               atol=1e-4)


def _plane_set(rng, n, P0=24, N=3000):
    """A greedy-order PlaneSet of ``n`` planes (sizes falling with noise,
    ties included) and the point labels, as numpy arrays."""
    sizes = np.zeros(P0, np.int32)
    sizes[:n] = np.sort(rng.integers(150, 12000, size=n))[::-1]
    sizes[1:n:5] = sizes[0:max(n - 1, 0):5]      # ties
    coeffs = rng.normal(size=(P0, 4)).astype(np.float32)
    point_plane = rng.integers(-1, max(n, 1), size=N).astype(np.int32)
    return JPlaneSet(coeffs=coeffs, sizes=sizes, count=np.int32(n),
                     point_plane=point_plane)


@pytest.mark.parametrize("n, min_planes, max_planes", [
    (20, 10, 12), (20, 4, 6), (6, 10, 12), (0, 10, 12), (24, 2, 16)])
def test_host_select_planes_matches_reference(rng, n, min_planes,
                                              max_planes):
    cfg = dataclasses.replace(TEST_CFG, min_planes=min_planes,
                              max_planes=max_planes,
                              ransac_min_allowed_support=200,
                              ransac_init_min_support=10000)
    planes = _plane_set(rng, n)
    want = jr.select_planes(planes, cfg)
    for given in (planes, PlaneSet(*(torch.from_numpy(np.array(x))
                                     for x in planes))):
        mine = ransac.select_planes(given, config_from(cfg))
        for f in JPlaneSet._fields:
            a, b = getattr(mine, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# ------------------------------------------------------------ names

def _public_names(root: Path) -> set:
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                    and not node.name.startswith("_"):
                names.add(node.name)
    return names


def test_every_public_name_has_a_counterpart():
    repo = Path(__file__).resolve().parent.parent
    ref = _public_names(repo / "plade_tpu")
    port = _public_names(repo / "plade_tpu_torch")
    assert NO_COUNTERPART <= ref
    assert sorted(ref - port - NO_COUNTERPART) == []
    assert not NO_COUNTERPART & port
