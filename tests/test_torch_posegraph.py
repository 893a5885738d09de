"""The port's pose-graph synchronization (``plade_tpu_torch.dist.posegraph``)
on the CPU: the cases of ``tests/test_posegraph.py``, and the same edges,
made from a numpy seed, through both packages.

Parity is held on what the gauge fix makes unique: the synchronized ``R``
and ``t`` and the per-edge residuals, never the raw eigenvectors (``eigh``
may return another sign or basis of the top-3 eigenspace).  ``R``, ``t``
and the translation residuals agree within 1e-4.  The rotation residual is
compared through its cosine, within 1e-5: both packages take the angle as
``arccos`` of a float32 cosine, whose rounding near a zero angle is
amplified by 1 / sin(angle) (one float32 step below 1 is 0.028 degrees),
so residuals of a few hundredths of a degree differ by such steps between
any two float32 runs."""
import numpy as np
import pytest
import torch

from plade_tpu.dist import posegraph as jpg
from plade_tpu_torch.dist import posegraph
from test_posegraph import _make_scene, _pose_errors
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _sync(edges, K, max_edges=None):
    g = posegraph.from_edges(edges, K, max_edges=max_edges, device="cpu")
    R, t = posegraph.synchronize(g, K)
    return g, R, t


def test_chain_exact(rng):
    K = 6
    Rs, ts, edges = _make_scene(rng, K, [(i, i + 1) for i in range(K - 1)])
    _, R, t = _sync(edges, K)
    rerr, terr = _pose_errors(Rs, ts, R.numpy(), t.numpy())
    assert rerr.max() < 0.1, rerr
    assert terr.max() < 1e-3, terr


def test_loop_with_noise(rng):
    K = 8
    edges_ij = [(i, (i + 1) % K) for i in range(K)] + [(0, 4), (2, 6)]
    Rs, ts, edges = _make_scene(rng, K, edges_ij,
                                rot_noise=0.02, trans_noise=0.01)
    g, R, t = _sync(edges, K)
    rerr, terr = _pose_errors(Rs, ts, R.numpy(), t.numpy())
    assert rerr.max() < 3.0, rerr
    assert terr.max() < 0.1, terr
    ang, tr = posegraph.residuals(g, R, t)
    assert float(ang.max()) < 5.0


def test_padded_edges_ignored(rng):
    K = 4
    Rs, ts, edges = _make_scene(rng, K, [(0, 1), (1, 2), (2, 3)])
    _, R, t = _sync(edges, K, max_edges=8)  # 5 zero-weight pads
    rerr, terr = _pose_errors(Rs, ts, R.numpy(), t.numpy())
    assert rerr.max() < 0.1
    assert terr.max() < 1e-3


def _graph(kind, seed):
    """(edges, K, max_edges) of one graph kind, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        K = 6
        _, _, edges = _make_scene(rng, K, [(i, i + 1) for i in range(K - 1)])
        return edges, K, None
    if kind == "padded":
        K = 5
        _, _, edges = _make_scene(rng, K, [(0, 1), (1, 2), (2, 3), (3, 4),
                                           (0, 2)], rot_noise=0.01)
        return edges, K, 12
    K = 8
    edges_ij = [(i, (i + 1) % K) for i in range(K)] + [(0, 4), (2, 6)]
    _, _, edges = _make_scene(rng, K, edges_ij, rot_noise=0.02,
                              trans_noise=0.01)
    # scan-dependent weights, as scene mode gives (registration scores)
    edges = [(i, j, T, 0.3 + 0.1 * e) for e, (i, j, T, _) in
             enumerate(edges)]
    if kind == "duplicate":
        edges = edges + [edges[3], edges[8]]
    return edges, K, None


@pytest.mark.parametrize("kind", ["chain", "noisy_loop", "padded",
                                  "duplicate"])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_reference(kind, seed):
    """The same edges through both packages: R, t and the translation
    residuals within 1e-4, the rotation residuals' cosines within 1e-5."""
    edges, K, max_edges = _graph(kind, seed)
    jg = jpg.from_edges(edges, K, max_edges=max_edges)
    jR, jt = jpg.synchronize(jg, K)
    jang, jterr = (np.asarray(x) for x in jpg.residuals(jg, jR, jt))
    g, R, t = _sync(edges, K, max_edges)
    ang, terr = (x.numpy() for x in posegraph.residuals(g, R, t))
    assert R.dtype == t.dtype == torch.float32
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    np.testing.assert_allclose(terr, jterr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.cos(np.radians(ang.astype(np.float64))),
                               np.cos(np.radians(jang.astype(np.float64))),
                               rtol=0, atol=1e-5)


def test_duplicate_edge_accumulates():
    """A pair given twice weighs as that pair once at twice the weight: the
    scatters into the block matrix, the degrees and the incidence matrix
    accumulate over repeated indices."""
    edges, K, _ = _graph("noisy_loop", 3)
    twice = edges + [edges[2]]
    doubled = [(i, j, T, w * (2 if e == 2 else 1))
               for e, (i, j, T, w) in enumerate(edges)]
    _, R2, t2 = _sync(twice, K)
    _, Rd, td = _sync(doubled, K)
    _, R1, t1 = _sync(edges, K)
    np.testing.assert_allclose(R2.numpy(), Rd.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), td.numpy(), rtol=0, atol=1e-5)
    assert np.abs(t2.numpy() - t1.numpy()).max() > 1e-4
