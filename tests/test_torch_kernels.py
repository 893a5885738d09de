"""K1 and K2 (``plade_tpu_torch/kernels/nn.py``) on the CPU: the plain
versions against the Pallas kernels in interpret mode and against float64
numpy, on the cases of ``tests/test_kernels.py`` plus ties.  CPU tensors
must never count a kernel launch.  The CUDA kernels themselves run only on
a card: ``tests/test_torch_cuda.py`` holds them to these plain versions.

Tolerances: against the Pallas kernel, which computes d2 in the same
difference form, 1e-6 relative (rounding of the last op only); against
float64, 1e-5 relative with 1e-6 absolute (the float32 rounding of the
inputs' differences)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu.kernels import nn as jnn
from plade_tpu.knn import bruteforce as jbf
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.knn import bruteforce


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _f64_d2(q, r):
    return ((q.astype(np.float64)[:, None, :]
             - r.astype(np.float64)[None, :, :]) ** 2).sum(-1)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _nn_cases(rng):
    q = rng.normal(size=(301, 3)).astype(np.float32)
    r = rng.normal(size=(1234, 3)).astype(np.float32)
    # ties: duplicated refs, and queries sitting on them
    r[40:50] = r[7]
    r[900] = r[7]
    q[:5] = r[7]
    small_q = rng.normal(size=(16, 3)).astype(np.float32)
    small_r = rng.normal(size=(5, 3)).astype(np.float32)
    padded_r = np.concatenate([r[:600], np.full((200, 3), 1e8, np.float32)])
    padded_q = np.concatenate([q, np.full((7, 3), 1e8, np.float32)])
    return {"random_ties": (q, r), "fewer_refs_than_a_tile":
            (small_q, small_r), "padded_refs": (q, padded_r),
            "padded_queries": (padded_q, r)}


@pytest.mark.parametrize("case", ["random_ties", "fewer_refs_than_a_tile",
                                  "padded_refs", "padded_queries"])
def test_nearest_neighbor_plain_matches_pallas_and_f64(rng, case):
    q, r = _nn_cases(rng)[case]
    d, i = nn.nearest_neighbor(_t(q), _t(r))
    jd, ji = jnn.nearest_neighbor(jnp.asarray(q), jnp.asarray(r), bq=128,
                                  bt=512, interpret=True)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    # padded queries (BIG) only need finite values: callers mask them, and
    # the Pallas kernel's own block padding (also BIG) decides theirs
    assert torch.isfinite(d).all()
    real = q[:, 0] < 1e7
    np.testing.assert_allclose(d.numpy()[real], np.asarray(jd)[real],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i.numpy()[real], np.asarray(ji)[real])
    d64 = _f64_d2(q, r)
    np.testing.assert_allclose(d.numpy(), d64.min(1), rtol=1e-5, atol=1e-6)
    # argmin of the float64 distances, lowest index among exact ties
    np.testing.assert_array_equal(i.numpy()[real], d64.argmin(1)[real])
    if case == "random_ties":
        assert (i[:5] == 7).all()                  # lowest tied index
    if case == "padded_refs":
        assert int(i[real].max()) < 600            # padding never wins
    if case == "fewer_refs_than_a_tile":
        assert int(i.max()) < 5


def test_min_dist_sq_is_nearest_neighbor_distance(rng):
    q, r = _nn_cases(rng)["random_ties"]
    d, _ = nn.nearest_neighbor(_t(q), _t(r))
    np.testing.assert_array_equal(nn.min_dist_sq(_t(q), _t(r)).numpy(),
                                  d.numpy())
    np.testing.assert_array_equal(
        bruteforce.min_dist_sq(_t(q), _t(r)).numpy(), d.numpy())


def _oriented_case(rng, n_q=77, n_r=999):
    q = rng.normal(size=(n_q, 3)).astype(np.float32)
    qn = _unit(rng.normal(size=(n_q, 3)))
    r = rng.normal(size=(n_r, 3)).astype(np.float32)
    rn = _unit(rng.normal(size=(n_r, 3)))
    # one query whose normal is opposite to every reference normal
    rn[:, 2] = np.abs(rn[:, 2]) + 0.5
    rn = _unit(rn)
    qn[3] = [0.0, 0.0, -1.0]
    # padded refs: BIG coordinates, zero normals
    r[-50:] = 1e8
    rn[-50:] = 0.0
    return q, qn, r, rn


@pytest.mark.parametrize("cos", [0.95, 0.7071067811865476, 0.0])
def test_oriented_plain_matches_pallas_and_f64(rng, cos):
    q, qn, r, rn = _oriented_case(rng)
    d = nn.oriented_min_dist_sq(_t(q), _t(qn), _t(r), _t(rn), cos)
    jd = np.asarray(jnn.oriented_min_dist_sq(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(r), jnp.asarray(rn),
        cos, bq=64, bt=512, interpret=True))
    got = d.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(got[fin], jd[fin], rtol=1e-6, atol=0)
    d64 = _f64_d2(q, r)
    gate = (qn.astype(np.float64) @ rn.astype(np.float64).T) >= cos
    want = np.where(gate, d64, np.inf).min(1)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    if cos > 0:
        assert np.isinf(got[3])                    # the +inf row
        # zero-normal padded refs never pass a positive gate
        assert np.all(got[fin] < 1e10)


def test_wrappers_validate_inputs():
    q = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        nn.nearest_neighbor(q.double(), q.double())
    with pytest.raises(ValueError):
        nn.nearest_neighbor(torch.zeros(4, 2), q)
    with pytest.raises(ValueError):
        nn.nearest_neighbor(torch.zeros(3, 4).T, q)      # not contiguous
    with pytest.raises(ValueError):
        nn.oriented_min_dist_sq(q, torch.zeros(5, 3), q, q, 0.5)


@pytest.mark.parametrize("n,samples", [(3000, 2000), (700, 2000)])
def test_average_spacing_matches_reference(rng, n, samples):
    """Exact top-k here, approx_min_k (exact off the TPU) there, on the
    same |q|^2 - 2 q.r + |r|^2 form: the spacings agree to float32
    summation order (1e-5 relative)."""
    pts = rng.uniform(0, 2, size=(4096, 3)).astype(np.float32)
    pts[n:] = 1e8
    mask = np.arange(4096) < n
    want = float(jbf.average_spacing(jnp.asarray(pts), jnp.asarray(mask), 6,
                                     samples))
    got = float(bruteforce.average_spacing(_t(pts), _t(mask), 6, samples))
    assert got == pytest.approx(want, rel=1e-5)

