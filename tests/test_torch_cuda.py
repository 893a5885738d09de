"""K1 and K2 on a card: each CUDA kernel against its plain PyTorch version
on the same CUDA tensors.  These tests import no JAX, so that they also
run on a machine that has a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card they skip.  Tolerance: d2 to 1e-6 relative, as the kernels
and the plain versions compute d2 with the same operations in the same
order (``csrc/nn.cu`` is built without fused multiply-add); an index may
differ from the plain version's only where the two distances tie to that
tolerance."""
import numpy as np
import pytest
import torch

from plade_tpu_torch.kernels import nn


def _inputs(Q, T, seed=0):
    """Normal points with duplicated references (ties), queries on the
    duplicates, one query whose normal disagrees with every reference
    normal (+inf row), and BIG-padded references and queries."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, 3)).astype(np.float32)
    r = rng.normal(size=(T, 3)).astype(np.float32)
    qn = rng.normal(size=(Q, 3))
    rn = rng.normal(size=(T, 3))
    rn[:, 2] = np.abs(rn[:, 2]) + 0.5
    r[10:20] = r[5]
    q[0:4] = r[5]
    qn[3] = [0.0, 0.0, -1.0]
    r[-64:] = 1e8
    q[-16:] = 1e8
    qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    rn = rn / np.linalg.norm(rn, axis=1, keepdims=True)
    rn[-64:] = 0.0
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            for a in (q, qn, r, rn)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", [(1000, 777), (4096, 16384)])
def test_cuda_kernels_match_plain(Q, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, qn, r, rn = _inputs(Q, T)
    before = dict(nn.LAUNCHES)
    d, i = nn.nearest_neighbor(q, r)
    o = nn.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["nearest_neighbor"] == before["nearest_neighbor"] + 1
    assert nn.LAUNCHES["oriented_min_dist_sq"] \
        == before["oriented_min_dist_sq"] + 1

    dp, ip = nn.nearest_neighbor_plain(q, r)
    assert torch.isfinite(d).all()
    torch.testing.assert_close(d, dp, rtol=1e-6, atol=0)
    assert (i[0:4] == 5).all()                   # lowest tied index
    assert int(i[:-16].max()) < T - 64            # padding never wins
    qd, rd = q.double(), r.double()
    da = ((qd - rd[i.long()]) ** 2).sum(1)
    db = ((qd - rd[ip.long()]) ** 2).sum(1)
    assert not ((i != ip) & ((da - db).abs() > 1e-6 * db)).any()

    op = nn.oriented_min_dist_sq_plain(q, qn, r, rn, 0.5)
    fin = torch.isfinite(op)
    assert torch.equal(torch.isfinite(o), fin)
    assert not fin[3] and not torch.isnan(o).any()
    torch.testing.assert_close(o[fin], op[fin], rtol=1e-6, atol=0)
