"""K1, K2 and K3 on a card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors.  These tests import no JAX, so that they
also run on a machine that has a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card they skip.  Every result must equal the plain version's bit
for bit: the kernels and the plain versions compute d2 (and K1's normal
dot) with the same operations in the same order (``csrc/nn.cu`` is built
without fused multiply-add), K2's argmin takes the lowest index among ties
also across the reference slices its atomic merge joins, and K3 is
integer-only, also on a serpentine grid that 256 rounds leave unconverged
(the kernel's early stop against the plain version's full count)."""
import numpy as np
import pytest
import torch

import cc_grids
from plade_tpu_torch.core import ops
from plade_tpu_torch.kernels import cc, nn


def _inputs(Q, T, seed=0):
    """Normal points with reference 5 duplicated at 10-19 and at
    7 + 512 k (a copy in every reference slice), queries on the duplicate,
    one query whose normal disagrees with every reference normal (+inf
    row), and BIG-padded references and queries (where Q and T leave room
    for them)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, 3)).astype(np.float32)
    r = rng.normal(size=(T, 3)).astype(np.float32)
    qn = rng.normal(size=(Q, 3))
    rn = rng.normal(size=(T, 3))
    rn[:, 2] = np.abs(rn[:, 2]) + 0.5
    pad_r, pad_q = (64 if T > 128 else 0), (16 if Q > 32 else 0)
    if T > 20:
        r[10:20] = r[5]
        r[7:T - pad_r:512] = r[5]
        q[0:min(Q, 4)] = r[5]
    if Q > 3:
        qn[3] = [0.0, 0.0, -1.0]
    r[T - pad_r:] = 1e8
    q[Q - pad_q:] = 1e8
    qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    rn = rn / np.linalg.norm(rn, axis=1, keepdims=True)
    rn[T - pad_r:] = 0.0
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
            for a in (q, qn, r, rn)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", [
    (1000, 777), (4096, 16384),
    (131071, 16383),      # ragged against the block's queries and the tile
    (1, 16384), (4096, 1), (1, 1),
    (1000, 200000),       # small Q, many references: the finest split
])
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
    assert torch.equal(d, dp)
    assert torch.equal(i, ip)
    op = nn.oriented_min_dist_sq_plain(q, qn, r, rn, 0.5)
    assert torch.equal(o, op)
    if T > 20:
        assert (i[0:4] == 5).all()               # lowest tied index
    if Q > 3:
        assert torch.isinf(o[3])                  # no gate passes
    if T > 128 and Q > 32:
        assert int(i[:Q - 16].max()) < T - 64     # padding never wins


@pytest.mark.cuda
def test_cuda_reference_split_merges_ties_exactly():
    """Few queries against many references split the references over the
    most slices; reference 5's copy in every slice must lose to index 5,
    and an all-equal reference set must give index 0 to every query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    Q, T = 64, 100000
    assert nn.reference_slices(Q, T) > 1
    assert nn.reference_slices(Q, T, oriented=True) > 1
    q, qn, r, rn = _inputs(Q, T, seed=1)
    d, i = nn.nearest_neighbor(q, r)
    assert torch.equal(i, nn.nearest_neighbor_plain(q, r)[1])
    assert (i[0:4] == 5).all()
    same = torch.zeros((T, 3), device="cuda")
    d, i = nn.nearest_neighbor(q, same)
    assert (i == 0).all()
    assert torch.equal(d, nn.nearest_neighbor_plain(q, same)[0])
    o = nn.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    assert torch.equal(o, nn.oriented_min_dist_sq_plain(q, qn, r, rn, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [32, 64, 128, 48])  # 128, 48: generic instance
@pytest.mark.parametrize("L", [1, 6, 12])
@pytest.mark.parametrize("iters", [0, 1, 8, 256])
def test_cuda_close_and_label_matches_plain(G, L, iters):
    """Lanes: the serpentine, empty and full grids, the edge grids of
    ``cc_grids.edge_grids`` (a line across a word and warp edge, diagonal
    chains, diagonal pairs, a checkerboard, a plus on all four edges) and
    random grids; L = 12 holds all of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    occ = torch.from_numpy(cc_grids.grids(L, G, seed=L)).cuda()
    before = cc.LAUNCHES["close_and_label_lanes"]
    lab = cc.close_and_label_lanes(occ, iters)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["close_and_label_lanes"] == before + 1
    assert torch.equal(lab, cc.close_and_label_lanes_plain(occ, iters))
    one = cc.close_and_label(occ[0], iters)
    assert torch.equal(one, lab[0])
    if iters == 256 and L == 1 and G >= 48:
        # the serpentine is unconverged at 256 rounds, and its labels after
        # G * G rounds agree too
        done = cc.close_and_label_lanes(occ, G * G)
        assert not torch.equal(done, lab)
        assert torch.equal(done, cc.close_and_label_lanes_plain(occ, G * G))


@pytest.mark.cuda
def test_cuda_close_and_label_large_grid():
    """G = 128 at 300 rounds, aligned and misaligned, and odd sides (all
    the generic instance); G = 129 is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(3)
    occ = torch.from_numpy((rng.random((3, 128, 128)) < 0.3)
                           .astype(np.int32)).cuda()
    lab = cc.close_and_label_lanes(occ, 300)
    torch.cuda.synchronize()
    assert torch.equal(lab, cc.close_and_label_lanes_plain(occ, 300))
    shifted = torch.empty(3 * 128 * 128 + 1, dtype=torch.int32,
                          device="cuda")[1:].view(3, 128, 128)
    shifted.copy_(occ)
    assert shifted.data_ptr() % 8 == 4
    assert torch.equal(cc.close_and_label_lanes(shifted, 300), lab)
    for G in (1, 7, 127):                  # odd sides, generic instance
        occ = torch.from_numpy((rng.random((2, G, G)) < 0.4)
                               .astype(np.int32)).cuda()
        assert torch.equal(cc.close_and_label_lanes(occ, 300),
                           cc.close_and_label_lanes_plain(occ, 300))
    with pytest.raises(ValueError):
        cc.close_and_label_lanes(torch.zeros((1, 129, 129), dtype=torch.int32,
                                             device="cuda"))


def _pair_inputs(P, Q, T, seed=0):
    """P pairs of ``_inputs`` (each from its own seed, so that every pair
    holds reference 5's copies in every slice and its own tie rows), each
    pair shifted by 10 x its index so that no pair's references could
    serve another's queries."""
    per = [_inputs(Q, T, seed=seed + p) for p in range(P)]
    out = []
    for k in range(4):
        x = torch.stack([a[k] for a in per])
        if k in (0, 2):
            shift = 10.0 * torch.arange(P, device="cuda")[:, None, None]
            x = torch.where(x < 1e7, x + shift, x)
        out.append(x.contiguous())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("Q,T", [
    (1000, 777), (131071, 16383), (4096, 1), (1, 16384), (64, 100000)])
def test_cuda_pair_axis_matches_plain(P, Q, T):
    """One launch over P pairs, each pair against its own references:
    bit for bit the batched plain version and the plain version of each
    pair alone; the lowest tied index wins within the pair's own
    references, also across the slices of a split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, qn, r, rn = _pair_inputs(P, Q, T)
    before = dict(nn.LAUNCHES)
    d, i = nn.nearest_neighbor(q, r)
    o = nn.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["nearest_neighbor"] == before["nearest_neighbor"] + 1
    assert nn.LAUNCHES["oriented_min_dist_sq"] \
        == before["oriented_min_dist_sq"] + 1
    assert d.shape == i.shape == o.shape == (P, Q)
    dp, ip = nn.nearest_neighbor_plain(q, r)
    op = nn.oriented_min_dist_sq_plain(q, qn, r, rn, 0.5)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert torch.equal(o, op)
    for p in range(P):
        d1, i1 = nn.nearest_neighbor_plain(q[p], r[p])
        assert torch.equal(d[p], d1) and torch.equal(i[p], i1)
        assert torch.equal(o[p], nn.oriented_min_dist_sq_plain(
            q[p], qn[p], r[p], rn[p], 0.5))
    if T > 20:
        assert (i[:, 0:4] == 5).all()             # lowest tied index
    if Q > 3:
        assert torch.isinf(o[:, 3]).all()          # no gate passes


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", [(131072, 16384), (1000, 200000), (1, 1)])
def test_cuda_one_pair_launch_equals_unbatched(Q, T):
    """A (1, Q, 3) launch is the unbatched launch: the same slices and
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, qn, r, rn = _inputs(Q, T)
    assert nn.reference_slices(Q, T, pairs=1) == nn.reference_slices(Q, T)
    d, i = nn.nearest_neighbor(q, r)
    db, ib = nn.nearest_neighbor(q[None], r[None])
    assert torch.equal(db[0], d) and torch.equal(ib[0], i)
    o = nn.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    ob = nn.oriented_min_dist_sq(q[None], qn[None], r[None], rn[None], 0.5)
    assert torch.equal(ob[0], o)


@pytest.mark.cuda
def test_cuda_pairs_fill_the_card_before_the_references_split():
    """Slices are counted over the blocks of all pairs: 8 pairs of the
    final ICP's 16384 queries need fewer reference slices than one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    one = nn.reference_slices(16384, 16384)
    eight = nn.reference_slices(16384, 16384, pairs=8)
    assert one > 1 and eight < one


@pytest.mark.cuda
def test_cuda_index_sum_is_reproducible():
    """``ops.index_sum`` on the card: the same bits on every run (the
    voxel grids' shape: 8 x 131072 points into 8 x 16385 cells), and the
    float64 sums within float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 8 * 16385, (8 * 131072,), generator=g).cuda()
    vals = torch.randn(8 * 131072, 3, generator=g).cuda()
    runs = [ops.index_sum(torch.zeros(8 * 16385, 3, device="cuda"), idx,
                          vals) for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    want = torch.zeros(8 * 16385, 3, dtype=torch.float64).index_add_(
        0, idx.cpu(), vals.cpu().double())
    np.testing.assert_allclose(runs[0].cpu().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
