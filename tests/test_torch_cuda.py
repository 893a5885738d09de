"""K1, K2, K3, K4 and K5 on a card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors; and extraction's passes replayed
from a CUDA graph against its eager loop on the same generators.  These tests
import no JAX, so that they also run on a machine that has a GPU and no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card they skip.  Every result must equal the plain version's bit
for bit: the kernels and the plain versions compute d2 (and K1's normal
dot) with the same operations in the same order (``csrc/nn.cu`` is built
without fused multiply-add), K2's argmin takes the lowest index among ties
also across the reference slices its atomic merge joins, and K3 is
integer-only, also on a serpentine grid that 256 rounds leave unconverged
(the kernel's early stop against the plain version's full count), and K4
(the spacing's top-k) takes the plain version's |q|^2 and |r|^2 and
rounds its q.r as the plain version's cuBLAS product does, and K5 (the
penetration walk) rounds every value that feeds a comparison as the plain
walk does."""
import numpy as np
import pytest
import torch

import cc_grids
from penetration_pools import pool_walk
from spacing_clouds import BENCH_CLOUDS, spacing_inputs
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


#: K4's main-path shapes (``spacing_clouds.BENCH_CLOUDS``) and a cloud with
#: fewer live rows than k beside a full one (the padding enters its lists)
SPACING_CLOUDS = [*BENCH_CLOUDS, (2, 1000, (3, 1000))]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 16])
@pytest.mark.parametrize("P,N,live", SPACING_CLOUDS)
def test_cuda_topk_matches_plain(P, N, live, k):
    """K4 on the spacing's own queries and clouds: bit for bit the plain
    version (the blocked cuBLAS product and ``torch.topk``), one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.knn.bruteforce import topk_dist_sq_plain
    pts, _, q = spacing_inputs(P, N, live)
    before = nn.LAUNCHES["topk_dist_sq"]
    got = nn.topk_dist_sq(q, pts, k)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["topk_dist_sq"] == before + 1
    assert got.shape == (P, q.shape[-2], k)
    assert torch.equal(got, topk_dist_sq_plain(q, pts, k))
    if live[0] < k:                               # the padding enters
        assert (got[0, :, live[0]:] > 1e15).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 9, 16])
@pytest.mark.parametrize("P,Q,T", [
    (None, 1001, 777),    # no cloud axis
    (1, 1001, 777), (8, 333, 5000),
    (3, 4097, 20000),     # ragged against the block's queries and the tile
    (2, 1, 16384), (1, 2500, 16),
    (1, 64, 100000),      # few queries, many references: the finest split
])
def test_cuda_topk_ragged_matches_plain(P, Q, T, k):
    """K4 at shapes that are no multiple of its block or tile, with ties
    and BIG-padded rows: bit for bit the plain version, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.knn.bruteforce import topk_dist_sq_plain
    q, _, r, _ = _pair_inputs(P or 1, Q, T)
    if P is None:
        q, r = q[0], r[0]
    before = nn.LAUNCHES["topk_dist_sq"]
    got = nn.topk_dist_sq(q, r, k)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["topk_dist_sq"] == before + 1
    assert torch.equal(got, topk_dist_sq_plain(q, r, k))


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,live", BENCH_CLOUDS)
def test_cuda_average_spacing_through_k4_equals_plain(P, N, live):
    """``average_spacing`` on a card (K4) is the plain top-k's spacing,
    bit for bit, one K4 launch a call; a top-k above K4's bound raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.knn import bruteforce
    pts, mask, q = spacing_inputs(P, N, live)
    before = nn.LAUNCHES["topk_dist_sq"]
    got = bruteforce.average_spacing(pts, mask, 6, 10000)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["topk_dist_sq"] == before + 1
    want = bruteforce.average_spacing(
        pts, mask, 6, 10000, bruteforce.ONE_DEVICE._replace(
            topk_dist_sq=bruteforce.topk_dist_sq_plain))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match=str(nn.TOPK_MAX_K)):
        bruteforce.topk_dist_sq(q, pts, nn.TOPK_MAX_K + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("P,Q,T", [(1, 131071, 16383), (3, 4097, 20000),
                                   (2, 1, 16384)])
def test_cuda_split_queries_equal_one_launch(k, P, Q, T):
    """K1, K2 and the spacing's top-k split over a group of ``k`` parts on
    one card (``dist/intra.split_queries``, each part on a stream of its
    own): bit for bit one launch, every non-empty part one launch (the
    top-k's parts cut at its plain version's block boundaries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.dist import intra
    from plade_tpu_torch.dist.intra import query_cuts, split_queries
    from plade_tpu_torch.knn.bruteforce import topk_block, topk_dist_sq
    q, qn, r, rn = _pair_inputs(P, Q, T)
    group = ["cuda:0"] * k
    d, i = nn.nearest_neighbor(q, r)
    o = nn.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    s = topk_dist_sq(q, r, 6)
    cuts = query_cuts(Q, k)
    parts = sum(hi > lo for lo, hi in zip(cuts, cuts[1:]))
    cuts = query_cuts(Q, k, topk_block(q, r))
    topk_parts = sum(hi > lo for lo, hi in zip(cuts, cuts[1:]))
    before = dict(nn.LAUNCHES)
    ds, is_ = split_queries(nn.nearest_neighbor, group, [q], [r])
    os_ = split_queries(lambda *a: nn.oriented_min_dist_sq(*a, 0.5), group,
                        [q, qn], [r, rn])
    ss = intra.on_group(group).topk_dist_sq(q, r, 6)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["nearest_neighbor"] \
        == before["nearest_neighbor"] + parts
    assert nn.LAUNCHES["oriented_min_dist_sq"] \
        == before["oriented_min_dist_sq"] + parts
    assert nn.LAUNCHES["topk_dist_sq"] == before["topk_dist_sq"] + topk_parts
    assert torch.equal(ds, d) and torch.equal(is_, i)
    assert torch.equal(os_, o)
    assert torch.equal(ss, s)
    # the helper streams are drawn once and reused
    streams = dict(intra._STREAMS)
    again = split_queries(nn.nearest_neighbor, group, [q], [r])
    torch.cuda.synchronize()
    assert intra._STREAMS == streams
    assert torch.equal(again[0], d) and torch.equal(again[1], i)


@pytest.mark.cuda
def test_cuda_split_queries_over_two_cards():
    """K1, K2 and the spacing's top-k split over two distinct cards (the
    parts copied card to card): bit for bit one launch on cuda:0, one
    launch a card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from plade_tpu_torch.dist.intra import on_group
    from plade_tpu_torch.knn.bruteforce import topk_dist_sq
    q, qn, r, rn = _pair_inputs(2, 40961, 16384)
    d, i = nn.nearest_neighbor(q, r)
    o = nn.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    s = topk_dist_sq(q, r, 6)
    passes = on_group(["cuda:0", "cuda:1"])
    before = dict(nn.LAUNCHES)
    ds, is_ = passes.nearest_neighbor(q, r)
    os_ = passes.oriented_min_dist_sq(q, qn, r, rn, 0.5)
    ss = passes.topk_dist_sq(q, r, 6)
    torch.cuda.synchronize("cuda:0")
    torch.cuda.synchronize("cuda:1")
    assert nn.LAUNCHES["nearest_neighbor"] == before["nearest_neighbor"] + 2
    assert nn.LAUNCHES["oriented_min_dist_sq"] \
        == before["oriented_min_dist_sq"] + 2
    assert nn.LAUNCHES["topk_dist_sq"] == before["topk_dist_sq"] + 2
    assert ds.device == q.device and ss.device == q.device
    assert torch.equal(ds, d) and torch.equal(is_, i)
    assert torch.equal(os_, o) and torch.equal(ss, s)


# ------------------------------------------- extraction's pass graph


def _scans(n_scans):
    """Consecutive scans of ``resso60k``'s first scene (``office_clean``:
    at most 60000 points each)."""
    from plade_tpu_torch.io.synthetic import make_scan_sequence
    scans, _ = make_scan_sequence(
        np.random.default_rng(1), n_scans=n_scans, n_points=60000,
        overlap_radius=3.4, step=2.0, n_rooms=3, n_per_plane=9000,
        noise=0.02, size=4.0, extra_planes=3, normal_noise_deg=3.0,
        max_angle=1.0, max_trans=0.6)
    return scans


def _stacked(clouds, pad=65536):
    from plade_tpu_torch.core.types import pad_cloud
    from plade_tpu_torch.dist.mesh import stack_clouds
    return stack_clouds([pad_cloud(p, n, pad, "cuda") for p, n in clouds])


def _extract(fn, batch, floor, init=None, seed=0):
    """One call of the extractor ``fn`` on the clouds ``batch`` (cloud c's
    generator seeded with ``seed + c``): (planes, stats, K3 launches,
    the call's counters)."""
    from plade_tpu_torch.utils import timing
    B = batch.points.shape[0]
    gens = [torch.Generator(device="cuda").manual_seed(seed + c)
            for c in range(B)]
    before = cc.LAUNCHES["close_and_label_lanes"]
    with timing.call("test.extract", B):
        planes, stats = fn(batch.points, batch.normals, batch.count, floor,
                           generator=gens, init_support=init)
    torch.cuda.synchronize()
    return (planes, stats, cc.LAUNCHES["close_and_label_lanes"] - before,
            timing.calls()[-1]["counters"])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_cloud", "four_clouds", "pinned"])
def test_cuda_pass_graph_equals_the_eager_loop(case, monkeypatch):
    """The extractor's passes replayed from a CUDA graph against the eager
    loop on the same generators, bit for bit: planes and stats, K3
    launches, passes.  A fresh extractor's first call runs its first pass
    eagerly and captures; its second call replays every pass.  One cloud
    of 65536 rows at the floor support; four in lockstep (two scans and
    two cuts of them to 20000 and 8000 points, which finish rounds
    earlier); one cloud at a pinned support (floor and start)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.extract import ransac
    cfg = PladeConfig()
    scans = _scans(2)
    floor, init = cfg.ransac_min_allowed_support, None
    if case == "four_clouds":
        (p0, n0), (p1, n1) = scans
        batch = _stacked([(p0, n0), (p1, n1), (p0[:20000], n0[:20000]),
                          (p1[:8000], n1[:8000])])
    else:
        batch = _stacked(scans[:1])
        if case == "pinned":
            floor = init = 1000
    graph_fn = ransac.build_extract_fn(cfg, 65536, 64)
    first = _extract(graph_fn, batch, floor, init)
    second = _extract(graph_fn, batch, floor, init)
    with monkeypatch.context() as m:
        m.setattr(ransac, "_use_graph", lambda points: False)
        eager = _extract(ransac.build_extract_fn(cfg, 65536, 64), batch,
                         floor, init)
    rounds = eager[3]["extract.rounds"]
    if case == "four_clouds":
        assert len(set(eager[1].rounds.tolist())) > 1, eager[1].rounds
    for got in (first, second):
        assert _same(got[0], eager[0]) and _same(got[1], eager[1])
        assert got[2] == eager[2] == rounds        # K3 once a pass
        assert got[3]["extract.rounds"] == rounds
        assert got[3]["extract.frozen"] == eager[3]["extract.frozen"]
    assert first[3]["extract.graph_captures"] == 1
    assert first[3]["extract.graph_rounds"] == rounds - 1
    assert second[3]["extract.graph_captures"] == 0
    assert second[3]["extract.graph_rounds"] == rounds
    assert eager[3]["extract.graph_rounds"] == 0
    assert eager[3]["extract.graph_captures"] == 0


@pytest.mark.cuda
def test_cuda_pass_graph_results_outlive_the_next_call(monkeypatch):
    """The two clouds of a pair extracted one after the other through the
    pipeline's cached extractor, as ``register_clouds`` does (one graph:
    both clouds are 65536 rows): the first call's planes and stats are not
    overwritten by the second call, both equal the eager loop's, and
    ``auto_extract`` selects from the same planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.extract import ransac
    cfg = PladeConfig()
    clouds = [_stacked([s]) for s in _scans(2)]
    floor = cfg.ransac_min_allowed_support

    def both():
        out = []
        for k, c in enumerate(clouds):
            gen = torch.Generator(device="cuda").manual_seed(k)
            got = ransac._cached_extractor(cfg, 65536)(
                c.points[0], c.normals[0], c.count[0], floor, generator=gen)
            out.append((got, [[x.clone() for x in g] for g in got]))
        torch.cuda.synchronize()
        return out

    both()                                  # the first pass captures
    graph = both()
    with monkeypatch.context() as m:
        m.setattr(ransac, "_use_graph", lambda points: False)
        eager = both()
    for (got, snap), (want, _) in zip(graph, eager):
        for g, s, w in zip(got, snap, want):
            assert _same(g, s)              # unchanged by the later call
            assert _same(g, w)
    for k, (c, ((planes, _), _)) in enumerate(zip(clouds, graph)):
        gen = torch.Generator(device="cuda").manual_seed(k)
        sel = ransac.auto_extract(c.points[0], c.normals[0], c.count[0], cfg,
                                  65536, generator=gen)
        assert _same(sel, ransac.select_planes_device(planes, cfg))


@pytest.mark.cuda
def test_cuda_pass_graphs_are_one_a_stream():
    """Each stream keeps one pass graph: a call on a stream of its own (a
    mesh shard's) keeps its graph beside the default stream's, which then
    replays; another extractor's call on the default stream takes the
    graph's place and captures, and the first extractor captures again
    after it.  Every call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.extract import ransac
    cfg = PladeConfig()
    batch = _stacked(_scans(1))
    floor = cfg.ransac_min_allowed_support
    fn_a, fn_b = (ransac.build_extract_fn(cfg, 65536, 64) for _ in range(2))
    side = torch.cuda.Stream()
    home = torch.cuda.current_stream()
    captures = []

    def call(fn, stream):
        with torch.cuda.stream(stream):
            got = _extract(fn, batch, floor)
        captures.append(got[3]["extract.graph_captures"])
        return got

    want = call(fn_a, home)
    for fn, stream in ((fn_b, side), (fn_a, home), (fn_b, home),
                       (fn_a, home)):
        got = call(fn, stream)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert captures == [1, 1, 0, 1, 1]
    assert ransac._GRAPHS[side][0][0] is not ransac._GRAPHS[home][0][0]


# ------------------------------------------------------------------ K5

def _pool_walks(config, B):
    """The ``run_tests`` call of one lockstep registration of the first
    ``B`` pool pairs of regbench's configuration ``config`` on the card, at
    its ``PladeConfig`` (``penetration_pools.pool_walk``): (args, keywords),
    CUDA tensors.  That run made one call and one K5 launch."""
    seen, launches = pool_walk(config, B)
    assert len(seen) == 1 and launches == 1
    return seen[0][:2]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["resso60k", "tls131k"])
@pytest.mark.parametrize("B", [1, 8])
def test_cuda_penetration_walk_matches_plain_on_pool_pairs(config, B):
    """K5 on the tests of real registrations at the benchmark's
    configurations: one launch a call and no host read; its verdicts and
    its four counts a test bit for bit the plain two-tier walk's on the
    same CUDA tensors, over tests of both tiers and invalid ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.core.types import HOST_SYNCS
    from plade_tpu_torch.kernels import penetration as walk
    from plade_tpu_torch.verify import penetration
    args, kw = _pool_walks(config, B)
    tests, R, t, spts, scnt, tpts, tcnt, scoef, tcoef = args
    torch.cuda.synchronize()
    launches, syncs = nn.LAUNCHES["penetration_walk"], HOST_SYNCS["count"]
    got = penetration.run_tests(*args, **kw)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["penetration_walk"] == launches + 1
    assert HOST_SYNCS["count"] == syncs
    want = penetration.run_tests_plain(*args, **kw)
    assert torch.equal(got, want)
    # the four counts of every test, every side walked
    plain = penetration.plain_counts(
        tests, R, t, spts, scnt, tpts, tcnt, scoef, tcoef,
        kw["search_radius"], kw["min_distance"], kw["n_samples"])
    radius = ops.per_pair(kw["search_radius"], B, "cuda")
    min_d = ops.per_pair(kw["min_distance"], B, "cuda")
    verdict, counts = walk.penetration_walk_counts(
        tests, R, t, spts, scnt, tpts, tcnt, scoef, tcoef, radius, min_d,
        kw["min_points"], kw["max_ratio"], kw["n_samples"])
    assert torch.equal(verdict, got) and torch.equal(counts, plain)
    # what the tests covered: both tiers, invalid tests, counts on both
    # sides, and (at B = 8) some penetrable tests
    n1 = torch.gather(scnt, 1, tests.src.long())
    n2 = torch.gather(tcnt, 1, tests.tgt.long())
    small = (n1 <= 512) & (n2 <= 512)
    v = tests.valid
    print(f"{config} B={B}: valid {int(v.sum())} of {v.numel()}, small "
          f"tier {int((v & small).sum())}, largest plane "
          f"{int(torch.maximum(n1, n2)[v].max())}, penetrable "
          f"{int(got.sum())}, counts > 0 {int((counts > 0).sum())}")
    assert (v & small).any() and (v & ~small).any() and (~v).any()
    assert (counts[..., :2] > 0).any() and (counts[..., 2:] > 0).any()
    if B == 8:
        assert got.any()


def _crossing_case(rng, sizes, C=6, B=2, max_tests=64):
    """B pairs of two source planes z = 0 and z = 5 and two target planes
    x = 0 (around z = 0 and z = 5), uniform points in 2 x 2 squares, live
    counts ``sizes[b]`` = (source 0, source 1, target 0, target 1) in 2048
    rows (the rest BIG); C candidates: the identity and small rotations and
    shifts.  The tests come from ``build_tests`` on the card: (tests, the
    walk's arguments)."""
    from plade_tpu_torch.verify import penetration
    ex, ey, ez = np.eye(3, dtype=np.float32)

    def cloud(n, u, v, c):
        uv = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
        return (np.asarray(c, np.float32) + uv[:, :1] * u
                + uv[:, 1:] * v).astype(np.float32)

    def quad(c, u, v):
        c = np.asarray(c, np.float32)
        return np.stack([c - u - v, c + u - v, c + u + v, c - u + v])

    def rot(angle):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return (np.eye(3) + np.sin(angle) * K
                + (1 - np.cos(angle)) * K @ K).astype(np.float32)

    M = 2048
    sc = np.array([[0, 0, 1, 0], [0, 0, 1, -5.0]], np.float32)
    tc = np.array([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32)
    scorn = np.stack([quad([0, 0, 0], ex, ey), quad([0, 0, 5], ex, ey)])
    tcorn = np.stack([quad([0, 0, 0], ey, ez), quad([0, 0, 5], ey, ez)])
    per = []
    for b in range(B):
        n = sizes[b]
        pts = [cloud(n[0], ex, ey, [0, 0, 0]), cloud(n[1], ex, ey, [0, 0, 5]),
               cloud(n[2], ey, ez, [0, 0, 0]), cloud(n[3], ey, ez, [0, 0, 5])]
        pad = [np.pad(c, ((0, M - len(c)), (0, 0)), constant_values=1e8)
               for c in pts]
        R = np.stack([np.eye(3, dtype=np.float32)]
                     + [rot(rng.uniform(0.01, 0.3)) for _ in range(C - 1)])
        t = np.concatenate([np.zeros((1, 3), np.float32),
                            rng.uniform(-0.1, 0.1, (C - 1, 3))
                            .astype(np.float32)])
        per.append((R, t, np.ones(C, bool), sc, scorn, scorn.mean(1),
                    np.ones(2, bool), tc, tcorn, tcorn.mean(1),
                    np.ones(2, bool), np.stack(pad[:2]),
                    np.array(n[:2], np.int32), np.stack(pad[2:]),
                    np.array(n[2:], np.int32)))
    (R, t, cv, sco, scr, sce, sm, tco, tcr, tce, tm, spts, scnt, tpts,
     tcnt) = [torch.from_numpy(np.stack(x)).cuda() for x in zip(*per)]
    tests = penetration.build_tests(
        R, t, cv, sco, scr, sce, sm, tco, tcr, tce, tm,
        torch.full((B,), 0.1, device="cuda"), 5.0 / 180.0 * np.pi,
        max_tests=max_tests)
    return tests, (R, t, spts, scnt, tpts, tcnt, sco, tco)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 16, 45])
def test_cuda_penetration_walk_full_planes(S):
    """K5 against the plain walk on crossing planes of up to 2048 live
    points (the full padded rows), beside planes of 300 and 40, under
    candidates near the identity, with invalid tests past the live ones,
    at sample counts below, at and above a warp's 32: the same verdicts
    and counts, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.kernels import penetration as walk
    from plade_tpu_torch.verify import penetration
    rng = np.random.default_rng(S)
    tests, (R, t, spts, scnt, tpts, tcnt, sco, tco) = _crossing_case(
        rng, [(2048, 300, 2048, 1500), (40, 2048, 700, 2048)])
    r = torch.tensor([0.1, 0.12], device="cuda")
    md = r / 2.0
    kw = dict(search_radius=r, min_points=10, min_distance=md, n_samples=S)
    before = nn.LAUNCHES["penetration_walk"]
    got = penetration.run_tests(tests, R, t, spts, scnt, tpts, tcnt, sco,
                                tco, **kw)
    torch.cuda.synchronize()
    assert nn.LAUNCHES["penetration_walk"] == before + 1
    assert torch.equal(got, penetration.run_tests_plain(
        tests, R, t, spts, scnt, tpts, tcnt, sco, tco, **kw))
    verdict, counts = walk.penetration_walk_counts(
        tests, R, t, spts, scnt, tpts, tcnt, sco, tco, r, md, 10, 5.0, S)
    assert torch.equal(verdict, got)
    assert torch.equal(counts, penetration.plain_counts(
        tests, R, t, spts, scnt, tpts, tcnt, sco, tco, r, md, S))
    n1 = torch.gather(scnt, 1, tests.src.long())
    n2 = torch.gather(tcnt, 1, tests.tgt.long())
    v = tests.valid
    assert (v & (n1 == 2048) & (n2 == 2048)).any() and (~v).any()
    assert got.any() and not got[v].all()


@pytest.mark.cuda
def test_cuda_penetration_crossing_planes():
    """The reference's tier-parity case (one small and one big crossing
    plane pair, tests/test_torch_match_verify.py) through K5: the plain
    walk's verdicts at either tier split, and the candidate is rejected."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from plade_tpu_torch.verify import penetration
    rng = np.random.default_rng(0)
    tests, (R, t, spts, scnt, tpts, tcnt, sco, tco) = _crossing_case(
        rng, [(300, 1500, 300, 1500)], C=1, B=1, max_tests=16)
    tests = ops.drop(tests)
    args = (R[0], t[0], spts[0], scnt[0], tpts[0], tcnt[0], sco[0], tco[0])
    kw = dict(search_radius=torch.tensor(0.1, device="cuda"), min_points=10,
              min_distance=torch.tensor(0.05, device="cuda"), n_samples=32)
    got = penetration.run_tests(tests, *args, **kw)
    assert int(tests.valid.sum()) == 2 and bool(got.any())
    for small_points in (512, 2048):
        assert torch.equal(got, penetration.run_tests_plain(
            tests, *args, small_points=small_points, **kw))
    assert bool(penetration.rejected_candidates(tests, got, 1)[0])
