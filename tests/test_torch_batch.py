"""Pairs registered in lockstep on one device (the reference's ``jax.vmap``
of its device step): the port's batched step against its own single-pair
step and against the reference, on the CPU.

(a) ``dist.mesh.register_batch`` at B = 3 on pairs that finish apart (the
    room of ``test_torch_device_step``, a scan pair and a plane-less blob
    whose extraction ends in its first round): each pair's result equals
    its own single-step call: success, matched planes, the three counters
    and the per-cloud ``ExtractStats`` exactly, the transform within 1e-5
    (measured: 0, the same bits).
(b) The reference's ``jax.vmap`` of ``build_register_device_fn`` at B = 2
    on the draws replayed through ``draws=`` (one key chain per cloud):
    transforms within 0.1 deg and 1e-3, score and overlap within 1e-3,
    success, matched planes, counters and stats equal (the tolerances of
    ``test_device_step_matches_reference``).
(c) The host loops run to the slowest pair with the finished pairs frozen:
    ``overlap_scores``, ``cluster_poses`` and ``run_tests`` on pairs that
    need different numbers of chunks, sweeps and chunks, each pair bit for
    bit its own single call.
(d) The batched plain K1/K2 equal per-pair plain calls bit for bit, and
    the reference's Pallas kernels under ``jax.vmap`` (interpret mode)
    within the 1e-6 relative of ``test_torch_kernels`` (argmin equal).
(e) ``register_array_pairs`` on 5 pairs with ``batch_pairs=2`` (batches of
    2, 2 and 1) equals ``batch_pairs=1``.

CPU tensors never count a kernel launch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu import pipeline as jpipeline
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.kernels import nn as jnn
from plade_tpu_torch import pipeline
from plade_tpu_torch.core.convert import config_from
from plade_tpu_torch.core.types import Cloud, pad_cloud
from plade_tpu_torch.dist import mesh
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.io.synthetic import make_room, make_scan_sequence
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.match import matching
from plade_tpu_torch.verify import overlap, penetration
from test_pipeline import SMALL_CFG
from test_torch_device import _blob
from test_torch_device_step import _room_pair, _rot_deg
from test_torch_extract import _replayed_draws
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

#: ``SMALL_CFG`` with a 2-mode rescore (the rescore's ICP over the padded
#: rows of every mode is most of a CPU registration)
JFAST = dataclasses.replace(SMALL_CFG, rescore_top_k=2)
FAST = config_from(JFAST)
PAD = 8192


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _scan_pair():
    scans, _ = make_scan_sequence(
        np.random.default_rng(1001), n_scans=2, n_points=7000, n_rooms=2,
        n_per_plane=1500, noise=0.01, size=4.0, extra_planes=2,
        max_angle=1.0, max_trans=0.6)
    return (*scans[0], *scans[1])


def _pairs():
    """(room, scan, blob) as (tgt points, normals, src points, normals)."""
    bp, bn = _blob(150)
    return [_room_pair()[:4], _scan_pair(), (bp, bn, bp + 0.1, bn)]


def _stack(pairs, side):
    clouds = [pad_cloud(p[2 * side], p[2 * side + 1], PAD, "cpu")
              for p in pairs]
    return mesh.stack_clouds(clouds)


@pytest.fixture
def recorded_stats(monkeypatch):
    """The ``ExtractStats`` of every extraction the step runs."""
    seen = []
    real = ransac._cached_extractor

    def cached(cfg, num_points):
        fn = real(cfg, num_points)

        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out[1])
            return out
        return run
    monkeypatch.setattr(ransac, "_cached_extractor", cached)
    return seen


# ------------------------------------------------------------------ (a)

def test_register_batch_equals_single_steps(recorded_stats):
    pairs = _pairs()
    for p in pairs:
        assert max(p[0].shape[0], p[2].shape[0]) <= PAD
    seeds = [0, 1, 2]
    res = mesh.register_batch(_stack(pairs, 0), _stack(pairs, 1), seeds,
                              FAST, device="cpu")
    (bstats,) = recorded_stats
    step = pipeline.build_register_device_fn(FAST, PAD, with_stats=True,
                                             device="cpu")
    rounds, worst = [], 0.0
    for b, (p, seed) in enumerate(zip(pairs, seeds)):
        one, stats = step(pad_cloud(p[0], p[1], PAD, "cpu"),
                          pad_cloud(p[2], p[3], PAD, "cpu"), seed)
        worst = max(worst, float(np.abs(res.transform[b].numpy()
                                        - one.transform.numpy()).max()))
        for f in ("success", "matched_planes", "match_saturated",
                  "pen_overflow", "cluster_truncated"):
            assert int(getattr(res, f)[b]) == int(getattr(one, f)), (b, f)
        for f in range(4):
            # (2B,) in the extractor's order: the B targets, the B sources
            np.testing.assert_array_equal(
                bstats[f][[b, 3 + b]].numpy(), stats[f].numpy())
        rounds.append(stats.rounds.tolist())
    assert worst <= 1e-5, worst
    # the pairs finish apart: the blob's extraction ends in its first round
    assert rounds[2] == [1, 1] and len({tuple(r) for r in rounds}) == 3
    assert bool(res.success[0]) and not bool(res.success[2])


# ------------------------------------------------------------------ (b)

def test_batched_step_matches_vmapped_reference():
    pairs = _pairs()[:2]
    keys = jax.random.split(jax.random.PRNGKey(3))
    jt, js = ([jpad_cloud(p[2 * s], p[2 * s + 1], PAD) for p in pairs]
              for s in (0, 1))
    jres, jstats = jax.jit(jax.vmap(jpipeline.build_register_device_fn(
        JFAST, PAD, with_stats=True)))(
        jax.tree.map(lambda *x: jnp.stack(x), *jt),
        jax.tree.map(lambda *x: jnp.stack(x), *js), keys)
    step = pipeline.build_register_device_fn(FAST, PAD, with_stats=True,
                                             device="cpu")
    draws = [_replayed_draws(k, PAD, FAST) for key in keys
             for k in jax.random.split(key)]
    res, stats = step(_stack(pairs, 0), _stack(pairs, 1), [0, 0],
                      draws=draws)
    assert stats.rounds.shape == (2, 2)
    for b in range(2):
        T, want = res.transform[b].numpy(), np.asarray(jres.transform[b])
        assert bool(res.success[b]) == bool(jres.success[b])
        assert _rot_deg(T[:3, :3], want[:3, :3]) < 0.1
        assert np.linalg.norm(T[:3, 3] - want[:3, 3]) < 1e-3
        for f in ("score", "overlap"):
            assert abs(float(getattr(res, f)[b])
                       - float(getattr(jres, f)[b])) < 1e-3
        for f in ("matched_planes", "match_saturated", "pen_overflow",
                  "cluster_truncated"):
            assert int(getattr(res, f)[b]) == int(getattr(jres, f)[b]), f
    for f in ("rounds", "trials", "min_support"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(jstats, f)))
    np.testing.assert_allclose(stats.drawn.numpy(), np.asarray(jstats.drawn),
                               rtol=1e-4)
    assert bool(res.success[0])


# ------------------------------------------------------------------ (c)

def _stack_args(args):
    return [torch.stack(x) if torch.is_tensor(x[0]) else
            type(x[0])(*(torch.stack(f) for f in zip(*x)))
            for x in zip(*args)]


def _same(batched, singles):
    for b, one in enumerate(singles):
        for x, y in zip(batched, one):
            assert torch.equal(x[b], y), b


def _rot(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * K
            + (1 - np.cos(angle)) * K @ K).astype(np.float32)


def _overlap_pair(rng, identity_first):
    """24 candidates on a 400-point cloud against itself: either identity
    first (its exact overlap beats every bound: one chunk), or small
    shifts whose bounds stay above their exact overlaps (more chunks)."""
    pts = rng.uniform(0, 2, size=(400, 3)).astype(np.float32)
    nrm = rng.normal(size=(400, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    R = np.stack([_rot(rng, rng.uniform(0, 0.05)) for _ in range(24)])
    t = rng.normal(scale=0.05, size=(24, 3)).astype(np.float32)
    if identity_first:
        R[0], t[0] = np.eye(3), 0.0
        R[1:] = np.stack([_rot(rng, 0.8) for _ in range(23)])
    valid = np.ones(24, bool)
    valid[-3:] = False
    pf = rng.uniform(0, 1, size=24).astype(np.float32)
    c = torch.tensor(400, dtype=torch.int32)
    return [torch.from_numpy(R), torch.from_numpy(t),
            torch.from_numpy(valid), torch.from_numpy(pts), c,
            torch.from_numpy(pts.copy()), c, torch.tensor(0.02),
            torch.from_numpy(pf), torch.from_numpy(nrm),
            torch.from_numpy(nrm.copy())]


def test_overlap_bound_loop_freezes_finished_pairs(monkeypatch):
    rng = np.random.default_rng(0)
    args = [_overlap_pair(rng, True), _overlap_pair(rng, False)]
    chunks = []
    real = overlap.exact_overlap_counts

    def counted(*a, **k):
        chunks[-1] += 1
        return real(*a, **k)
    monkeypatch.setattr(overlap, "exact_overlap_counts", counted)

    def run(R, t, v, sp, sc, tp, tc, r, pf, sn, tn):
        chunks.append(0)
        return overlap.overlap_scores(R, t, v, sp, sc, tp, tc, r,
                                      plane_frac=pf, exact_k=4, grid=64,
                                      src_normals=sn, tgt_normals=tn,
                                      normal_cos=0.5)
    singles = [run(*a) for a in args]
    assert chunks[0] == 1 and chunks[1] > 1, chunks
    batched = run(*_stack_args(args))
    assert chunks[2] == chunks[1]
    _same(batched, singles)


def _chain(rng, n, H, spacing):
    """Hypotheses 0..n-1 on a chain of translations ``spacing`` apart, in
    a scrambled index order (many sweeps), the rest far apart."""
    t = rng.uniform(50, 100, size=(H, 3)) * rng.choice([-1, 1], size=(H, 3))
    t[rng.permutation(n)] = np.arange(n)[:, None] * [spacing, 0, 0]
    t = t.astype(np.float32)
    R = np.stack([_rot(rng, 0.001) for _ in range(H)])
    valid = np.ones(H, bool)
    valid[-5:] = False
    return [torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(valid)]


def test_cluster_sweeps_freeze_converged_pairs(monkeypatch):
    rng = np.random.default_rng(1)
    H = 96
    args = [_chain(rng, 4, H, 0.05), _chain(rng, 80, H, 0.05)]
    sweeps = []
    real = matching.host_value

    def counted(x):
        sweeps[-1] += 1
        return real(x)
    monkeypatch.setattr(matching, "host_value", counted)

    def run(R, t, v):
        sweeps.append(0)
        return matching.cluster_poses(R, t, v, 0.1, 0.05, 16)
    singles = [run(*a) for a in args]
    assert sweeps[0] < sweeps[1], sweeps
    batched = run(*_stack_args(args))
    assert sweeps[2] == sweeps[1]
    _same(batched, singles)
    assert int(singles[1].size[0]) == 80


def _pen_pair(rng, live):
    """Penetration tests between a source plane z = 0 (rotated by each
    test's candidate) and a target plane x = 0, both 2 x 2 with 64 points:
    the first ``live`` of 40 tests valid; the candidates are the identity
    (the planes cross: penetrable) or rotations of 1.2 rad."""
    g = np.linspace(-1, 1, 8, dtype=np.float32)
    a, b = np.meshgrid(g, g)
    src = np.stack([a.ravel(), b.ravel(), np.zeros(64, np.float32)], -1)
    tgt = np.stack([np.zeros(64, np.float32), a.ravel(), b.ravel()], -1)
    Pp, M, K, C = 3, 64, 40, 6
    src_pts = np.repeat(src[None], Pp, 0)
    tgt_pts = np.repeat(tgt[None], Pp, 0)
    counts = np.array([64, 20, 64], np.int32)
    R = np.stack([np.eye(3, dtype=np.float32) if c % 2 == 0
                  else _rot(rng, 1.2) for c in range(C)])
    t = np.zeros((C, 3), np.float32)
    tests = penetration.PenTests(
        cand=torch.from_numpy(rng.integers(0, C, K).astype(np.int32)),
        src=torch.from_numpy(rng.integers(0, Pp, K).astype(np.int32)),
        tgt=torch.from_numpy(rng.integers(0, Pp, K).astype(np.int32)),
        start=torch.tensor([[0.0, -1.0, 0.0]]).repeat(K, 1),
        direc=torch.tensor([[0.0, 1.0, 0.0]]).repeat(K, 1),
        length=torch.full((K,), 2.0),
        valid=torch.arange(K) < live,
        overflow=torch.tensor(0, dtype=torch.int32))
    coeffs_s = torch.tensor([[0.0, 0.0, 1.0, 0.0]]).repeat(Pp, 1)
    coeffs_t = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(Pp, 1)
    return [tests, torch.from_numpy(R), torch.from_numpy(t),
            torch.from_numpy(src_pts), torch.from_numpy(counts),
            torch.from_numpy(tgt_pts), torch.from_numpy(counts.copy()),
            coeffs_s, coeffs_t]


def test_penetration_chunks_run_to_the_slowest_pair():
    rng = np.random.default_rng(2)
    args = [_pen_pair(rng, 3), _pen_pair(rng, 37)]

    def run(*a):
        return (penetration.run_tests(*a, search_radius=0.3, min_points=3,
                                      min_distance=0.05, n_samples=16,
                                      chunk=8, small_points=32),)
    singles = [run(*a) for a in args]
    assert singles[1][0].any() and not singles[1][0][:37].all()
    batched = run(*_stack_args(args))
    _same(batched, singles)


def test_penetration_plain_walk_counts_its_chunks():
    """CPU tensors take the plain walk: ``penetration.plain_chunks``
    counts the chunks it runs (the most selected tests of a pair, a tier),
    ``penetration.kernel_walks`` stays 0 and no kernel launch is
    counted."""
    from plade_tpu_torch.utils import timing
    rng = np.random.default_rng(2)
    args = _stack_args([_pen_pair(rng, 3), _pen_pair(rng, 37)])
    tests = args[0]
    counts = args[4]
    small = (torch.gather(counts, 1, tests.src.long()) <= 32) \
        & (torch.gather(counts, 1, tests.tgt.long()) <= 32)
    v = tests.valid
    want = sum(-(-int(torch.sum(v & tier, dim=1).max()) // 8)
               for tier in (small, ~small))
    before = dict(nn.LAUNCHES)
    with timing.call("unit", 2):
        penetration.run_tests(*args, search_radius=0.3, min_points=3,
                              min_distance=0.05, n_samples=16, chunk=8,
                              small_points=32)
    rec = timing.calls()[-1]["counters"]
    assert want > 2 and rec["penetration.plain_chunks"] == want
    assert "penetration.kernel_walks" not in rec
    assert nn.LAUNCHES == before


def test_penetration_counts_give_the_verdicts():
    """The plain walk's four counts a test (0 for invalid tests) give its
    verdicts; they do not depend on the tier split."""
    rng = np.random.default_rng(3)
    args = _stack_args([_pen_pair(rng, 3), _pen_pair(rng, 37)])
    kw = dict(search_radius=0.3, min_distance=0.05, n_samples=16, chunk=8)
    counts = penetration.plain_counts(*args, small_points=32, **kw)
    assert counts.shape == (2, 40, 4) and counts.dtype == torch.int32
    assert torch.equal(counts, penetration.plain_counts(
        *args, small_points=1 << 20, **kw))
    assert (counts[~args[0].valid] == 0).all()
    assert (counts[args[0].valid] > 0).any()
    got = penetration.run_tests(*args, min_points=3, small_points=32, **kw)
    assert torch.equal(got, penetration.verdicts(counts, args[0].valid, 3,
                                                 5.0))


def test_penetration_walk_rejects_cpu_tensors():
    """K5 takes CUDA tensors only, as K4 does: CPU tensors raise."""
    from plade_tpu_torch.kernels import penetration as walk
    rng = np.random.default_rng(4)
    tests, R, t, spts, scnt, tpts, tcnt, sco, tco = _stack_args(
        [_pen_pair(rng, 3), _pen_pair(rng, 5)])
    r = torch.full((2,), 0.3)
    with pytest.raises(ValueError, match="CUDA device"):
        walk.penetration_walk(tests, R, t, spts, scnt, tpts, tcnt, sco, tco,
                              r, r / 2, 3, 5.0, 16)


# ------------------------------------------------------------------ (d)

def _kernel_inputs(rng, P, Q, T):
    q = rng.normal(size=(P, Q, 3)).astype(np.float32)
    r = rng.normal(size=(P, T, 3)).astype(np.float32)
    r[:, 40:50] = r[:, 7:8]                  # ties within each pair
    q[:, :5] = r[:, 7:8]
    qn = rng.normal(size=(P, Q, 3))
    rn = rng.normal(size=(P, T, 3))
    rn[..., 2] = np.abs(rn[..., 2]) + 0.5
    qn[:, 3] = [0.0, 0.0, -1.0]
    unit = [(v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
            for v in (qn, rn)]
    return q, unit[0], r, unit[1]


def test_batched_plain_kernels_equal_per_pair_and_vmapped_pallas():
    rng = np.random.default_rng(3)
    q, qn, r, rn = _kernel_inputs(rng, 3, 301, 1234)
    tq, tqn, tr, trn = (torch.from_numpy(x) for x in (q, qn, r, rn))
    d, i = nn.nearest_neighbor(tq, tr)
    o = nn.oriented_min_dist_sq(tq, tqn, tr, trn, 0.7)
    assert d.shape == i.shape == o.shape == (3, 301)
    for p in range(3):
        d1, i1 = nn.nearest_neighbor_plain(tq[p], tr[p])
        assert torch.equal(d[p], d1) and torch.equal(i[p], i1)
        assert torch.equal(o[p], nn.oriented_min_dist_sq_plain(
            tq[p], tqn[p], tr[p], trn[p], 0.7))
    assert (i[:, :5] == 7).all()
    jd, ji = jax.vmap(lambda a, b: jnn.nearest_neighbor(
        a, b, bq=128, bt=512, interpret=True))(jnp.asarray(q), jnp.asarray(r))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    jo = np.asarray(jax.vmap(lambda a, an, b, bn: jnn.oriented_min_dist_sq(
        a, an, b, bn, 0.7, bq=64, bt=512, interpret=True))(
        *(jnp.asarray(x) for x in (q, qn, r, rn))))
    np.testing.assert_array_equal(np.isfinite(o.numpy()), np.isfinite(jo))
    fin = np.isfinite(jo)
    np.testing.assert_allclose(o.numpy()[fin], jo[fin], rtol=1e-6, atol=0)
    assert np.isinf(o.numpy()[:, 3]).all()


# ------------------------------------------------------------------ (e)

def test_register_array_pairs_in_batches_equals_one_at_a_time():
    # budgets cut to these scenes (the default 8192-hypothesis clustering
    # is most of a CPU step)
    cfg = dataclasses.replace(
        FAST, rescore_top_k=1, max_ds_points=1024, spacing_samples=500,
        max_plane_points=256, max_candidate_results=16, overlap_grid=64,
        max_matches=1024, max_cluster_hypotheses=1024, max_query_pairs=1024,
        max_target_pairs=2048, max_pose_clusters=128,
        max_penetration_tests=256)
    rng = np.random.default_rng(4)
    pairs = []
    for k in range(5):
        pts, nrm, _ = make_room(rng, n_per_plane=800, noise=0.003,
                                extra_planes=3)
        pairs.append((pts, nrm, pts + 0.02 * k, nrm))
    batched = mesh.register_array_pairs(pairs, cfg, seed=5, device="cpu",
                                        batch_pairs=2)
    single = mesh.register_array_pairs(pairs, cfg, seed=5, device="cpu",
                                       batch_pairs=1)
    assert len(batched) == len(single) == 5
    for a, b in zip(batched, single):
        np.testing.assert_array_equal(a.transform, b.transform)
        assert a._replace(transform=None) == b._replace(transform=None)
    assert all(o.success for o in batched)
    with pytest.raises(ValueError):
        mesh.register_array_pairs(pairs, cfg, device="cpu", batch_pairs=0)


def test_step_rejects_mismatched_seeds():
    step = pipeline.build_register_device_fn(FAST, 4096, device="cpu")
    c = Cloud(torch.zeros(2, 4096, 3), torch.zeros(2, 4096, 3),
              torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="2 pairs, 1 seeds"):
        step(c, c, [0])
