"""The ``intra`` axis: one pair's nearest-neighbour passes split over a
group of devices (``dist/intra.py``, ``dist/mesh.py``), on the CPU with
groups of ``["cpu"] * k``.

(a) ``query_cuts``: contiguous parts at multiples of the alignment that
    differ by at most one alignment, empty parts included.
(b) ``split_queries`` and the passes ``on_group`` binds against one call,
    bit for bit: the plain K1 and K2 (one pair and a pair axis, groups of
    2 and 3, a query count that leaves a part empty, which then runs
    nothing) and ``topk_dist_sq`` split at its block boundaries (every
    block the unsplit call's shape).
(c) ``register_batch`` on ``make_mesh(devices=["cpu"] * 2, intra=2)`` (one
    group) and ``["cpu"] * 4, intra=2`` (two groups): bit for bit the
    one-device call and the ``intra = 1`` mesh of two shards, with the
    same host syncs, and every K1/K2 call split in two.
(d) The port's ``intra = 2`` mesh against the JAX package's
    ``make_mesh(4, intra=2)`` on replayed draws: within 0.1 deg and 1e-3,
    the same success and counters.
(e) ``make_mesh`` and ``global_mesh`` validation: ``n % intra``, and a
    group that would span ranks.

CPU tensors never count a kernel launch."""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from plade_tpu.core.config import PladeConfig as JPladeConfig
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.dist import mesh as jmesh
from plade_tpu_torch.core import types as ptypes
from plade_tpu_torch.dist import intra as intra_mod
from plade_tpu_torch.dist import mesh, multihost
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.knn import bruteforce
from test_torch_device_step import _room_pair, _rot_deg
from test_torch_dist import WIDE
from test_torch_extract import _replayed_draws
from torch_multihost_worker import CFG, PAD, make_pairs, stacked
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

COS = 0.7071067811865476


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _inputs(lead, Q, T, seed=0):
    """Queries and references with unit normals, ``lead`` leading axes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (Q, Q, T, T):
        x = rng.normal(size=lead + (n, 3))
        out.append(x)
    out[1] /= np.linalg.norm(out[1], axis=-1, keepdims=True)
    out[3] /= np.linalg.norm(out[3], axis=-1, keepdims=True)
    return [torch.from_numpy(x.astype(np.float32)) for x in out]


def _same_bits(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("Q, parts, align", [
    (10, 2, 1), (7, 3, 1), (1, 2, 1), (2, 3, 1), (0, 3, 4),
    (1030, 2, 512), (10000, 2, 64), (10000, 3, 64), (1, 2, 512),
    (4096, 4, 512)])
def test_query_cuts(Q, parts, align):
    cuts = intra_mod.query_cuts(Q, parts, align)
    assert len(cuts) == parts + 1 and cuts[0] == 0 and cuts[-1] == Q
    sizes = [hi - lo for lo, hi in zip(cuts, cuts[1:])]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= align
    assert all(c % align == 0 for c in cuts[1:-1])


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("lead, Q, T", [((), 301, 257), ((3,), 130, 97),
                                        ((), 2, 50), ((2,), 1, 40)])
def test_split_kernels_equal_one_call(k, lead, Q, T):
    q, qn, r, rn = _inputs(lead, Q, T)
    group = ["cpu"] * k
    _same_bits(intra_mod.split_queries(nn.nearest_neighbor, group, [q], [r]),
               nn.nearest_neighbor(q, r))
    _same_bits(intra_mod.split_queries(
        lambda *a: nn.oriented_min_dist_sq(*a, COS), group, [q, qn],
        [r, rn]), nn.oriented_min_dist_sq(q, qn, r, rn, COS))
    # the passes the step hands down, bound to the group
    passes = intra_mod.on_group(group)
    _same_bits(passes.nearest_neighbor(q, r), nn.nearest_neighbor(q, r))
    _same_bits(passes.min_dist_sq(q, r), nn.min_dist_sq(q, r))
    _same_bits(passes.oriented_min_dist_sq(q, qn, r, rn, COS),
               nn.oriented_min_dist_sq(q, qn, r, rn, COS))
    assert intra_mod.on_group(group[:1]) is bruteforce.ONE_DEVICE


def test_empty_part_runs_nothing():
    q, _, r, _ = _inputs((2,), 2, 30)
    seen = []

    def fn(q, r):
        seen.append(q.shape[-2])
        return nn.min_dist_sq(q.contiguous(), r)
    _same_bits(intra_mod.split_queries(fn, ["cpu"] * 3, [q], [r]),
               nn.min_dist_sq(q, r))
    assert seen == [1, 1]
    seen.clear()
    intra_mod.split_queries(fn, ["cpu"], [q], [r])
    assert seen == [2]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("lead, Q, block", [((), 100, 16), ((2,), 77, 8),
                                            ((3,), 5, 4)])
def test_split_spacing_blocks_are_the_unsplit_ones(monkeypatch, k, lead, Q,
                                                   block):
    q, _, r, _ = _inputs(lead, Q, 200, seed=1)
    shapes = []
    real = bruteforce._block_dist_sq

    def recorded(a, b):
        shapes.append(tuple(a.shape))
        return real(a, b)
    monkeypatch.setattr(bruteforce, "_block_dist_sq", recorded)
    want = bruteforce.topk_dist_sq(q, r, 6, block=block)
    unsplit = sorted(shapes)
    shapes.clear()
    group = intra_mod.on_group(["cpu"] * k)
    _same_bits(group.topk_dist_sq(q, r, 6, block=block), want)
    assert sorted(shapes) == unsplit
    mask = torch.ones(lead + (200,), dtype=torch.bool)
    _same_bits(bruteforce.average_spacing(r, mask, 6, 50, group),
               bruteforce.average_spacing(r, mask, 6, 50))


# ------------------------------------------------------------------ (c)

@pytest.fixture(scope="module")
def pairs():
    return make_pairs(4)


@pytest.fixture(scope="module")
def one_device(pairs):
    """The 4 pairs in lockstep on one device, and its host syncs."""
    ptypes.HOST_SYNCS["count"] = 0
    res = mesh.register_batch(stacked(pairs, 0), stacked(pairs, 1), range(4),
                              CFG, device="cpu")
    return res, ptypes.HOST_SYNCS["count"]


def _counted(monkeypatch):
    """Counts of the K1 and K2 calls (the plain versions on the CPU)."""
    calls = {"K1": 0, "K2": 0}
    lock = threading.Lock()       # the shards call from threads of their own

    def wrap(module, name, key):
        real = getattr(module, name)

        def fn(*a):
            with lock:
                calls[key] += 1
            return real(*a)
        monkeypatch.setattr(module, name, fn)
    wrap(nn, "oriented_min_dist_sq_plain", "K1")
    wrap(nn, "nearest_neighbor_plain", "K2")
    return calls


@pytest.mark.parametrize("n, shards", [(2, 1), (4, 2)])
def test_intra_mesh_equals_one_device(pairs, one_device, monkeypatch, n,
                                      shards):
    calls = _counted(monkeypatch)
    m1 = mesh.make_mesh(devices=["cpu"] * shards)
    ptypes.HOST_SYNCS["count"] = 0
    res1 = mesh.register_batch(stacked(pairs, 0), stacked(pairs, 1),
                               range(4), CFG, m1)
    syncs1, calls1 = ptypes.HOST_SYNCS["count"], dict(calls)
    m2 = mesh.make_mesh(devices=["cpu"] * n, intra=2)
    assert m2.groups == [(torch.device("cpu"),) * 2] * shards
    ptypes.HOST_SYNCS["count"] = 0
    res2 = mesh.register_batch(stacked(pairs, 0), stacked(pairs, 1),
                               range(4), CFG, m2)
    syncs2 = ptypes.HOST_SYNCS["count"]
    calls2 = {k: v - calls1[k] for k, v in calls.items()}
    want, want_syncs = one_device
    for res in (res1, res2):
        for f, x, y in zip(res._fields, res, want):
            assert x.device.type == "cpu", f
            assert x.dtype == y.dtype and torch.equal(x, y), f
    assert bool(res2.success.all())
    assert syncs1 == syncs2, (syncs1, syncs2)
    if shards == 1:
        # and the lone shard's copy of its 8 result fields to the host
        assert syncs2 == want_syncs + 8
    # every K1/K2 pass split over the group's two devices
    assert calls1["K1"] > 0 and calls1["K2"] > 0
    assert calls2 == {k: 2 * v for k, v in calls1.items()}, (calls1, calls2)


# ------------------------------------------------------------------ (d)

def test_intra_mesh_matches_the_reference_intra_mesh():
    two = [_room_pair(seed)[:4] for seed in (0, 1)]
    keys = jax.random.split(jax.random.PRNGKey(3))
    jbatch = [jmesh.stack_clouds([jpad_cloud(p[2 * s], p[2 * s + 1], PAD)
                                  for p in two]) for s in (0, 1)]
    jres = jmesh.register_batch(
        *jbatch, keys, JPladeConfig(**dataclasses.asdict(WIDE)),
        jmesh.make_mesh(4, intra=2, devices=jax.devices("cpu")[:4]))
    draws = [_replayed_draws(k, PAD, WIDE) for key in keys
             for k in jax.random.split(key)]
    res = mesh.register_batch(stacked(two, 0), stacked(two, 1), [0, 0], WIDE,
                              mesh.make_mesh(devices=["cpu"] * 4, intra=2),
                              draws=draws)
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
    assert bool(res.success.all())


# ------------------------------------------------------------------ (e)

def test_mesh_validation():
    cpu = torch.device("cpu")
    m = mesh.make_mesh(devices=["cpu"] * 4, intra=2)
    assert (m.devices, m.intra) == ((cpu,) * 4, 2)
    assert m.groups == [(cpu, cpu), (cpu, cpu)]
    assert mesh.make_mesh(devices=["cpu"] * 3, intra=3).groups == \
        [(cpu,) * 3]
    assert mesh.make_mesh(devices=["cpu"] * 3).groups == [(cpu,)] * 3
    for n, intra in ((3, 2), (4, 3), (4, 0)):
        with pytest.raises(ValueError, match="not divisible"):
            mesh.make_mesh(n, intra=intra, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="never spans ranks"):
        multihost.global_mesh(intra=2, devices=["cpu"] * 3)
    g = multihost.global_mesh(intra=2, devices=["cpu"] * 4)
    assert (g.groups, g.rank, g.world_size) == ([(cpu, cpu)] * 2, 0, 1)
