"""Pairs over a pairs axis of devices and processes (``dist/mesh.py``,
``dist/multihost.py``): the port's mesh against its one-device call and
against the reference's sharded ``register_batch``, on the CPU.

(a) ``make_mesh``: every visible card by default (none raises), devices
    that repeat, the ``n_devices % intra`` check, ``intra > 1`` groups
    (``tests/test_torch_intra.py`` runs them).
(b) ``register_batch`` on 2, 3 and 4 CPU shards (4 pairs split 2/2 and
    2/1/1, 3 pairs 1/1/1/0 with an empty shard): bit for bit the
    one-device call's results, in pair order, on the CPU; a shard's
    exception reaches the caller; the host syncs of 2 shards are the sum of
    their single calls' and their copies of the results to the host; a lone
    shard runs in the caller's thread.
(c) The 2-shard mesh on the reference's replayed draws against
    ``plade_tpu.dist.mesh.register_batch`` on a 2-device CPU mesh: the
    transforms within 0.1 deg and 1e-3, score and overlap within 1e-3,
    success, matched planes and counters equal.
(d) ``register_array_pairs`` on 5 pairs over 2 shards, 2 pairs a shard at
    a time, equals the one-device call.
(e) ``multihost``: ``initialize`` is a no-op for one process; a real
    2-process ``gloo`` world on localhost whose ranks hold 3 and 1 pairs,
    then 0 and 1, then run ``register_array_pairs`` with a rank of no pair
    in the last chunk, gives every rank every result, bit for bit the
    single-process call's; ``local_batch_to_global`` in a world of 1 keeps
    the batch.
(f) ``evaluate_scene`` through the mesh of 2 CPU shards equals
    ``device="cpu"``, recall 1.0 (``tests/test_resso.py``'s case).

CPU tensors never count a kernel launch."""
import dataclasses
import os
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from plade_tpu.core.config import PladeConfig as JPladeConfig
from plade_tpu.core.types import pad_cloud as jpad_cloud
from plade_tpu.dist import mesh as jmesh
from plade_tpu_torch.core import types as ptypes
from plade_tpu_torch.dist import mesh, multihost
from plade_tpu_torch.io import synthetic as tsyn
from plade_tpu_torch.io.resso import evaluate_scene, load_scene
from plade_tpu_torch.kernels import nn
from test_torch_device_step import _room_pair, _rot_deg
from test_torch_extract import _replayed_draws
from torch_multihost_worker import (ARRAY_PAIRS, CFG, PAD, make_pairs,
                                    stacked)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

#: ``CFG`` with the penetration budget that holds the tests of the rotated
#: rooms and scans below (a counter that overflows depends on the order of
#: the dropped tests)
WIDE = dataclasses.replace(CFG, max_penetration_tests=1024)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.fixture(scope="module")
def pairs():
    return make_pairs(5)


@pytest.fixture(scope="module")
def one_device(pairs):
    """The first 4 pairs in lockstep on the CPU, pair ``i`` from seed
    ``i``."""
    return mesh.register_batch(stacked(pairs[:4], 0), stacked(pairs[:4], 1),
                               range(4), CFG, device="cpu")


def _equal(res, want):
    for f, x, y in zip(res._fields, res, want):
        assert x.device.type == "cpu", f
        assert x.dtype == y.dtype and torch.equal(x, y), f


# ------------------------------------------------------------------ (a)

def test_make_mesh_defaults_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mesh.make_mesh(devices=["cuda:0"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mesh.register_batch(stacked(make_pairs(1), 0),
                            stacked(make_pairs(1), 1), [0], CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.make_mesh().devices == tuple(
        torch.device(f"cuda:{k}") for k in range(3))
    assert mesh.make_mesh(2).devices == (torch.device("cuda:0"),
                                         torch.device("cuda:1"))
    assert mesh.device_mesh("cuda").devices == mesh.make_mesh().devices
    assert mesh.device_mesh("cuda:2").devices == (torch.device("cuda:2"),)


def test_make_mesh_devices_and_intra():
    m = mesh.make_mesh(devices=["cpu"] * 4)
    assert m == mesh.Mesh((torch.device("cpu"),) * 4, 0, 1, None)
    assert mesh.make_mesh(3, devices=["cpu"] * 4).devices == \
        (torch.device("cpu"),) * 3
    assert mesh.device_mesh("cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(3, intra=2, devices=["cpu"] * 4)
    m = mesh.make_mesh(4, intra=2, devices=["cpu"] * 4)
    assert m.intra == 2
    assert m.groups == [(torch.device("cpu"),) * 2] * 2
    with pytest.raises(ValueError):
        mesh.make_mesh(5, devices=["cpu"] * 4)
    assert (mesh.PAIRS, mesh.INTRA) == (jmesh.PAIRS, jmesh.INTRA)


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("shards, n", [(2, 4), (3, 4), (4, 3)])
def test_mesh_equals_one_device(pairs, one_device, shards, n):
    res = mesh.register_batch(stacked(pairs[:n], 0), stacked(pairs[:n], 1),
                              range(n), CFG,
                              mesh.make_mesh(devices=["cpu"] * shards))
    _equal(res, ptypes.RegistrationResult(*(x[:n] for x in one_device)))
    assert bool(res.success.all())


def test_shard_exception_reaches_the_caller(pairs, monkeypatch):
    ran = []

    def fake(cfg, num_points, device, intra=()):
        def step(tgt, src, seeds, draws=None):
            ran.append(list(seeds))
            if 2 in seeds:
                raise FloatingPointError("shard of pair 2")
            return mesh._empty_result()
        return step
    monkeypatch.setattr(mesh, "register_pair_device", fake)
    with pytest.raises(FloatingPointError, match="shard of pair 2"):
        mesh.register_batch(stacked(pairs[:4], 0), stacked(pairs[:4], 1),
                            range(4), CFG,
                            mesh.make_mesh(devices=["cpu"] * 2))
    assert sorted(ran) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="mesh or device"):
        mesh.register_batch(stacked(pairs[:1], 0), stacked(pairs[:1], 1),
                            [0], CFG, mesh.make_mesh(devices=["cpu"]),
                            device="cpu")
    with pytest.raises(ValueError, match="2 pairs, 1 seeds"):
        mesh.register_batch(stacked(pairs[:2], 0), stacked(pairs[:2], 1),
                            [0], CFG, device="cpu")


def test_host_syncs_of_shards_add_up(pairs):
    blob = [(p[0][:300], p[1][:300], p[0][:300] + 0.1, p[1][:300])
            for p in pairs[:4]]
    tgt, src = stacked(blob, 0), stacked(blob, 1)
    syncs = []
    for run in (lambda: mesh.register_batch(
                    tgt, src, range(4), CFG,
                    mesh.make_mesh(devices=["cpu"] * 2)),
                lambda: mesh.register_batch(
                    ptypes.Cloud(*(x[:2] for x in tgt)),
                    ptypes.Cloud(*(x[:2] for x in src)), [0, 1], CFG,
                    device="cpu"),
                lambda: mesh.register_batch(
                    ptypes.Cloud(*(x[2:] for x in tgt)),
                    ptypes.Cloud(*(x[2:] for x in src)), [2, 3], CFG,
                    device="cpu")):
        ptypes.HOST_SYNCS["count"] = 0
        run()
        syncs.append(ptypes.HOST_SYNCS["count"])
    # and each shard's one copy of its results to the host
    assert syncs[0] == syncs[1] + syncs[2] + 2 * 1 > 2, syncs


def test_lone_shard_runs_in_the_callers_thread(pairs, monkeypatch):
    threads = []

    def fake(cfg, num_points, device, intra=()):
        def step(tgt, src, seeds, draws=None):
            threads.append(threading.current_thread())
            return mesh._empty_result()
        return step
    monkeypatch.setattr(mesh, "register_pair_device", fake)
    # 4 shards, 1 pair: one shard has pairs
    mesh.register_batch(stacked(pairs[:1], 0), stacked(pairs[:1], 1), [0],
                        CFG, mesh.make_mesh(devices=["cpu"] * 4))
    assert threads == [threading.current_thread()]
    mesh.register_batch(stacked(pairs[:2], 0), stacked(pairs[:2], 1), [0, 1],
                        CFG, mesh.make_mesh(devices=["cpu"] * 2))
    assert len(threads) == 3
    assert threading.current_thread() not in threads[1:]


# ------------------------------------------------------------------ (c)

def test_two_shards_match_the_sharded_reference():
    two = [_room_pair(seed)[:4] for seed in (0, 1)]
    keys = jax.random.split(jax.random.PRNGKey(3))
    jbatch = [jmesh.stack_clouds([jpad_cloud(p[2 * s], p[2 * s + 1], PAD)
                                  for p in two]) for s in (0, 1)]
    jres = jmesh.register_batch(
        *jbatch, keys, JPladeConfig(**dataclasses.asdict(WIDE)),
        jmesh.make_mesh(2, intra=1, devices=jax.devices("cpu")[:2]))
    draws = [_replayed_draws(k, PAD, WIDE) for key in keys
             for k in jax.random.split(key)]
    res = mesh.register_batch(stacked(two, 0), stacked(two, 1), [0, 0], WIDE,
                              mesh.make_mesh(devices=["cpu"] * 2),
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


# ------------------------------------------------------------------ (d)

def test_register_array_pairs_over_shards(pairs):
    two = mesh.make_mesh(devices=["cpu"] * 2)
    over = mesh.register_array_pairs(pairs, CFG, seed=5, mesh=two,
                                     batch_pairs=2)
    one = mesh.register_array_pairs(pairs, CFG, seed=5, device="cpu")
    assert len(over) == len(one) == 5
    for a, b in zip(over, one):
        np.testing.assert_array_equal(a.transform, b.transform)
        assert a._replace(transform=None) == b._replace(transform=None)
    assert all(o.success for o in over)
    with pytest.raises(ValueError, match="mesh or device"):
        mesh.register_array_pairs(pairs, CFG, mesh=two, device="cpu")


# ------------------------------------------------------------------ (e)

def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    m = multihost.global_mesh(devices=["cpu", "cpu"])
    assert (m.rank, m.world_size, m.group) == (0, 1, None)


def test_local_batch_to_global_in_a_world_of_one(pairs):
    m = mesh.make_mesh(devices=["cpu"])
    tgt, src = stacked(pairs[:2], 0), stacked(pairs[:2], 1)
    (t, s, seeds), offsets = multihost.local_batch_to_global(
        m, tgt, src, np.array([7, 8]))
    assert t is tgt and s is src and seeds == [7, 8]
    assert offsets == [0, 2]
    with pytest.raises(ValueError, match="2 targets, 2 sources, 1 seeds"):
        multihost.local_batch_to_global(m, tgt, src, [7])


def test_two_process_world(one_device, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", f"127.0.0.1:{port}",
         str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"WORKER_OK rank={r}" in log, log[-3000:]
        got = np.load(outs[r])
        for name, rows in (("ragged", slice(0, 4)), ("empty", slice(3, 4))):
            _equal(ptypes.RegistrationResult(
                *(torch.from_numpy(got[f"{name}_{f}"])
                  for f in one_device._fields)),
                ptypes.RegistrationResult(*(x[rows] for x in one_device)))
        for f, want in zip(one_device._fields, one_device):
            np.testing.assert_array_equal(got[f"array_{f}"],
                                          want[:ARRAY_PAIRS].numpy())


# ------------------------------------------------------------------ (f)

def test_evaluate_scene_over_shards(tmp_path):
    rng = np.random.default_rng(5)
    scans, poses = tsyn.make_scan_sequence(
        rng, n_scans=3, n_points=9000, overlap_radius=3.4, step=1.4,
        n_rooms=2, n_per_plane=1200, noise=0.002, extra_planes=3,
        max_angle=0.8, max_trans=0.4)
    scene = load_scene(tsyn.write_scene(str(tmp_path / "scene"), scans,
                                        poses))
    over = evaluate_scene(scene, cfg=WIDE, device_batch=True,
                          mesh=mesh.make_mesh(devices=["cpu"] * 2),
                          verbose=False)
    one = evaluate_scene(scene, cfg=WIDE, device_batch=True,
                         device="cpu", verbose=False)
    assert len(over.results) == 2
    assert over.recall == 1.0, [
        (r.rot_err_deg, r.trans_err) for r in over.results]
    for a, b in zip(over.results, one.results):
        np.testing.assert_array_equal(a.transform, b.transform)
        assert (a.success, a.rot_err_deg, a.trans_err) == \
            (b.success, b.rot_err_deg, b.trans_err)
