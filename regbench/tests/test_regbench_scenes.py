"""The frozen generators equal the port's, and the pools are the data
they stand for: the suite's scenes byte for byte, and chip_smoke's room
and bench.py's scan pairs."""
import json
from pathlib import Path

import numpy as np
import pytest

from regbench import scenes

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "regbench" / "configs" / f"{name}.json")
                      .read_text())


def test_generators_equal_the_ports_at_seed_0():
    syn = pytest.importorskip("plade_tpu_torch.io.synthetic")
    a = scenes.make_room(np.random.default_rng(0), 500, 0.01, 4.0, 3, 2.0)
    b = syn.make_room(np.random.default_rng(0), 500, 0.01, 4.0, 3, 2.0)
    for x, y in zip(a[:2], b[:2]):
        assert np.array_equal(x, y)
    a = scenes.make_world(np.random.default_rng(0), n_rooms=2,
                          n_per_plane=300, noise=0.01)
    b = syn.make_world(np.random.default_rng(0), n_rooms=2, n_per_plane=300,
                       noise=0.01)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(
        scenes.random_rigid(np.random.default_rng(0), 1.0, 0.5),
        syn.random_rigid(np.random.default_rng(0), 1.0, 0.5)))


def test_resso60k_is_the_suites_scenes_byte_for_byte():
    run_eval = pytest.importorskip("plade_tpu_torch.tools.run_eval")
    syn = pytest.importorskip("plade_tpu_torch.io.synthetic")
    pool = scenes.build_pool(_config("resso60k")["pool"])
    k = 0
    for sc in run_eval.SCENES:
        scans, poses = syn.make_scan_sequence(
            np.random.default_rng(sc["seed"]), n_scans=sc["n_scans"],
            n_points=run_eval.N_POINTS, overlap_radius=sc["radius"],
            step=sc["step"], n_rooms=sc["n_rooms"],
            n_per_plane=sc["n_per_plane"], noise=sc["noise"] * sc["size"],
            size=sc["size"], extra_planes=sc["extra_planes"],
            normal_noise_deg=sc["nn_deg"], max_angle=sc["max_angle"],
            max_trans=sc["max_trans"])
        for i in range(sc["n_scans"] - 1):
            p = pool[k]
            assert p.name == f"{sc['name']}:{i}-{i + 1}"
            for x, y in zip(p[:4], (*scans[i], *scans[i + 1])):
                assert x.tobytes() == y.tobytes()
            assert np.array_equal(p.truth,
                                  np.linalg.inv(poses[i]) @ poses[i + 1])
            k += 1
    assert k == len(pool) == 41


def test_tls131k_is_chip_smokes_batch():
    syn = pytest.importorskip("plade_tpu_torch.io.synthetic")
    pool = scenes.build_pool(_config("tls131k")["pool"])
    assert len(pool) == 8
    # chip_smoke.make_scene(16000, 0, ...): the room of (c) and (o)
    rng = np.random.default_rng(0)
    pts, nrm, _ = syn.make_room(rng, n_per_plane=16000, noise=0.002,
                                extra_planes=6, normal_noise_deg=2.0)
    perm = rng.permutation(pts.shape[0])
    ti, si = perm[:96000], perm[96000:]
    R, t = syn.random_rigid(rng, max_angle=1.0, max_trans=0.5)
    sp, sn = syn.transform_cloud(pts[si], nrm[si], R.T, -R.T @ t)
    for x, y in zip(pool[0][:4], (pts[ti], nrm[ti], sp, sn)):
        assert np.array_equal(x, y)
    assert np.allclose(pool[0].truth[:3, :3], R)
    # chip_smoke.scan_pairs: bench.py:84-89 from rng(1000 + b)
    settings = dict(overlap_radius=3.4, step=2.0, n_rooms=3,
                    n_per_plane=9000, noise=0.02, size=4.0, extra_planes=3,
                    normal_noise_deg=3.0, max_angle=1.0, max_trans=0.6)
    for b in range(1, 8):
        scans, poses = syn.make_scan_sequence(
            np.random.default_rng(1000 + b), n_scans=2, n_points=100000,
            **settings)
        for x, y in zip(pool[b][:4], (*scans[0], *scans[1])):
            assert np.array_equal(x, y)
        assert pool[b].tgt_points.shape[0] <= 131072


def test_the_pool_is_the_same_for_every_run_seed():
    """The run seed never reaches the clouds: build_pool takes none."""
    a = scenes.build_pool(_config("tls131k")["pool"][:2])
    b = scenes.build_pool(_config("tls131k")["pool"][:2])
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p[:5], q[:5]))
