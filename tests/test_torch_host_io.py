"""The port's host-side IO beside the reference package's, on the CPU: the
RESSO loader and evaluation harness (the cases of ``tests/test_resso.py``,
with ``evaluate_scene(device="cpu", device_batch=True)`` in place of the
mesh), the copies ``save_vg``, ``write_scene`` and ``export_html`` held
byte for byte to the originals, and the port's native PLY reader (built
from its own copy of ``ply_io.cpp``) against the numpy reader."""
import os

import numpy as np
import pytest

import plade_tpu.cli.viewer as jviewer
import plade_tpu.io.synthetic as jsyn
import plade_tpu.io.vg as jvg
from plade_tpu_torch.cli import viewer as tviewer
from plade_tpu_torch.io import native
from plade_tpu_torch.io import ply as tply
from plade_tpu_torch.io import synthetic as tsyn
from plade_tpu_torch.io import vg as tvg
from plade_tpu_torch.io.resso import (EvalSummary, PairResult,
                                      _read_matrices, consecutive_pairs,
                                      evaluate_scene, load_scene,
                                      rotation_error_deg)
from plade_tpu_torch.kernels import nn
from test_torch_register import CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _write_scene(d, n_scans=3):
    rng = np.random.default_rng(0)
    pts, nrm, _ = tsyn.make_room(rng, n_per_plane=200, noise=0.002,
                                 extra_planes=2)
    poses = []
    for k in range(n_scans):
        R, t = tsyn.random_rigid(rng, max_angle=1.0, max_trans=0.5)
        # scan k = scene points seen in frame k: x_scan = R^T (x_scene - t)
        spts, snrm = tsyn.transform_cloud(pts, nrm, R.T, -R.T @ t)
        tply.write_ply(str(d / f"scan_{k}.ply"), spts, snrm)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    with open(d / "groundtruth.txt", "w") as f:
        for k, T in enumerate(poses):
            f.write(f"scan_{k}\n")
            for row in T:
                f.write(" ".join(str(v) for v in row) + "\n")
    return poses


def test_load_scene_and_pair_gt(tmp_path):
    poses = _write_scene(tmp_path)
    scene = load_scene(str(tmp_path))
    assert len(scene.scan_files) == 3
    assert scene.gt_poses is not None and scene.gt_poses.shape == (3, 4, 4)
    G = scene.pair_ground_truth(0, 1)
    expected = np.linalg.inv(poses[0]) @ poses[1]
    np.testing.assert_allclose(G, expected, atol=1e-12)
    assert consecutive_pairs(scene) == [(0, 1), (1, 2)]


def test_read_matrices_tolerates_headers(tmp_path):
    p = tmp_path / "gt.log"
    p.write_text("0 1 0\n" + "\n".join(
        " ".join(str(float(i == j)) for j in range(4)) for i in range(4)) + "\n")
    names, mats = _read_matrices(str(p))
    assert mats.shape == (1, 4, 4)
    np.testing.assert_allclose(mats[0], np.eye(4))


def test_make_scan_sequence_overlap_and_gt(tmp_path):
    """The synthetic RESSO-equivalent generator: consecutive scans share a
    partial (30-70%) region, ground-truth poses map scans back onto the
    world, and write_scene produces a directory load_scene can read."""
    rng = np.random.default_rng(3)
    scans, poses = tsyn.make_scan_sequence(
        rng, n_scans=4, n_points=4000, overlap_radius=2.6, step=2.0,
        n_rooms=2, n_per_plane=400, noise=0.005, extra_planes=2)
    assert len(scans) == 4 and poses.shape == (4, 4, 4)
    world_pts = [s[0] @ T[:3, :3].T + T[:3, 3] for (s, T) in
                 zip(scans, poses)]
    for a, b in zip(world_pts[:-1], world_pts[1:]):
        # partial overlap: some a-points near b (shared region), some far
        mn = np.abs(a[:, None, 0] - b[None, :, 0]).min(axis=1)
        frac = float((mn < 1e-3).mean())
        assert 0.2 < frac < 0.8, frac
    d = tsyn.write_scene(str(tmp_path / "scene"), scans, poses)
    scene = load_scene(d)
    assert len(scene.scan_files) == 4
    assert scene.gt_poses is not None
    np.testing.assert_allclose(scene.gt_poses, poses, atol=1e-8)


def test_evaluate_scene_device_batch(tmp_path):
    """evaluate_scene(device_batch=True) routes the pairs through the
    device step (dist/mesh.register_array_pairs) and scores recall against
    ground truth."""
    rng = np.random.default_rng(5)
    scans, poses = tsyn.make_scan_sequence(
        rng, n_scans=3, n_points=9000, overlap_radius=3.4, step=1.4,
        n_rooms=2, n_per_plane=1200, noise=0.002, extra_planes=3,
        max_angle=0.8, max_trans=0.4)
    d = tsyn.write_scene(str(tmp_path / "scene"), scans, poses)
    scene = load_scene(d)
    summary = evaluate_scene(scene, cfg=CFG, device_batch=True,
                             device="cpu", verbose=False)
    assert len(summary.results) == 2
    assert summary.recall == 1.0, [
        (r.rot_err_deg, r.trans_err) for r in summary.results]


def test_eval_summary_metrics():
    s = EvalSummary(rot_thresh_deg=5.0, trans_thresh=0.5)
    s.results = [
        PairResult("a", "b", np.eye(4), True, rot_err_deg=1.0, trans_err=0.1),
        PairResult("b", "c", np.eye(4), True, rot_err_deg=30.0, trans_err=2.0),
    ]
    assert s.recall == 0.5
    assert abs(s.rmse_trans - np.sqrt((0.1 ** 2 + 2.0 ** 2) / 2)) < 1e-12
    assert rotation_error_deg(np.eye(3), np.eye(3)) == 0.0


@pytest.mark.parametrize("with_normals", [True, False])
def test_save_vg_matches_reference(tmp_path, rng, with_normals):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32) if with_normals \
        else None
    labels = rng.integers(-1, 5, size=300).astype(np.int32)
    mine, ref = tmp_path / "mine.vg", tmp_path / "ref.vg"
    tvg.save_vg(str(mine), pts, nrm, labels, 5, seed=3)
    jvg.save_vg(str(ref), pts, nrm, labels, 5, seed=3)
    assert mine.read_bytes() == ref.read_bytes()


def test_write_scene_matches_reference(tmp_path):
    scans, poses = tsyn.make_scan_sequence(
        np.random.default_rng(4), n_scans=3, n_points=500,
        overlap_radius=2.6, step=2.0, n_rooms=2, n_per_plane=200,
        noise=0.005, extra_planes=2)
    mine = tsyn.write_scene(str(tmp_path / "mine"), scans, poses,
                            gt_name="poses.txt")
    ref = jsyn.write_scene(str(tmp_path / "ref"), scans, poses,
                           gt_name="poses.txt")
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names == \
        ["poses.txt", "scan_00.ply", "scan_01.ply", "scan_02.ply"]
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def test_export_html_matches_reference(tmp_path, rng):
    """The same result file gives the same viewer HTML, byte for byte,
    including a subsampled cloud (above ``max_points``) without normals."""
    pts = rng.normal(size=(900, 3)).astype(np.float32)
    nrm = rng.normal(size=(900, 3)).astype(np.float32)
    tgt, src = str(tmp_path / "t.ply"), str(tmp_path / "s.ply")
    tply.write_ply(tgt, pts, nrm)
    tply.write_ply(src, pts[::-1] + 0.5, None)
    res = tmp_path / "res.txt"
    res.write_text(f"target: {tgt}\nsource: {src}\ntransformation:\n"
                   "0.8 -0.6 0 0.1\n0.6 0.8 0 -0.2\n0 0 1 0.3\n0 0 0 1\n")
    for max_points in (120000, 500):
        mine, ref = tmp_path / "mine.html", tmp_path / "ref.html"
        assert tviewer.export_html(str(res), str(mine),
                                   max_points=max_points) == 0
        assert jviewer.export_html(str(res), str(ref),
                                   max_points=max_points) == 0
        assert mine.read_bytes() == ref.read_bytes()


def test_native_reader_matches_numpy(tmp_path, rng):
    """The port's native reader (its own ``native/ply_io.cpp``, built by
    make) reads what the numpy reader reads, one file at a time and in the
    threaded batch, and its writer writes what the numpy writer writes."""
    if not native.available():
        pytest.skip("make could not build plade_tpu_torch/native")
    assert native._SO.startswith(os.path.join(
        os.path.dirname(os.path.dirname(tply.__file__)), "native"))
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    nrm = rng.normal(size=(1000, 3)).astype(np.float32)
    paths = []
    for name, normals, binary in (("bin_n", nrm, True), ("ascii_n", nrm, False),
                                  ("bin", None, True), ("ascii", None, False)):
        paths.append(str(tmp_path / f"{name}.ply"))
        tply.write_ply(paths[-1], pts, normals, binary=binary)
    batch = native.read_ply_batch(paths + [str(tmp_path / "missing.ply")])
    assert batch[-1] is None
    for path, got_batch in zip(paths, batch):
        want = tply._read_ply_numpy(path)
        for got in (native.read_ply(path), got_batch, tply.read_ply(path)):
            for a, b in zip(got, want, strict=True):
                if b is None:
                    assert a is None, path
                    continue
                assert a.dtype == b.dtype == np.float32, path
                np.testing.assert_array_equal(a, b, err_msg=path)
    mine, ref = tmp_path / "native.ply", tmp_path / "numpy.ply"
    native.write_ply(str(mine), pts, nrm)
    tply.write_ply(str(ref), pts, nrm)
    assert mine.read_bytes() == ref.read_bytes()
