"""The port's scene mode (``python -m plade_tpu_torch.cli scene``) on the
CPU: the case of ``tests/test_scene_cli.py`` (three scans of one room with
known poses, pairwise registration, then pose-graph sync), sequential and
with ``--device-batch``, at ``SMALL_CFG`` sizes.  CPU tensors run the plain
kernel versions: no launch is counted."""
import numpy as np
import pytest

from plade_tpu_torch.cli.main import main
from plade_tpu_torch.io.ply import write_ply
from plade_tpu_torch.io.synthetic import (make_room, random_rigid,
                                          transform_cloud)
from plade_tpu_torch.kernels import nn
from test_torch_register import CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    """Three scans of one room scene with known world poses; scan k is the
    room observed from pose T_k (p_scan = T_k^{-1} p_world)."""
    d = tmp_path_factory.mktemp("resso_scene")
    rng = np.random.default_rng(3)
    pts, nrm, _ = make_room(rng, n_per_plane=1200, noise=0.002,
                            extra_planes=3)
    poses = [np.eye(4)]
    for _ in range(2):
        R, t = random_rigid(rng, max_angle=0.8, max_trans=0.5)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    for k, T in enumerate(poses):
        Rinv = T[:3, :3].T
        tinv = -Rinv @ T[:3, 3]
        spts, snrm = transform_cloud(pts, nrm, Rinv, tinv)
        write_ply(str(d / f"scan_{k}.ply"), spts, snrm)
    gt = d / "groundtruth.txt"
    with open(gt, "w") as f:
        for k, T in enumerate(poses):
            f.write(f"scan_{k}\n")
            f.write("\n".join(" ".join(f"{v:.8g}" for v in row)
                              for row in T) + "\n")
    return str(d), poses


@pytest.mark.parametrize("device_batch", [False, True],
                         ids=["sequential", "device_batch"])
def test_scene_mode(scan_dir, monkeypatch, capsys, tmp_path, device_batch):
    d, poses = scan_dir
    import plade_tpu_torch.core.config as cfgmod
    monkeypatch.setattr(cfgmod, "PladeConfig", lambda **kw: CFG)
    out = str(tmp_path / "poses.txt")
    rc = main(["scene", d, out, "--device", "cpu"]
              + (["--device-batch"] if device_batch else []))
    assert rc == 0
    text = open(out).read().splitlines()
    # 3 scans: name line + 4 matrix rows each
    assert len(text) == 3 * 5
    got = []
    for k in range(3):
        assert text[k * 5] == f"scan_{k}.ply"
        rows = [text[k * 5 + 1 + r].split() for r in range(4)]
        got.append(np.asarray(rows, np.float64))
    # recovered poses are world-from-scan in scan-0's frame; ground truth
    # rebased the same way
    base = np.linalg.inv(poses[0])
    for k in range(3):
        gt_k = base @ poses[k]
        c = (np.trace(gt_k[:3, :3].T @ got[k][:3, :3]) - 1) / 2
        rot_err = np.degrees(np.arccos(np.clip(c, -1, 1)))
        assert rot_err < 3.0, (k, rot_err)
        assert np.linalg.norm(got[k][:3, 3] - gt_k[:3, 3]) < 0.2, k
    err = capsys.readouterr().out
    assert "vs ground truth" in err
    assert err.count("pair (") == 2
