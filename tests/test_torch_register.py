"""The port's ``register_clouds`` end to end on the CPU, at ``SMALL_CFG``
sizes, held to ground truth with the bounds of the reference's own tests
(``tests/test_pipeline.py``): the two synthetic rooms (seeds 0 and 1), the
identity pair and the small-overlap scan.  The draws come from the port's
own generators, so the plane sets are not the reference's and the result
is held to the known pose, as the reference's tests hold theirs.  CPU
tensors run the plain kernel versions: no launch is counted.
``tests/test_torch_register_files.py`` has the swap, failure and file
paths."""
import numpy as np
import pytest

from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu_torch.core.convert import config_from
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.pipeline import register_clouds
from test_pipeline import SMALL_CFG, rotation_error_deg
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CFG = config_from(SMALL_CFG)
#: the keys of the reference's info dict on a registration that ran
INFO_KEYS = {"swapped", "tgt_planes", "src_planes", "average_spacing",
             "score", "overlap", "matched_planes", "success",
             "match_saturated", "pen_overflow", "cluster_truncated"}


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _room_pair(seed):
    rng = np.random.default_rng(seed)
    pts, nrm, _ = make_room(rng, n_per_plane=1400, noise=0.003,
                            extra_planes=3)
    R, t = random_rigid(rng, max_angle=2.5, max_trans=1.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    spts = spts + rng.normal(scale=0.002, size=spts.shape).astype(np.float32)
    return pts, nrm, spts, snrm, R, t


@pytest.mark.parametrize("seed", [0, 1])
def test_register_clouds_synthetic_room(seed):
    pts, nrm, spts, snrm, R, t = _room_pair(seed)
    T, info = register_clouds(pts, nrm, spts, snrm, CFG, seed=seed,
                              device="cpu")
    assert info["success"], info
    assert set(info) == INFO_KEYS
    assert rotation_error_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.12
    for key in ("match_saturated", "pen_overflow", "cluster_truncated"):
        assert info[key] == 0, key


def test_register_clouds_identity_pair():
    rng = np.random.default_rng(3)
    pts, nrm, _ = make_room(rng, n_per_plane=1200, noise=0.002,
                            extra_planes=2)
    pts2 = pts + rng.normal(scale=0.002, size=pts.shape).astype(np.float32)
    T, info = register_clouds(pts, nrm, pts2, nrm, CFG, seed=0,
                              device="cpu")
    assert info["success"], info
    assert rotation_error_deg(T[:3, :3], np.eye(3)) < 2.0
    assert np.linalg.norm(T[:3, 3]) < 0.1
    assert info["overlap"] > 0.5


def test_register_clouds_small_overlap(rng):
    pts, nrm, _ = make_room(rng, n_per_plane=2000, noise=0.002,
                            extra_planes=6,
                            faces=("floor", "wall_y-", "wall_x+"))
    lo, hi = np.quantile(pts[:, 0], [0.35, 0.65])
    tgt_sel = pts[:, 0] <= hi
    src_sel = pts[:, 0] >= lo
    R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = transform_cloud(pts[src_sel], nrm[src_sel], R.T, -R.T @ t)
    T, info = register_clouds(pts[tgt_sel], nrm[tgt_sel], spts, snrm, CFG,
                              seed=0, device="cpu")
    assert info["success"], info
    assert rotation_error_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.15
