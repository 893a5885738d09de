"""The port's ``register_clouds`` paths beside the plain registration, on
the CPU at ``SMALL_CFG`` sizes: the target/source swap, the "too few
planes" failure, the cap at ``max_points``, and a PLY round trip through
``register_files``, against ground truth with the bounds of
``tests/test_pipeline.py``'s overload pairs, on a smaller room (the pinned
overload is in ``tests/test_torch_pinned.py``).  CPU tensors run the plain
kernel versions: no launch is counted."""
import dataclasses

import numpy as np
import pytest

from plade_tpu.io.synthetic import make_room, random_rigid, transform_cloud
from plade_tpu_torch.io.ply import write_ply
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.pipeline import register_clouds, register_files
from test_pipeline import rotation_error_deg
from test_torch_register import CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def _small_pair(seed):
    """A room of 8 planes x 1000 points and a copy moved by a known rigid
    transform (smaller than the reference tests' rooms, to keep the CPU
    time of these paths short)."""
    rng = np.random.default_rng(seed)
    pts, nrm, _ = make_room(rng, n_per_plane=1000, noise=0.002,
                            extra_planes=2)
    R, t = random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = transform_cloud(pts, nrm, R.T, -R.T @ t)
    return pts, nrm, spts, snrm, R, t


def test_register_clouds_swaps_larger_source():
    """A source >= 1.2x the target is registered the other way round and
    the transform inverted back (plade.cpp:690-704)."""
    pts, nrm, spts, snrm, R, t = _small_pair(0)
    keep = np.random.default_rng(5).random(pts.shape[0]) < 0.7
    T, info = register_clouds(pts[keep], nrm[keep], spts, snrm, CFG, seed=0,
                              device="cpu")
    assert info["swapped"] and info["success"], info
    assert rotation_error_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.15


def test_register_clouds_too_few_planes():
    """A Gaussian blob has no planes: identity and the failure note."""
    rng = np.random.default_rng(0)
    blob = rng.normal(size=(2000, 3)).astype(np.float32)
    nrm = rng.normal(size=(2000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    T, info = register_clouds(blob, nrm, blob + 0.1, nrm, CFG, seed=0,
                              device="cpu")
    np.testing.assert_array_equal(T, np.eye(4, dtype=np.float32))
    assert info["failure"] == "too few planes"
    assert min(info["tgt_planes"], info["src_planes"]) < CFG.min_planes
    assert set(info) == {"swapped", "tgt_planes", "src_planes", "failure"}


def test_register_clouds_capped_cloud_is_reported():
    """Clouds above ``max_points`` are subsampled and the cap is reported
    (a plane-less blob, so the run stops after extraction)."""
    rng = np.random.default_rng(1)
    blob = rng.normal(size=(5000, 3)).astype(np.float32)
    nrm = blob / np.linalg.norm(blob, axis=1, keepdims=True)
    cfg = dataclasses.replace(CFG, max_points=4096)
    T, info = register_clouds(blob, nrm, blob[:4500], nrm[:4500], cfg,
                              seed=0, device="cpu")
    assert info["cloud_capped"] == {"target": True, "source": True,
                                    "max_points": 4096}
    assert info["failure"] == "too few planes"


def test_register_files_ply_round_trip(tmp_path):
    pts, nrm, spts, snrm, R, t = _small_pair(1)
    write_ply(str(tmp_path / "target.ply"), pts, nrm)
    write_ply(str(tmp_path / "source.ply"), spts, snrm, binary=False)
    T, info = register_files(str(tmp_path / "target.ply"),
                             str(tmp_path / "source.ply"), CFG, seed=1,
                             device="cpu")
    assert info["success"], info
    assert rotation_error_deg(T[:3, :3], R) < 3.0
    assert np.linalg.norm(T[:3, 3] - t) < 0.15
    write_ply(str(tmp_path / "bare.ply"), pts)
    with pytest.raises(ValueError, match="normals"):
        register_files(str(tmp_path / "bare.ply"),
                       str(tmp_path / "source.ply"), CFG, device="cpu")
