"""Where the port's entry points run: ``register_clouds``,
``register_with_planes`` and ``register_files`` default to CUDA whatever
their inputs are, raise ``RuntimeError`` naming ``device="cpu"`` when CUDA is
asked for (or defaulted) and absent, and run on the CPU only when the caller
passes ``device="cpu"``.  The CUDA check is patched to "absent" so that the
raise is tested on any machine."""
import numpy as np
import pytest
import torch

from plade_tpu_torch import pipeline
from plade_tpu_torch.core.types import PlaneSet
from plade_tpu_torch.io.ply import write_ply
from plade_tpu_torch.kernels import nn
from test_torch_register import CFG
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ENTRIES = ["register_clouds", "register_with_planes", "register_files"]


def _blob(n=2000, seed=0):
    """A Gaussian blob with random normals: no planes."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def _call(entry, tmp_path, **kwargs):
    """One call of ``entry`` on the blob (target) and a shifted copy."""
    pts, nrm = _blob()
    if entry == "register_clouds":
        return pipeline.register_clouds(pts, nrm, pts + 0.1, nrm, CFG,
                                        seed=0, **kwargs)
    if entry == "register_files":
        write_ply(str(tmp_path / "target.ply"), pts, nrm)
        write_ply(str(tmp_path / "source.ply"), pts + 0.1, nrm)
        return pipeline.register_files(str(tmp_path / "target.ply"),
                                       str(tmp_path / "source.ply"), CFG,
                                       seed=0, **kwargs)
    planes = PlaneSet(np.zeros((CFG.max_planes, 4), np.float32),
                      np.zeros(CFG.max_planes, np.int32), np.int32(0),
                      np.full(pts.shape[0], -1, np.int32))
    return pipeline.register_with_planes(pts, nrm, pts + 0.1, nrm, planes,
                                         planes, CFG, **kwargs)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ENTRIES)
def test_default_device_without_cuda_raises(entry, tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _call(entry, tmp_path)


@pytest.mark.parametrize("entry", ENTRIES)
def test_cuda_without_card_raises(entry, tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _call(entry, tmp_path, device="cuda")


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_when_asked(entry, tmp_path, no_cuda):
    """``device="cpu"`` runs the plain kernel versions: identity and the
    "too few planes" note for a plane-less blob, no launch counted."""
    before = dict(nn.LAUNCHES)
    T, info = _call(entry, tmp_path, device="cpu")
    assert nn.LAUNCHES == before
    np.testing.assert_array_equal(T, np.eye(4, dtype=np.float32))
    assert info["failure"] == "too few planes"


def test_default_is_cuda_whatever_the_inputs(monkeypatch):
    """With a card, ``device=None`` means CUDA even for CPU tensors and
    numpy inputs; an explicit device is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pipeline._run_device(None) == torch.device("cuda")
    assert pipeline._run_device("cuda:1") == torch.device("cuda:1")
    assert pipeline._run_device("cpu") == torch.device("cpu")
    assert pipeline._run_device(torch.device("cpu")) == torch.device("cpu")
