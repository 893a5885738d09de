"""The degraded 6-D descriptor families (``enable_degraded_families``) of the
port against the reference package on the CPU, on the scene of
``tests/test_torch_options.py``.

* End to end through ``register_with_planes`` on the same clouds and
  planes, held as the other options are there.
* ``degraded_descriptors`` for both families, target and query side, on
  the reference's prepared lines: line indices and counts exact, values
  within 1e-5.
* ``stitch_hypotheses`` on segments with counts below, at and above their
  buffers: exact.

CPU tensors never count a kernel launch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plade_tpu.descriptors import pairlines as jpl
from plade_tpu.match import matching as jm
from plade_tpu_torch.core.convert import from_numpy
from plade_tpu_torch.descriptors import pairlines
from plade_tpu_torch.kernels import nn
from plade_tpu_torch.match import matching
from test_torch_options import CFG, register_both, scene  # noqa: F401
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(nn.LAUNCHES)
    yield
    assert nn.LAUNCHES == before, "a CPU tensor counted a kernel launch"


def test_degraded_families_match_reference(scene, monkeypatch):
    families = []
    degraded = pairlines.degraded_descriptors
    monkeypatch.setattr(
        "plade_tpu_torch.pipeline.degraded_descriptors",
        lambda *a, **kw: families.append(kw["family"]) or degraded(*a, **kw))
    register_both(scene, dataclasses.replace(
        CFG, enable_degraded_families=True))
    assert families == ["2221", "2221", "2212", "2212"]


@pytest.mark.parametrize("family", ["2221", "2212"])
@pytest.mark.parametrize("ordered", [True, False])
def test_degraded_descriptors_match_reference(scene, family, ordered):
    jl = scene["prep"].lines
    normals = scene["prep"].planes.coeffs[:, :3]
    scale = np.float32(0.3)
    kw = dict(max_pairs=256 if ordered else 128, ordered=ordered,
              min_angle_cos=float(np.cos(CFG.line_pair_min_angle)),
              family=family, pad_value=-1e6 if ordered else 1e6)
    want = jpl.degraded_descriptors(jl, normals, scale, **kw)
    got = pairlines.degraded_descriptors(
        from_numpy(jl), from_numpy(normals), torch.tensor(scale), **kw)
    assert int(got.count) == int(want.count) > 0
    np.testing.assert_array_equal(got.line_idx.numpy(),
                                  np.asarray(want.line_idx))
    for f in ("desc", "line_vec1", "line_vec2", "anchor"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   err_msg=f)


def test_stitch_hypotheses_matches_reference(rng):
    segs = []
    for M, c in ((40, 13), (24, 30), (16, 16)):
        R = rng.normal(size=(M, 3, 3)).astype(np.float32)
        t = rng.normal(size=(M, 3)).astype(np.float32)
        segs.append((R, t, np.int32(c)))
    want = jm.stitch_hypotheses([tuple(jnp.asarray(x) for x in s)
                                 for s in segs])
    got = matching.stitch_hypotheses([tuple(torch.as_tensor(x) for x in s)
                                      for s in segs])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[3]) == 13 + 24 + 16
