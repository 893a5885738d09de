"""The plain reference against brute force in numpy at tiny sizes, and
the control's TF32 arithmetic."""
import math

import numpy as np
import pytest
import torch

from regbench.reference import nn as ref_nn
from regbench.reference import precision, spacing
from regbench.reference.pose import pose_errors


def _clouds(seed=0, P=2, Q=40, T=30):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2, 2, size=(P, Q, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, size=(P, T, 3)).astype(np.float32)
    qn = rng.normal(size=(P, Q, 3))
    rn = rng.normal(size=(P, T, 3))
    qn = (qn / np.linalg.norm(qn, axis=-1, keepdims=True)).astype(np.float32)
    rn = (rn / np.linalg.norm(rn, axis=-1, keepdims=True)).astype(np.float32)
    return q, qn, r, rn


def _rows(P, Q):
    return torch.tensor([(p, i) for p in range(P) for i in range(0, Q, 3)])


def test_k2_reference_is_brute_force():
    q, _, r, _ = _clouds()
    rows = _rows(*q.shape[:2])
    d2 = ((q[:, :, None, :].astype(np.float64)
           - r[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    index = torch.zeros(rows.shape[0], dtype=torch.int64)
    least, at = ref_nn.k2_reference(torch.from_numpy(q), torch.from_numpy(r),
                                    rows, index, block=4)
    for n, (p, i) in enumerate(rows.tolist()):
        assert least[n].item() == d2[p, i].min()
        assert at[n].item() == d2[p, i, 0]


def test_k1_reference_is_brute_force():
    q, qn, r, rn = _clouds(1)
    cos = 0.3
    rows = _rows(*q.shape[:2])
    got = ref_nn.k1_reference(*map(torch.from_numpy, (q, qn, r, rn)), cos,
                              rows, block=5)
    for n, (p, i) in enumerate(rows.tolist()):
        dot = (qn[p, i, 0] * rn[p, :, 0] + qn[p, i, 1] * rn[p, :, 1]) \
            + qn[p, i, 2] * rn[p, :, 2]
        d2 = ((q[p, i].astype(np.float64) - r[p].astype(np.float64)) ** 2
              ).sum(-1)
        ok = dot >= np.float32(cos)
        want = d2[ok].min() if ok.any() else math.inf
        assert got[n].item() == want


def test_spacing_is_brute_force():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    k, samples = 6, 120
    step = max(len(pts) // samples, 1)
    idx = [i for i in range(0, samples * step, step) if i < len(pts)]
    p64 = pts.astype(np.float64)
    per = []
    for i in idx:
        d = np.sort(((p64 - p64[i]) ** 2).sum(-1))[:k]
        per.append(np.sqrt(d[1:]).sum() / k)
    assert spacing.average_spacing(pts, k, samples, block=7) \
        == pytest.approx(np.mean(per), rel=1e-12)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11,
                      -3.0 - 2 ** -9])
    got = precision.tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                            -3.0 - 2 ** -9]


def test_control_spacing_is_far_from_the_reference():
    """At scanner coordinates a few units from the origin, TF32's products
    lose the squared spacing: the control's gap is large."""
    rng = np.random.default_rng(3)
    pts = (rng.uniform(-0.5, 0.5, size=(2000, 3)) + 3.0).astype(np.float32)
    ref = spacing.average_spacing(pts, 6, 500)
    ctl = spacing.average_spacing_tf32(pts, 6, 500)
    assert abs(ctl - ref) / ref > 0.05


def test_relative_gap():
    inf = math.inf
    ref = torch.tensor([0.0, 1.0, inf, 2.0], dtype=torch.float64)
    assert ref_nn.relative_gap(torch.tensor([0.0, 1.0, inf, 2.0]), ref) == 0
    assert ref_nn.relative_gap(torch.tensor([0.0, 1.5, inf, 2.0]), ref) \
        == 0.5
    assert ref_nn.relative_gap(torch.tensor([0.0, 1.0, 3.0, 2.0]), ref) \
        == inf
    # a distance where the reference has 0: a gap of ~1e27
    assert ref_nn.relative_gap(torch.tensor([1e-3, 1.0, inf, 2.0]), ref) \
        > 1e20


def test_pose_errors():
    T = np.eye(4)
    c, s = math.cos(math.radians(3)), math.sin(math.radians(3))
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.3, 0.4, 0.0]
    rot, trans = pose_errors(T, np.eye(4))
    assert rot == pytest.approx(3.0)
    assert trans == pytest.approx(0.5)
    T[0, 0] = np.nan
    assert pose_errors(T, np.eye(4)) == (math.inf, math.inf)
