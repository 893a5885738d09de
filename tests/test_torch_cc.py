"""K3/K3' (``plade_tpu_torch/kernels/cc.py``) and the CC trim around them on
the CPU, against the reference package.

* The plain K3 against ``close_and_label_lanes(interpret=True)`` (the
  Pallas kernel run on the CPU) at L = 11, G = 64 and 48, with 256 and 8
  rounds, on random grids, an empty and a full grid, a serpentine grid
  that 256 rounds leave unconverged and the grids built to break the CUDA
  kernel's strips and words (``cc_grids.edge_grids``); K3' against
  ``close_and_label(interpret=True)`` and a numpy flood fill.  Labels are
  integers: exact.
* ``_trim_bitmap``, ``_trim_select`` and ``_largest_component_masks``
  against the reference's, the reference side assembled as
  ``_trim_bitmap`` -> ``close_and_label_lanes(interpret=True)`` ->
  ``_trim_select`` so that both sides label with K3's semantics.  Exact.

CPU tensors never count a kernel launch.  The CUDA kernel runs only on a
card (``tests/test_torch_cuda.py``)."""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cc_grids
from plade_tpu.extract import ransac as jr
from plade_tpu.kernels import cc as jcc
from plade_tpu_torch.extract import ransac
from plade_tpu_torch.kernels import cc
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

G = 64


@pytest.fixture(autouse=True)
def _no_launches():
    before = dict(cc.LAUNCHES)
    yield
    assert cc.LAUNCHES == before, "a CPU tensor counted a kernel launch"


@pytest.mark.parametrize("G", [64, 48])
@pytest.mark.parametrize("iters", [256, 8])
def test_close_and_label_lanes_plain_matches_pallas(iters, G):
    """The serpentine, empty and full grids, the edge grids of
    ``cc_grids.edge_grids`` and three random grids; G = 48 is a side the
    CUDA kernel takes through its generic instance."""
    occ = cc_grids.grids(11, G, seed=iters)
    want = np.asarray(jcc.close_and_label_lanes(jnp.asarray(occ), iters=iters,
                                                interpret=True))
    got = cc.close_and_label_lanes(torch.from_numpy(occ), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cc.close_and_label_lanes_plain(torch.from_numpy(occ), iters).numpy(),
        want)


def test_serpentine_is_unconverged_at_256_rounds():
    occ = torch.from_numpy(cc_grids.serpentine(G))[None]
    at_256 = cc.close_and_label_lanes(occ, 256)
    converged = cc.close_and_label_lanes(occ, 1200)
    assert not torch.equal(at_256, converged)
    # converged: one component, labelled by its minimum flat index 0
    closed = converged < G * G
    assert (converged[closed] == 0).all()


def _flood_fill_labels(occ):
    """The close (cross dilate, cross erode, union) and 8-connected
    component labels by BFS: component-min flat index, G*G outside."""
    def cross(b, op, pad_val):
        p = np.pad(b, 1, constant_values=pad_val)
        return op.reduce([b, p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2],
                          p[1:-1, 2:]])
    dil = cross(occ > 0, np.logical_or, False)
    closed = cross(dil, np.logical_and, True) | (occ > 0)
    expect = np.full((G, G), G * G, np.int32)
    seen = np.zeros((G, G), bool)
    for r in range(G):
        for c in range(G):
            if not closed[r, c] or seen[r, c]:
                continue
            comp = []
            dq = deque([(r, c)])
            seen[r, c] = True
            while dq:
                y, x = dq.popleft()
                comp.append((y, x))
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        yy, xx = y + dy, x + dx
                        if 0 <= yy < G and 0 <= xx < G \
                                and closed[yy, xx] and not seen[yy, xx]:
                            seen[yy, xx] = True
                            dq.append((yy, xx))
            m = min(y * G + x for y, x in comp)
            for y, x in comp:
                expect[y, x] = m
    return expect


@pytest.mark.parametrize("density", [0.1, 0.25, 0.5])
def test_close_and_label_matches_pallas_and_flood_fill(rng, density):
    occ = (rng.random((G, G)) < density).astype(np.int32)
    got = cc.close_and_label(torch.from_numpy(occ), 256).numpy()
    want = np.asarray(jcc.close_and_label(jnp.asarray(occ), iters=256,
                                          interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _flood_fill_labels(occ))


def test_close_and_label_validates_inputs():
    with pytest.raises(TypeError):
        cc.close_and_label_lanes(torch.zeros((2, 8, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        cc.close_and_label_lanes(torch.zeros((2, 8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        cc.close_and_label(torch.zeros((1, 8, 8), dtype=torch.int32))


def _trim_case(rng, N=3000, A=6):
    """Per lane: points in two clusters far apart in the plane (two
    components after the close) plus scattered points, with random inlier
    masks of different densities; lane 0 has no inlier."""
    a = rng.normal(scale=0.3, size=(N // 2, A, 2))
    b = rng.normal(scale=0.2, size=(N - N // 2, A, 2)) + np.array([4.0, 1.0])
    uv = np.concatenate([a, b]).astype(np.float32)
    uv[::7] = rng.uniform(-2, 6, size=uv[::7].shape)
    inl = rng.random((N, A)) < np.linspace(0.0, 0.9, A)[None, :]
    return uv, inl


def _jax_trim(uv, inl, cell, t_sub, iters):
    """The reference's trim with K3's labelling: _trim_bitmap ->
    close_and_label_lanes(interpret=True) -> _trim_select (vmapped per
    lane, as _largest_component_masks)."""
    occ, flat = jax.vmap(
        lambda u, i: jr._trim_bitmap(u, i, cell, G, t_sub),
        in_axes=1)(jnp.asarray(uv), jnp.asarray(inl))
    A = occ.shape[0]
    labels = jcc.close_and_label_lanes(occ.reshape(A, G, G), iters=iters,
                                       interpret=True).reshape(A, G * G)
    kept = jax.vmap(lambda o, la, fl, i: jr._trim_select(o, la, fl, i, G),
                    in_axes=(0, 0, 0, 1), out_axes=1)(
        occ, labels, flat, jnp.asarray(inl))
    return tuple(np.array(x) for x in (occ, flat, labels, kept))


@pytest.mark.parametrize("cell,t_sub", [(0.05, 1), (0.05, 3), (0.001, 1)])
def test_trim_helpers_match_reference(rng, cell, t_sub):
    uv, inl = _trim_case(rng)
    j_occ, j_flat, j_lab, j_kept = _jax_trim(uv, inl, np.float32(cell),
                                             t_sub, 256)
    tuv, tinl = torch.from_numpy(uv), torch.from_numpy(inl)
    occ, flat = ransac._trim_bitmap(tuv.transpose(0, 1), tinl.T,
                                    torch.tensor(cell), G, t_sub)
    np.testing.assert_array_equal(occ.numpy(), j_occ)
    np.testing.assert_array_equal(flat.numpy(), j_flat)
    kept = ransac._trim_select(occ, torch.from_numpy(j_lab), flat, tinl.T, G)
    np.testing.assert_array_equal(kept.T.numpy(), j_kept)
    masks = ransac._largest_component_masks(tuv, tinl, torch.tensor(cell), G,
                                            t_sub, 256)
    np.testing.assert_array_equal(masks.numpy(), j_kept)
    # the trim keeps one component of every lane with inliers
    assert masks.numpy()[:, 1:].any(0).all() and not masks.numpy()[:, 0].any()
