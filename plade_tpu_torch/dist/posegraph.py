"""Global pose-graph synchronization over pairwise registrations
(``plade_tpu/dist/posegraph.py``).

The reference registers each pair independently and stops (batch mode,
code/PLADE/main.cpp:97-158); multi-scan scenes get no global consistency.
Given pairwise estimates ``T_ij`` (mapping scan j's frame into scan i's
frame) with confidence weights, this recovers world-from-scan poses
``(R_k, t_k)`` for all K scans, in float32 on the graph's device:

1. **Rotation synchronization** (spectral): the symmetric 3K x 3K block
   matrix A with A[i,j] = w_ij R_ij, A[j,i] = w_ij R_ij^T and A[k,k] = d_k I;
   its top-3 eigenvectors stack into 3x3 blocks that are projected to SO(3)
   per scan (SVD) — the eigenvector relaxation of rotation averaging
   (Singer 2011; Arie-Nachimson et al., 3DIMPVT 2012).
2. **Translation least squares**: with rotations fixed, each edge gives
   the linear constraint t_j - t_i = R_i t_ij; the weighted normal
   equations are solved with the gauge t_0 = 0.

Identity convention: p_world = R_k p_k + t_k, and pairwise
p_i = R_ij p_j + t_ij, so consistency means R_j = R_i R_ij and
t_j = R_i t_ij + t_i.

Edges are padded fixed-size tensors with a weight of 0 for padding.  The
eigen-decomposition, SVDs, determinants and the solve are ``torch.linalg``
calls, as the original's are ``jnp.linalg`` calls outside any kernel.
``eigh`` may return another sign or basis of the top-3 eigenspace than the
original's LAPACK call; the gauge fix (polar projection, a common det flip,
scan 0 as the frame) makes the poses unique, so they are what
``tests/test_torch_posegraph.py`` compares.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.ops import index_sum
from ..pipeline import _run_device


class PoseGraph(NamedTuple):
    """Padded edge list: edge e maps scan src[e]'s frame into scan dst[e]'s
    frame by (R[e], t[e]) — dst is the registration target, src the
    source."""
    dst: torch.Tensor       # (E,) int64
    src: torch.Tensor       # (E,) int64
    R: torch.Tensor         # (E, 3, 3) float32
    t: torch.Tensor         # (E, 3)
    weight: torch.Tensor    # (E,) float32 (0 = padded/invalid edge)


def _project_so3(M):
    """Closest rotation(s) to (..., 3, 3) in Frobenius norm via SVD."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def synchronize(graph: PoseGraph, num_scans: int):
    """Solve the pose graph; returns (R (K,3,3), t (K,3)) on the graph's
    device, with scan 0 as the gauge (R_0 = I, t_0 = 0)."""
    K = num_scans
    dev = graph.R.device
    w = graph.weight
    i, j = graph.dst, graph.src

    # ---- rotation synchronization ----
    # accumulating scatters: a scan is the end of several edges, padded
    # edges all sit at (0, 0), and a pair may be given twice
    wR = w[:, None, None] * graph.R
    A = torch.zeros((K, K, 3, 3), dtype=torch.float32, device=dev)
    A.index_put_((i, j), wR, accumulate=True)
    A.index_put_((j, i), wR.transpose(-1, -2), accumulate=True)
    deg = index_sum(index_sum(torch.zeros((K,), dtype=torch.float32,
                                          device=dev), i, w), j, w)
    ar = torch.arange(K, device=dev)
    A[ar, ar] += torch.eye(3, device=dev) * torch.clamp(deg, min=1e-6)[
        :, None, None]
    Af = A.permute(0, 2, 1, 3).reshape(3 * K, 3 * K)
    _, vecs = torch.linalg.eigh(Af)                # ascending eigenvalues
    V = vecs[:, -3:].reshape(K, 3, 3)              # top-3 eigvec blocks
    # With X_k = R_k^T the stacked X satisfies A X = X Lambda, so
    # V_k ~ R_k^T Q for one global orthogonal Q.  Project each block to O(3)
    # (polar factor), flip all dets together if Q landed in the det=-1
    # component, then undo the transpose; the remaining left gauge Q^T
    # cancels in the R_0-relative fix below.
    U, _, Vt = torch.linalg.svd(V)
    P = U @ Vt                                     # (K, 3, 3) in O(3)
    flip = torch.sign(torch.sum(torch.linalg.det(P)))
    F = torch.diag(torch.stack([torch.ones_like(flip), torch.ones_like(flip),
                                torch.where(flip == 0, 1.0, flip)]))
    P = P @ F
    Rhat = P.transpose(-1, -2)                     # ~ Q^T R_k
    R = torch.einsum("ij,kjl->kil", Rhat[0].T, Rhat)  # R_0-relative gauge

    # ---- translation least squares (gauge t_0 = 0) ----
    # edge residual: t_j - t_i - R_i t_ij = 0
    E = graph.t.shape[0]
    rhs = torch.einsum("eij,ej->ei", R[i], graph.t)          # (E, 3)
    # incidence built densely: rows = E, cols = K
    rows = torch.arange(E, device=dev)
    M = torch.zeros((E, K), dtype=torch.float32, device=dev)
    M.index_put_((rows, j), torch.ones(E, device=dev), accumulate=True)
    M.index_put_((rows, i), torch.full((E,), -1.0, device=dev),
                 accumulate=True)
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    Mw = M * sw[:, None]
    bw = rhs * sw[:, None]
    Mg = Mw[:, 1:]                                 # drop the gauge column
    AtA = Mg.T @ Mg + 1e-6 * torch.eye(K - 1, device=dev)
    Atb = Mg.T @ bw
    t_rest = torch.linalg.solve(AtA, Atb)                    # (K-1, 3)
    t = torch.cat([torch.zeros((1, 3), device=dev), t_rest], dim=0)
    return R, t


def residuals(graph: PoseGraph, R, t):
    """Per-edge (rotation angle deg, translation norm) residuals."""
    i, j = graph.dst, graph.src
    Rp = torch.einsum("eab,ebc->eac", R[i], graph.R)         # predicted R_j
    cosang = (torch.einsum("eab,eab->e", Rp, R[j]) - 1.0) / 2.0
    ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    tp = torch.einsum("eab,eb->ea", R[i], graph.t) + t[i]    # predicted t_j
    terr = torch.linalg.vector_norm(tp - t[j], dim=-1)
    return ang, terr


def from_edges(edges, num_scans: int, max_edges: int | None = None,
               device=None) -> PoseGraph:
    """Build a padded PoseGraph on ``device`` (by default CUDA;
    ``device="cpu"`` for the CPU) from a python list of
    (dst, src, T (4,4) array-like, weight).  ``num_scans`` is the caller's
    scan count, which :func:`synchronize` takes."""
    device = _run_device(device)
    E = max_edges or len(edges)
    dst = np.zeros((E,), np.int64)
    src = np.zeros((E,), np.int64)
    R = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    t = np.zeros((E, 3), np.float32)
    w = np.zeros((E,), np.float32)
    for e, (d, s, T, wt) in enumerate(edges[:E]):
        T = np.asarray(T, np.float32)
        dst[e], src[e] = d, s
        R[e] = T[:3, :3]
        t[e] = T[:3, 3]
        w[e] = wt
    return PoseGraph(*(torch.from_numpy(x).to(device)
                       for x in (dst, src, R, t, w)))
