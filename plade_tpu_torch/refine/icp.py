"""Point-to-plane ICP refinement (``plade_tpu/refine/icp.py``), batched over
poses.

The reference vmaps ``refine_icp`` over the rescore's pose modes.  Here the
modes are a leading batch axis written out: every nearest-neighbour pass
concatenates all modes' transformed source points against the shared
target, so one pass is one K2 launch, and the 6x6 Gauss-Newton systems and
3x3 SVD projections are batched ``torch.linalg`` calls.
"""
from __future__ import annotations

import torch

from ..core.ops import scalar
from ..geometry.transforms import cross
from ..knn.bruteforce import nearest_neighbor


def _orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project near-rotations (..., 3, 3) onto SO(3) (SVD; det-corrected)."""
    U, _, Vt = torch.linalg.svd(R)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], dim=-1))
    return U @ D @ Vt


def _skew(w):
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def _correspond(R, t, src_points, tgt_points):
    """Transformed sources (B, S, 3) and, per point, the squared distance
    and index of its nearest target point: one K2 pass for all B poses."""
    B, S = R.shape[0], src_points.shape[0]
    q = torch.einsum("bij,sj->bsi", R, src_points) + t[:, None, :]
    d2, idx = nearest_neighbor(q.reshape(B * S, 3).contiguous(), tgt_points)
    return q, d2.reshape(B, S), idx.reshape(B, S).to(torch.int64)


def refine_icp(R0, t0, src_points, src_mask, tgt_points, tgt_normals,
               max_corr, iters: int = 20):
    """Refine poses so that R s + t aligns src onto tgt.

    R0: (B, 3, 3), t0: (B, 3); src_points: (S, 3) BIG-padded;
    tgt_points/normals: (D, 3) BIG-padded with zero normals on padded rows.
    Returns (R (B,3,3), t (B,3), rmse (B,), inlier_count (B,))."""
    max_corr2 = scalar(max_corr, R0.device) ** 2
    eye3 = torch.eye(3, dtype=torch.float32, device=R0.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=R0.device)
    R, t = R0, t0
    for _ in range(iters):
        q, d2, idx = _correspond(R, t, src_points, tgt_points)
        valid = src_mask[None, :] & (d2 <= max_corr2)
        nq = tgt_normals[idx]                               # (B, S, 3)
        pq = tgt_points[idx]
        r = torch.sum(nq * (q - pq), dim=-1)                # (B, S)
        # J = [ (q x n) ; n ] for twist [w; v]
        J = torch.cat([cross(q, nq), nq], dim=-1)           # (B, S, 6)
        w = valid.to(torch.float32)
        A = (J * w[..., None]).transpose(1, 2) @ J          # (B, 6, 6)
        b = -(J * (w * r)[..., None]).sum(dim=1)            # (B, 6)
        A = A + 1e-6 * eye6
        x = torch.linalg.solve(A, b)
        dR = _orthonormalize(eye3 + _skew(x[:, :3]))
        dt = x[:, 3:]
        R, t = (_orthonormalize(dR @ R),
                torch.einsum("bij,bj->bi", dR, t) + dt)

    q, d2, idx = _correspond(R, t, src_points, tgt_points)
    valid = src_mask[None, :] & (d2 <= max_corr2)
    nq = tgt_normals[idx]
    r = torch.sum(nq * (q - tgt_points[idx]), dim=-1)
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w, dim=1), min=1.0)
    rmse = torch.sqrt(torch.sum(w * r * r, dim=1) / n)
    return R, t, rmse, torch.sum(valid.to(torch.int32), dim=1)
