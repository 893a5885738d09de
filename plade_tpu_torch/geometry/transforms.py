"""SE(3) utilities (``plade_tpu/geometry/transforms.py``): closed-form
rotation from two direction pairs, Euler angles, rigid transforms and the
Kabsch fit."""
from __future__ import annotations

import torch

_EPS = 1e-12


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=axis,
                                                    keepdim=True), min=_EPS)


def orthonormal_frame(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Right-handed orthonormal frame (..., 3, 3), columns [e1, e2, e3]:
    e1 along v1, e2 the v1-orthogonal part of v2."""
    e1 = normalize(v1)
    e2 = normalize(v2 - torch.sum(v2 * e1, -1, keepdim=True) * e1)
    e3 = cross(e1, e2)
    return torch.stack([e1, e2, e3], dim=-1)


def rotation_from_two_vecs(src1, src2, dst1, dst2) -> torch.Tensor:
    """Rotation taking direction pair (src1, src2) onto (dst1, dst2)."""
    fs = orthonormal_frame(src1, src2)
    fd = orthonormal_frame(dst1, dst2)
    return fd @ fs.transpose(-1, -2)


def euler_angles(R: torch.Tensor):
    """(roll, pitch, yaw) following pcl::getEulerAngles conventions."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.asin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def apply_rigid(R: torch.Tensor, t: torch.Tensor,
                points: torch.Tensor) -> torch.Tensor:
    """x -> R x + t.  R: (..., 3, 3), t: (..., 3), points: (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights=None):
    """Weighted least-squares rigid transform src -> dst by SVD (Kabsch):
    src/dst (N, 3), ``weights`` (N,) (all ones by default).  Returns (R
    (3, 3), t (3,))."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights), min=_EPS)
    sc = torch.sum(src * w[:, None], dim=0)
    dc = torch.sum(dst * w[:, None], dim=0)
    H = (src - sc).T @ ((dst - dc) * w[:, None])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    S = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ S @ U.T
    return R, dc - R @ sc
