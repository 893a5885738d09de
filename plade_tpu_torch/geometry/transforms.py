"""SE(3) utilities (``plade_tpu/geometry/transforms.py``): closed-form
rotation from two direction pairs and Euler angles."""
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
