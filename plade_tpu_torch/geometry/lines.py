"""Line geometry (``plade_tpu/geometry/lines.py``): plane-plane
intersections, line-line closest points, projection onto a plane.  All
functions broadcast over leading batch dimensions."""
from __future__ import annotations

import torch

from .transforms import cross, normalize

_EPS = 1e-12


def intersect_planes(coeffs1: torch.Tensor, coeffs2: torch.Tensor,
                     max_cos: float = 0.95):
    """Intersection line of two planes (nx, ny, nz, d) with n.x+d=0.

    Returns (direction, point, valid); valid is False for near-parallel
    pairs (|n1.n2| > ``max_cos``, util.cpp:634)."""
    n1 = normalize(coeffs1[..., :3])
    n2 = normalize(coeffs2[..., :3])
    d1 = coeffs1[..., 3]
    d2 = coeffs2[..., 3]
    dot = torch.sum(n1 * n2, dim=-1)
    valid = torch.abs(dot) <= max_cos
    u = cross(n1, n2)
    u2 = torch.clamp(torch.sum(u * u, dim=-1, keepdim=True), min=_EPS)
    p = (-d1[..., None] * cross(n2, u) - d2[..., None] * cross(u, n1)) / u2
    direction = normalize(u)
    return direction, p, valid


def closest_points_two_lines(u1, p1, u2, p2):
    """Closest points between lines (p1 + s u1) and (p2 + t u2).

    Returns (point1, point2, distance); near-parallel lines fall back to
    the projection of p2's offset."""
    u1n = normalize(u1)
    u2n = normalize(u2)
    w0 = p1 - p2
    b = torch.sum(u1n * u2n, dim=-1)
    d = torch.sum(u1n * w0, dim=-1)
    e = torch.sum(u2n * w0, dim=-1)
    denom = 1.0 - b * b
    parallel = denom < 1e-9
    safe = torch.where(parallel, 1.0, denom)
    s = torch.where(parallel, 0.0, (b * e - d) / safe)
    t = torch.where(parallel, -e, (e - b * d) / safe)
    point1 = p1 + s[..., None] * u1n
    point2 = p2 + t[..., None] * u2n
    dist = torch.linalg.vector_norm(point1 - point2, dim=-1)
    return point1, point2, dist


def project_points_to_plane(points, coeffs):
    """Orthogonal projection of points onto plane (n, d) with n.x+d=0
    (ProjectPoints2Plane, util.h:292-329)."""
    n = coeffs[..., :3]
    d = coeffs[..., 3]
    n2 = torch.clamp(torch.sum(n * n, dim=-1), min=_EPS)
    k = -(torch.sum(points * n, dim=-1) + d) / n2
    return points + k[..., None] * n
