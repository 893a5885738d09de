"""PCA-oriented bounding boxes over masked point sets
(``plade_tpu/geometry/obb.py``); corner order as in the reference
(util.h:226-233)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .eig3 import sym_eigh3
from .transforms import cross


class OBB(NamedTuple):
    center: torch.Tensor   # (..., 3) world-space box center
    axes: torch.Tensor     # (..., 3, 3) columns = eigenvectors (ascending)
    extents: torch.Tensor  # (..., 3) width (x), depth (y), height (z)
    corners: torch.Tensor  # (..., 8, 3) world-space corners
    radius: torch.Tensor   # (...,) = max extent / 2


def masked_mean(points, mask):
    w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    return torch.sum(points * w[..., None], dim=-2) / n


def compute_obb(points: torch.Tensor, mask: torch.Tensor) -> OBB:
    """PCA OBB of the masked points. Batched over leading dims."""
    centroid = masked_mean(points, mask)
    w = mask.to(points.dtype)
    c = (points - centroid[..., None, :]) * w[..., None]
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    cov = torch.einsum("...ni,...nj->...ij", c, c) / n[..., None, None]
    _, vecs = sym_eigh3(cov)
    # force a right-handed frame: col2 = col0 x col1 (util.h:201)
    e0 = vecs[..., :, 0]
    e1 = vecs[..., :, 1]
    e2 = cross(e0, e1)
    axes = torch.stack([e0, e1, e2], dim=-1)
    local = torch.einsum("...ij,...nj->...ni", axes.transpose(-1, -2),
                         points - centroid[..., None, :])
    big = 1e30
    lmin = torch.amin(torch.where(mask[..., None], local, big), dim=-2)
    lmax = torch.amax(torch.where(mask[..., None], local, -big), dim=-2)
    extents = lmax - lmin
    mean_diag = 0.5 * (lmin + lmax)
    center = torch.einsum("...ij,...j->...i", axes, mean_diag) + centroid
    x, y, z = lmin[..., 0], lmin[..., 1], lmin[..., 2]
    wd, dp, ht = extents[..., 0], extents[..., 1], extents[..., 2]
    corners_local = torch.stack([
        torch.stack([x, y, z], -1),
        torch.stack([x, y + dp, z], -1),
        torch.stack([x, y + dp, z + ht], -1),
        torch.stack([x, y, z + ht], -1),
        torch.stack([x + wd, y, z + ht], -1),
        torch.stack([x + wd, y + dp, z], -1),
        torch.stack([x + wd, y, z], -1),
        torch.stack([x + wd, y + dp, z + ht], -1),
    ], dim=-2)
    corners = torch.einsum("...ij,...nj->...ni", axes, corners_local) \
        + centroid[..., None, :]
    radius = torch.amax(extents, dim=-1) / 2.0
    return OBB(center=center, axes=axes, extents=extents, corners=corners,
               radius=radius)
