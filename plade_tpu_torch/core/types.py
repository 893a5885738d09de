"""Fixed-shape containers for the registration pipeline (NamedTuples of
tensors), mirroring ``plade_tpu/core/types.py``.

Every container is a ``(data, mask/count)`` pair padded to a static size,
with the same conventions as the reference package (the shapes below are
one pair's; the batched pipeline adds a leading axis of pairs or clouds to
every field, and ``mask`` follows it): padded points sit at
``BIG``, counts are 0-d int32 tensors on the data's device, and ``mask`` is
``arange(n) < count``.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils import timing

#: sentinel coordinate for padded points — far outside any scene
BIG = 1.0e8

#: host reads of device values made through ``host_value`` and
#: ``host_tensors``; a run resets it and reads it to count its host syncs (the
#: shards of a mesh read from threads of their own, hence the lock)
HOST_SYNCS = {"count": 0}
_SYNCS_LOCK = threading.Lock()


def _count_read():
    with _SYNCS_LOCK:
        HOST_SYNCS["count"] += 1
    timing.host_read()


def host_value(t: torch.Tensor):
    """The Python value of a tensor (a number for a 0-d tensor, else a
    list); counts one host sync."""
    _count_read()
    return t.tolist()


def host_tensors(tensors) -> list[torch.Tensor]:
    """CPU copies of float32, int32 and bool tensors on one device, in one
    host sync: packed into one float64 buffer there (a float32 as the
    int32 of its bits, so every bit stays), copied, then split and cast
    back to each tensor's shape and dtype."""
    tensors = list(tensors)
    if any(t.dtype not in (torch.float32, torch.int32, torch.bool)
           for t in tensors):
        raise TypeError("host_tensors: float32, int32 and bool only")
    _count_read()
    flat = torch.cat([(t.view(torch.int32) if t.is_floating_point() else t)
                      .reshape(-1).to(torch.float64) for t in tensors]).cpu()
    return [(p.to(torch.int32).view(torch.float32) if t.is_floating_point()
             else p.to(t.dtype)).reshape(t.shape)
            for p, t in zip(flat.split([t.numel() for t in tensors]),
                            tensors)]


def _mask(n: int, count: torch.Tensor) -> torch.Tensor:
    """``arange(n) < count`` along a last axis, for ``count`` of any leading
    shape (a leading axis of pairs or clouds)."""
    return torch.arange(n, device=count.device) < count[..., None]


class Cloud(NamedTuple):
    """A padded point cloud. ``points[i]`` valid iff ``i < count``."""
    points: torch.Tensor    # (N, 3) float32
    normals: torch.Tensor   # (N, 3) float32 (zeros if absent)
    count: torch.Tensor     # () int32

    @property
    def mask(self) -> torch.Tensor:
        return _mask(self.points.shape[-2], self.count)


class PlaneSet(NamedTuple):
    """Extracted planes, padded to ``max_planes``; ``coeffs[k] = (n, d)``
    with unit normal and ``n.x + d = 0``; ``point_plane`` maps each cloud
    point to its plane id (-1 = none)."""
    coeffs: torch.Tensor       # (P, 4) float32
    sizes: torch.Tensor        # (P,) int32
    count: torch.Tensor        # () int32
    point_plane: torch.Tensor  # (N,) int32

    @property
    def mask(self) -> torch.Tensor:
        return _mask(self.coeffs.shape[-2], self.count)


class PlaneGeometry(NamedTuple):
    """Per-plane derived geometry: downsampled in-plane points, the four
    OBB corners projected to the plane, and their bounding circle."""
    ds_points: torch.Tensor   # (P, M, 3) float32 (BIG-padded)
    ds_counts: torch.Tensor   # (P,) int32
    corners: torch.Tensor     # (P, 4, 3) float32
    centers: torch.Tensor     # (P, 3) float32
    radii: torch.Tensor       # (P,) float32


class LineSet(NamedTuple):
    """Plane-pair intersection lines, padded to ``max_lines``."""
    direction: torch.Tensor  # (L, 3) float32 unit
    point: torch.Tensor      # (L, 3) float32
    support: torch.Tensor    # (L, 2) int32
    count: torch.Tensor      # () int32

    @property
    def mask(self) -> torch.Tensor:
        return _mask(self.direction.shape[-2], self.count)


class PairDescriptors(NamedTuple):
    """8-D pair-line descriptors, one row per retained line pair."""
    desc: torch.Tensor       # (Q, 8) float32
    line_vec1: torch.Tensor  # (Q, 3) float32
    line_vec2: torch.Tensor  # (Q, 3) float32
    anchor: torch.Tensor     # (Q, 3) float32
    line_idx: torch.Tensor   # (Q, 2) int32
    count: torch.Tensor      # () int32

    @property
    def mask(self) -> torch.Tensor:
        return _mask(self.desc.shape[-2], self.count)


class PoseSet(NamedTuple):
    """A batch of rigid transform hypotheses."""
    R: torch.Tensor      # (H, 3, 3) float32
    t: torch.Tensor      # (H, 3) float32
    valid: torch.Tensor  # (H,) bool


class RegistrationResult(NamedTuple):
    """Output of one pair registration; see ``plade_tpu/core/types.py`` for
    the meaning of ``score``/``overlap`` and the three truncation
    counters (non-zero means a static budget dropped work)."""
    transform: torch.Tensor        # (4, 4) float32 — source -> target
    score: torch.Tensor            # () float32
    overlap: torch.Tensor          # () float32
    matched_planes: torch.Tensor   # () int32
    success: torch.Tensor          # () bool
    match_saturated: torch.Tensor  # () int32
    pen_overflow: torch.Tensor     # () int32
    cluster_truncated: torch.Tensor  # () int32


def _host(x) -> torch.Tensor:
    """CPU tensor of a numpy array (copied: it may be read-only) or of a
    tensor on any device."""
    return x.detach().cpu() if torch.is_tensor(x) \
        else torch.from_numpy(np.array(x))


def pad_cloud(points, normals, size: int, device) -> Cloud:
    """Pad (n, 3) points/normals (numpy arrays or tensors) into a Cloud of
    ``size`` rows on ``device``."""
    n = points.shape[0]
    if n > size:
        raise ValueError(f"cloud has {n} points > padded size {size}")
    pts = torch.full((size, 3), BIG, dtype=torch.float32)
    pts[:n] = _host(points)
    nm = torch.zeros((size, 3), dtype=torch.float32)
    if normals is not None:
        nm[:n] = _host(normals)
    return Cloud(points=pts.to(device), normals=nm.to(device),
                 count=torch.full((), n, dtype=torch.int32, device=device))


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 homogeneous transforms from R (..., 3, 3) and t
    (..., 3)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
