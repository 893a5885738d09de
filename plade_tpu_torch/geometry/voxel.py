"""Fixed-shape voxel-grid downsampling (``plade_tpu/geometry/voxel.py``).

Cells are ordered by a pair of spatial hashes (ties by coordinates), so
that ``max_out`` truncation keeps a spatially uniform subset of cells.  The
order must be the reference's exactly: truncation keeps a prefix of it.

* The hashes are int32 products that wrap in the reference.  Here they are
  computed in int64 and reduced to their low 32 bits as signed values,
  which is the wrapped int32 result without relying on int32 overflow.
* There is no ``lexsort``: :func:`..core.ops.lexsort` does successive
  stable sorts, least significant key first.  The per-plane variant has
  three 32-bit keys, which do not pack into one int64.
* The centroid sums are float scatter-adds (``index_add_``); on the card
  they use atomics, so their summation order, and the last bits of a
  centroid, may differ from run to run.
"""
from __future__ import annotations

import torch

from ..core.ops import drop, flat_rows, lexsort, lift, per_pair, take
from ..core.types import BIG, Cloud

# spatial-hash primes of the reference (Teschner et al. 2003) and its
# independent second hash
_HX, _HY, _HZ = 73856093, 19349663, 83492791
_H2X, _H2Y, _H2Z = 302451781, 160481219, 28411511
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 ``v`` as a signed value (int64 tensor)."""
    v = v & 0xFFFFFFFF
    return torch.where(v > _I32_MAX, v - 2 ** 32, v)


def _cell_hash(ix, iy, iz):
    return _wrap32(ix * _HX) ^ _wrap32(iy * _HY) ^ _wrap32(iz * _HZ)


def _cell_hash2(ix, iy, iz):
    return _wrap32(ix * _H2X) ^ _wrap32(iy * _H2Y) ^ _wrap32(iz * _H2Z)


def _cells(points, pmin, leaf) -> torch.Tensor:
    """(..., N, 3) int64 cell coordinates; values beyond int32 saturate (the
    reference's float -> int32 conversion; only padded rows get there)."""
    f = torch.floor((points - pmin) / leaf)
    return torch.clamp(f, _I32_MIN, _I32_MAX).to(torch.int64)


def _changed(*keys) -> torch.Tensor:
    """Per position along the last axis: the first, or any key differs
    from the previous position's."""
    k0 = keys[0]
    diff = torch.zeros(k0.shape[:-1] + (k0.shape[-1] - 1,), dtype=torch.bool,
                       device=k0.device)
    for k in keys:
        diff |= k[..., 1:] != k[..., :-1]
    return torch.cat([torch.ones(k0.shape[:-1] + (1,), dtype=torch.bool,
                                 device=diff.device), diff], dim=-1)


def _leaf(leaf, B: int, device) -> torch.Tensor:
    """The per-cloud voxel size as (B, 1, 1), broadcasting over (B, N, 3)."""
    return per_pair(leaf, B, device)[:, None, None]


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf,
                     max_out: int, normals: torch.Tensor | None = None
                     ) -> Cloud:
    """Voxel-grid centroid downsample of the masked points, padded to
    ``max_out``; with ``normals``, each voxel carries the normalized mean
    normal of its points.  points (N, 3), mask (N,), or a leading axis of
    B clouds ((B, N, 3), (B, N), ``leaf`` a number or (B,))."""
    single = points.dim() == 2
    if single:
        points, mask, normals = lift((points, mask, normals))
    B, n = mask.shape
    dev = points.device
    pmin = torch.amin(torch.where(mask[..., None], points, 1e30), dim=1)
    ijk = _cells(points, pmin[:, None, :], _leaf(leaf, B, dev))
    arange = torch.arange(n, device=dev)
    ix, iy, iz = ijk[..., 0], ijk[..., 1], ijk[..., 2]
    h = _cell_hash(ix, iy, iz)
    h2 = _cell_hash2(ix, iy, iz)
    key1 = torch.where(mask, h & 0x7FFFFFFF, 0x7FFFFFFF)
    key2 = torch.where(mask, h2, arange)
    order = lexsort((key2, key1))
    sm = torch.gather(mask, 1, order)
    changed = _changed(*(torch.gather(k, 1, order)
                         for k in (key1, key2, ix, iy, iz)))
    seg = torch.cumsum(changed.to(torch.int64), -1) - 1
    count = torch.where(sm.any(-1),
                        torch.amax(torch.where(sm, seg, -1), dim=-1) + 1, 0)
    seg_clip = flat_rows(torch.where(seg < max_out, seg, max_out),
                         max_out + 1)
    sp = take(points, order)
    sums = torch.zeros((B * (max_out + 1), 3), dtype=torch.float32,
                       device=dev).index_add_(
        0, seg_clip, torch.where(sm[..., None], sp, 0.0).reshape(-1, 3)) \
        .reshape(B, max_out + 1, 3)
    cnts = torch.zeros((B * (max_out + 1),), dtype=torch.float32,
                       device=dev).index_add_(
        0, seg_clip, sm.to(torch.float32).reshape(-1)) \
        .reshape(B, max_out + 1)
    centroids = sums[:, :max_out] / torch.clamp(cnts[:, :max_out, None],
                                                min=1.0)
    count = torch.clamp(count, max=max_out)
    valid = torch.arange(max_out, device=dev) < count[:, None]
    out_points = torch.where(valid[..., None], centroids, BIG)
    if normals is not None:
        sn = take(normals, order)
        nsums = torch.zeros((B * (max_out + 1), 3), dtype=torch.float32,
                            device=dev).index_add_(
            0, seg_clip, torch.where(sm[..., None], sn, 0.0).reshape(-1, 3)) \
            .reshape(B, max_out + 1, 3)
        mean_n = nsums[:, :max_out]
        mean_n = mean_n / torch.clamp(
            torch.linalg.vector_norm(mean_n, dim=-1, keepdim=True), min=1e-12)
        out_normals = torch.where(valid[..., None], mean_n, 0.0)
    else:
        out_normals = torch.zeros((B, max_out, 3), dtype=torch.float32,
                                  device=dev)
    out = Cloud(points=out_points, normals=out_normals,
                count=count.to(torch.int32))
    return drop(out) if single else out


def voxel_downsample_by_plane(points: torch.Tensor, mask: torch.Tensor,
                              point_plane: torch.Tensor, leaf,
                              num_planes: int, max_out: int):
    """Per-plane voxel-grid downsample of all planes in one sorted pass.

    Returns (pts (P, max_out, 3) BIG-padded, counts (P,) int32), with a
    leading axis of B clouds when the inputs have one (as
    :func:`voxel_downsample`)."""
    single = points.dim() == 2
    if single:
        points, mask, point_plane = lift((points, mask, point_plane))
    B, n = mask.shape
    dev = points.device
    P = num_planes
    pp = point_plane.to(torch.int64)
    ok = mask & (pp >= 0) & (pp < P)
    pmin = torch.amin(torch.where(ok[..., None], points, 1e30), dim=1)
    ijk = _cells(points, pmin[:, None, :], _leaf(leaf, B, dev))
    arange = torch.arange(n, device=dev)
    kp = torch.where(ok, pp, P)
    kx, ky, kz = ijk[..., 0], ijk[..., 1], ijk[..., 2]
    kh = torch.where(ok, _cell_hash(kx, ky, kz), arange)
    kh2 = torch.where(ok, _cell_hash2(kx, ky, kz), arange)
    order = lexsort((kh2, kh, kp))
    sm = torch.gather(ok, 1, order)
    spl = torch.gather(kp, 1, order)
    changed = _changed(spl, *(torch.gather(k, 1, order)
                              for k in (kh, kh2, kx, ky, kz)))
    seg = torch.cumsum(changed.to(torch.int64), -1) - 1
    # first segment id of each plane -> local cell index within the plane
    plane_of = torch.clamp(spl, max=P)
    first_seg = torch.full((B, P + 1), n, dtype=torch.int64,
                           device=dev).scatter_reduce_(
        1, plane_of, seg, reduce="amin", include_self=True)
    local = seg - torch.gather(first_seg, 1, plane_of)
    flat = flat_rows(torch.where(sm & (local < max_out),
                                 torch.clamp(spl, max=P - 1) * max_out
                                 + local, P * max_out), P * max_out + 1)
    sp = take(points, order)
    sums = torch.zeros((B * (P * max_out + 1), 3), dtype=torch.float32,
                       device=dev).index_add_(
        0, flat, torch.where(sm[..., None], sp, 0.0).reshape(-1, 3)) \
        .reshape(B, P * max_out + 1, 3)
    cnts = torch.zeros((B * (P * max_out + 1),), dtype=torch.float32,
                       device=dev).index_add_(
        0, flat, sm.to(torch.float32).reshape(-1)) \
        .reshape(B, P * max_out + 1)
    centroids = (sums[:, :-1] / torch.clamp(cnts[:, :-1, None], min=1.0)) \
        .reshape(B, P, max_out, 3)
    occupied = (cnts[:, :-1] > 0).reshape(B, P, max_out)
    counts = torch.sum(occupied.to(torch.int32), dim=-1).to(torch.int32)
    pts = torch.where(occupied[..., None], centroids, BIG)
    return (pts[0], counts[0]) if single else (pts, counts)
