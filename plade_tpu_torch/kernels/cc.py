"""Morphological close + connected-component labelling: the CUDA kernel and
its plain version.

``close_and_label_lanes`` (K3) and ``close_and_label`` (K3', its L = 1 call)
replace the Pallas kernels of ``plade_tpu/kernels/cc.py``.  CUDA tensors go
to the hand-written kernel (``csrc/cc.cu``), CPU tensors to the plain
PyTorch version in this module; any other device raises, and there is no
fallback from one to the other.

Per lane, a (G, G) grid of occupancy counts is closed with the cross
structuring element (dilate with out-of-grid 0, erode with out-of-grid 1,
union with the occupied cells), then labelled by ``iters`` Jacobi rounds of
3 x 3 min-label propagation from ``r * G + c`` on closed cells; cells
outside the close hold ``G * G``.  Once converged, a cell's label is the
minimum flat index of its 8-connected component.  The plain version runs
exactly ``iters`` rounds; the kernel stops at the first round that changes
nothing, which returns the same labels bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import LAUNCHES

#: largest grid side the kernel takes (it packs labels <= G * G into 16-bit
#: halves; G = 32 and 64 are specialised, other sides run the G = 128
#: layout)
MAX_GRID = 128


def _shift(x: torch.Tensor, dr: int, dc: int, fill: int) -> torch.Tensor:
    """``y[r, c] = x[r - dr, c - dc]`` over the last two axes, ``fill``
    where that falls outside the grid (the Pallas kernel's ``sh``)."""
    G0, G1 = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 - dr:1 - dr + G0, 1 - dc:1 - dc + G1]


def close_and_label_lanes_plain(occ_counts: torch.Tensor,
                                iters: int = 256) -> torch.Tensor:
    """Plain PyTorch K3: (L, G, G) int32 counts -> (L, G, G) int32 labels,
    exactly ``iters`` propagation rounds."""
    L, G, _ = occ_counts.shape
    inf = G * G
    filled = torch.clamp(occ_counts.to(torch.int32), max=1)
    dil = filled
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        dil = torch.maximum(dil, _shift(filled, dr, dc, 0))
    ero = dil
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ero = torch.minimum(ero, _shift(dil, dr, dc, 1))
    closed = torch.maximum(ero, filled) > 0
    idx = torch.arange(inf, dtype=torch.int32,
                       device=occ_counts.device).reshape(G, G)
    lab = torch.where(closed, idx, inf)
    for _ in range(iters):
        # separable 3x3 box min == 8 neighbours + self
        m = torch.minimum(lab, torch.minimum(_shift(lab, 1, 0, inf),
                                             _shift(lab, -1, 0, inf)))
        m = torch.minimum(m, torch.minimum(_shift(m, 0, 1, inf),
                                           _shift(m, 0, -1, inf)))
        lab = torch.where(closed, m, inf)
    return lab


def close_and_label_lanes(occ_counts: torch.Tensor,
                          iters: int = 256) -> torch.Tensor:
    """(L, G, G) int32 occupancy counts (>= 0) -> (L, G, G) int32 labels,
    all lanes in one kernel launch; see the module docstring."""
    if occ_counts.dim() != 3 or occ_counts.shape[1] != occ_counts.shape[2]:
        raise ValueError("close_and_label_lanes: expected (L, G, G), got "
                         f"{tuple(occ_counts.shape)}")
    if occ_counts.dtype != torch.int32:
        raise TypeError("close_and_label_lanes: expected int32, got "
                        f"{occ_counts.dtype}")
    if iters < 0:
        raise ValueError("close_and_label_lanes: iters must be >= 0")
    dev = occ_counts.device
    if dev.type == "cpu":
        return close_and_label_lanes_plain(occ_counts, iters)
    if dev.type != "cuda":
        raise ValueError(f"close_and_label_lanes: unsupported device {dev}")
    L, G, _ = occ_counts.shape
    if G > MAX_GRID:
        raise ValueError(f"close_and_label_lanes: grid {G} > {MAX_GRID}")
    from .build import library
    occ = occ_counts.contiguous()
    out = torch.empty_like(occ)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().plade_close_and_label(occ.data_ptr(), out.data_ptr(),
                                              L, G, int(iters), stream)
    if err != 0:
        raise RuntimeError("close_and_label_lanes: CUDA launch failed with "
                           f"error {err}")
    LAUNCHES["close_and_label_lanes"] += 1
    return out


def close_and_label(occ_counts: torch.Tensor, iters: int = 256
                    ) -> torch.Tensor:
    """(G, G) int32 occupancy counts -> (G, G) int32 component labels: the
    L = 1 call of :func:`close_and_label_lanes`."""
    if occ_counts.dim() != 2:
        raise ValueError("close_and_label: expected (G, G), got "
                         f"{tuple(occ_counts.shape)}")
    return close_and_label_lanes(occ_counts[None], iters)[0]
