"""Closed-form symmetric 3x3 eigendecomposition (``plade_tpu/geometry/
eig3.py``).

The trigonometric closed form (Smith 1961) with eigenvectors from cross
products of rows of (A - lambda I).  It is ported as written rather than
replaced by ``torch.linalg.eigh``: the eigenvector order and signs it picks
feed the OBB corners, and through them the per-plane quads of the
penetration test, and the RANSAC refit's plane normals.
"""
from __future__ import annotations

import math

import torch

from .transforms import cross

_EPS = 1e-20


def sym_eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) matrices."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric (..., 3, 3) A for eigenvalue lam: the
    largest cross product of two rows of (A - lam I), with the reference's
    per-matrix fallback for a repeated eigenvalue."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = cross(r0, r1)
    c02 = cross(r0, r2)
    c12 = cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where((n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    nb = torch.clamp(torch.sum(best * best, dim=-1, keepdim=True), min=0.0)
    rnorm2 = torch.sum(B * B, dim=-1)                       # (..., 3) rows
    row = torch.argmax(rnorm2, dim=-1)                      # first max
    w = torch.take_along_dim(
        B, row[..., None, None].expand(*row.shape, 1, 3), dim=-2)[..., 0, :]
    wn2 = torch.clamp(torch.sum(w * w, dim=-1, keepdim=True), min=_EPS)
    axis = torch.argmin(torch.abs(w), dim=-1)               # first min
    e = (axis[..., None] == torch.arange(3, device=A.device)).to(A.dtype)
    fb = e - (torch.sum(e * w, dim=-1, keepdim=True) / wn2) * w
    fbn = torch.clamp(torch.linalg.vector_norm(fb, dim=-1, keepdim=True),
                      min=_EPS)
    fallback = fb / fbn
    ok = nb > 1e-30
    return torch.where(ok, best / torch.sqrt(torch.where(ok, nb, 1.0)),
                       fallback)


def sym_eigh3(A: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric
    (..., 3, 3) matrices; the basis is exactly orthonormal."""
    vals = sym_eigvals3(A)
    v_lo = _eigvec(A, vals[..., 0])
    v_hi = _eigvec(A, vals[..., 2])
    proj = v_hi - torch.sum(v_hi * v_lo, dim=-1, keepdim=True) * v_lo
    pn = torch.sum(proj * proj, dim=-1, keepdim=True)
    ex = torch.zeros_like(v_lo)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v_lo)
    ey[..., 1] = 1.0
    alt = cross(v_lo, torch.where(torch.abs(v_lo[..., :1]) < 0.9, ex, ey))
    alt = alt / torch.clamp(torch.linalg.vector_norm(alt, dim=-1,
                                                     keepdim=True), min=1e-20)
    ok = pn > 1e-24
    v_hi = torch.where(ok, proj / torch.sqrt(torch.where(ok, pn, 1.0)), alt)
    v_mid = cross(v_hi, v_lo)
    vecs = torch.stack([v_lo, v_mid, v_hi], dim=-1)   # columns
    return vals, vecs


def smallest_eigvec3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue (plane-fit normal)."""
    vals = sym_eigvals3(A)
    return _eigvec(A, vals[..., 0])
