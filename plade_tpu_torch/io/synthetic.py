"""Synthetic planar scenes for tests and the chip smoke run.

A numpy-only copy of the scene generators of ``plade_tpu/io/synthetic.py``
(that package imports JAX when it is imported): ``perturb_normals``,
``make_plane_points``, ``make_room``, ``random_rigid`` and
``transform_cloud``, unchanged, so the same seed gives bit-identical
scenes (pinned by ``tests/test_torch_core.py``).

The reference has no test suite (SURVEY section 4); these generators provide
the analytic ground truth its sample data can't: scenes made of known planes
whose extraction, descriptors, and registration transforms can be checked
exactly.
"""
from __future__ import annotations

import numpy as np


def perturb_normals(rng, normals, noise_deg):
    """Rotate each normal by an independent random angle ~ N(0, noise_deg)
    about a random tangent axis — models per-point normal-estimation error
    on real scans (the reference consumes scanner normals as-is)."""
    if noise_deg <= 0:
        return normals
    n = np.asarray(normals, np.float64)
    tangent = rng.normal(size=n.shape)
    tangent -= np.sum(tangent * n, axis=1, keepdims=True) * n
    tangent /= np.maximum(np.linalg.norm(tangent, axis=1, keepdims=True),
                          1e-12)
    ang = np.radians(rng.normal(scale=noise_deg, size=n.shape[0]))[:, None]
    out = np.cos(ang) * n + np.sin(ang) * tangent
    return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(
        np.float32)


def make_plane_points(rng, center, u, v, extent_u, extent_v, n, noise=0.0,
                      normal_noise_deg=0.0):
    """Sample n points on the rectangle center +/- extent along (u, v)."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    normal = np.cross(u, v)
    normal /= np.linalg.norm(normal)
    a = rng.uniform(-extent_u, extent_u, size=n)
    b = rng.uniform(-extent_v, extent_v, size=n)
    pts = (np.asarray(center)[None] + a[:, None] * u[None] + b[:, None] * v[None])
    if noise > 0:
        pts = pts + rng.normal(scale=noise, size=(n, 3)) * normal[None]
    normals = np.tile(normal, (n, 1)).astype(np.float32)
    normals = perturb_normals(rng, normals, normal_noise_deg)
    return pts.astype(np.float32), normals.astype(np.float32)


#: face names for ``make_room(faces=...)`` in spec order
ROOM_FACES = ("floor", "wall_y-", "wall_x-", "wall_y+", "wall_x+",
              "ceiling")


def make_room(rng, n_per_plane=3000, noise=0.0, size=4.0, extra_planes=4,
              normal_noise_deg=0.0, faces=None):
    """A box 'room' (floor + 2-4 walls + ceiling patches) plus a few tilted
    interior planes so plane pairs are non-degenerate.  Normals point into
    the room interior (consistent orientation, like scanner data).

    ``faces`` selects a subset of :data:`ROOM_FACES` (default: all six).
    Real terrestrial scans rarely see every face of a room; an asymmetric
    face subset also removes the box's 180-degree pose symmetries, which
    otherwise make a flipped registration nearly as consistent with the
    data as the true one (the C++ reference's own polyhedron failure mode,
    BASELINE.md: 3/10 runs lock a symmetric wrong pose).

    Returns (points, normals, plane_list) with plane_list of
    (normal, d) ground-truth coefficients.
    """
    s = size / 2
    specs = [
        # center, u, v, normal toward interior
        (( 0, 0, -s), (1, 0, 0), (0, 1, 0)),   # floor  (n = +z)
        (( 0, -s, 0), (1, 0, 0), (0, 0, 1)),   # wall y=-s (n = +y)
        ((-s, 0, 0), (0, 1, 0), (0, 0, 1)),    # wall x=-s (n = +x)
        (( 0, s, 0), (1, 0, 0), (0, 0, 1)),    # wall y=+s (n = -y)
        (( s, 0, 0), (0, 1, 0), (0, 0, 1)),    # wall x=+s (n = -x)
        (( 0, 0, s), (1, 0, 0), (0, 1, 0)),    # ceiling (n = -z)
    ]
    if faces is not None:
        keep = set(faces)
        unknown = keep - set(ROOM_FACES)
        if unknown:
            raise ValueError(f"unknown faces {sorted(unknown)}")
        specs = [sp for name, sp in zip(ROOM_FACES, specs) if name in keep]
    interior = np.zeros(3)
    pts_list, nrm_list, planes = [], [], []
    for k, (c, u, v) in enumerate(specs):
        p, nr = make_plane_points(rng, c, u, v, s * 0.95, s * 0.95,
                                  n_per_plane, noise, normal_noise_deg)
        n0 = nr[0] / np.linalg.norm(nr[0])
        if np.dot(interior - np.asarray(c), n0) < 0:
            n0 = -n0
            nr = -nr
        pts_list.append(p)
        nrm_list.append(nr)
        planes.append((n0, -float(np.dot(n0, np.asarray(c, np.float64)))))
    # tilted interior planes break the box symmetry
    for k in range(extra_planes):
        c = rng.uniform(-s * 0.5, s * 0.5, size=3)
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(0.3, 1.2)
        n0 = np.array([np.cos(theta) * np.sin(phi),
                       np.sin(theta) * np.sin(phi), np.cos(phi)])
        u = np.cross(n0, [0, 0, 1.0])
        u /= np.linalg.norm(u)
        v = np.cross(n0, u)
        p, nr = make_plane_points(rng, c, u, v, s * 0.45, s * 0.35,
                                  n_per_plane, noise, normal_noise_deg)
        if np.dot(nr[0], n0) < 0:
            nr = -nr
        pts_list.append(p)
        nrm_list.append(nr)
        planes.append((n0.astype(np.float32),
                       -float(np.dot(n0, c))))
    points = np.concatenate(pts_list, axis=0)
    normals = np.concatenate(nrm_list, axis=0)
    perm = rng.permutation(points.shape[0])
    return points[perm], normals[perm], planes


def random_rigid(rng, max_angle=np.pi, max_trans=1.0):
    """A random rotation (angle <= max_angle) + translation."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.2, max_angle)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    t = rng.uniform(-max_trans, max_trans, size=3)
    return R.astype(np.float32), t.astype(np.float32)


def transform_cloud(points, normals, R, t):
    return (points @ R.T + t).astype(np.float32), (normals @ R.T).astype(np.float32)
