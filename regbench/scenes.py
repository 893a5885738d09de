"""Scan pairs with known ground truth: the benchmark's frozen generators.

A copy of the scene generators of ``plade_tpu_torch/io/synthetic.py``
(``perturb_normals``, ``make_plane_points``, ``make_room``, ``make_world``,
``make_scan_sequence``, ``random_rigid``, ``transform_cloud``), kept here
so that a change to the program cannot change the benchmark's inputs.  The
same seed gives the same arrays, bit for bit (``tests/
test_regbench_scenes.py`` holds the copy to the port's at seed 0).

:func:`build_pool` turns a configuration's ``pool`` (a list of groups,
``regbench/configs/<name>.json``) into the list of :class:`Pair` a traffic
mix draws from.  Two kinds of group exist:

* ``scan_sequence``: ``make_scan_sequence`` from ``default_rng(seed)`` with
  the group's keywords; every consecutive pair of scans (target i, source
  i + 1), the truth ``inv(pose_i) @ pose_(i+1)``;
* ``room_halves``: ``make_room`` from ``default_rng(seed)``, its points cut
  into two random halves, the source half moved by ``random_rigid``; the
  truth is that motion.

The pool is the same for every run seed: a seed changes the order and the
registration draws of the pairs (``traffic.py``), never the clouds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def perturb_normals(rng, normals, noise_deg):
    """Rotate each normal by an independent random angle ~ N(0, noise_deg)
    about a random tangent axis."""
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
    pts = (np.asarray(center)[None] + a[:, None] * u[None]
           + b[:, None] * v[None])
    if noise > 0:
        pts = pts + rng.normal(scale=noise, size=(n, 3)) * normal[None]
    normals = np.tile(normal, (n, 1)).astype(np.float32)
    normals = perturb_normals(rng, normals, normal_noise_deg)
    return pts.astype(np.float32), normals.astype(np.float32)


def make_room(rng, n_per_plane=3000, noise=0.0, size=4.0, extra_planes=4,
              normal_noise_deg=0.0):
    """A box room (floor, four walls, ceiling) plus ``extra_planes`` tilted
    interior planes, normals toward the interior.  Returns (points,
    normals, [(normal, d)] of the generator planes)."""
    s = size / 2
    specs = [
        ((0, 0, -s), (1, 0, 0), (0, 1, 0)),
        ((0, -s, 0), (1, 0, 0), (0, 0, 1)),
        ((-s, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, s, 0), (1, 0, 0), (0, 0, 1)),
        ((s, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, 0, s), (1, 0, 0), (0, 1, 0)),
    ]
    interior = np.zeros(3)
    pts_list, nrm_list, planes = [], [], []
    for c, u, v in specs:
        p, nr = make_plane_points(rng, c, u, v, s * 0.95, s * 0.95,
                                  n_per_plane, noise, normal_noise_deg)
        n0 = nr[0] / np.linalg.norm(nr[0])
        if np.dot(interior - np.asarray(c), n0) < 0:
            n0 = -n0
            nr = -nr
        pts_list.append(p)
        nrm_list.append(nr)
        planes.append((n0, -float(np.dot(n0, np.asarray(c, np.float64)))))
    for _ in range(extra_planes):
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
        planes.append((n0.astype(np.float32), -float(np.dot(n0, c))))
    points = np.concatenate(pts_list, axis=0)
    normals = np.concatenate(nrm_list, axis=0)
    perm = rng.permutation(points.shape[0])
    return points[perm], normals[perm], planes


def make_world(rng, n_rooms=3, n_per_plane=3000, noise=0.0, size=4.0,
               extra_planes=3, normal_noise_deg=0.0):
    """A row of ``n_rooms`` rooms along +x.  Returns (points, normals)."""
    pts_list, nrm_list = [], []
    for k in range(n_rooms):
        p, n, _ = make_room(rng, n_per_plane=n_per_plane, noise=noise,
                            size=size, extra_planes=extra_planes,
                            normal_noise_deg=normal_noise_deg)
        offset = np.array([k * size * 0.85, 0.0, 0.0], np.float32)
        pts_list.append(p + offset)
        nrm_list.append(n)
    return (np.concatenate(pts_list).astype(np.float32),
            np.concatenate(nrm_list).astype(np.float32))


def make_scan_sequence(rng, n_scans=6, n_points=60000, overlap_radius=3.2,
                       step=2.0, max_angle=0.6, max_trans=0.5,
                       **world_kwargs):
    """Scans of a world along +x, each the world within ``overlap_radius``
    of its viewpoint (at most ``n_points`` of it) in its own scanner frame.
    Returns (scans: [(points, normals)], poses: (n_scans, 4, 4) scan to
    world)."""
    wpts, wnrm = make_world(rng, **world_kwargs)
    scans, poses = [], []
    for i in range(n_scans):
        center = np.array([i * step, 0.0, 0.0], np.float32)
        d = np.linalg.norm(wpts - center[None], axis=1)
        sel = np.where(d <= overlap_radius)[0]
        if len(sel) > n_points:
            sel = rng.choice(sel, size=n_points, replace=False)
        p, n = wpts[sel], wnrm[sel]
        R, t = random_rigid(rng, max_angle=max_angle, max_trans=max_trans)
        sp, sn = transform_cloud(p, n, R.T, -R.T @ t)
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = R
        T[:3, 3] = t
        scans.append((sp, sn))
        poses.append(T)
    return scans, np.stack(poses)


def random_rigid(rng, max_angle=np.pi, max_trans=1.0):
    """A random rotation (angle <= max_angle) and translation."""
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
    return ((points @ R.T + t).astype(np.float32),
            (normals @ R.T).astype(np.float32))


class Pair(NamedTuple):
    """One scan pair of a pool: target and source clouds (float32 (n, 3)),
    the truth (4x4 float64, source into target) and a name."""
    tgt_points: np.ndarray
    tgt_normals: np.ndarray
    src_points: np.ndarray
    src_normals: np.ndarray
    truth: np.ndarray
    name: str


def _scan_sequence(group: dict) -> list[Pair]:
    kw = {k: v for k, v in group.items() if k not in ("kind", "name",
                                                      "seed")}
    scans, poses = make_scan_sequence(np.random.default_rng(group["seed"]),
                                      **kw)
    return [Pair(*scans[i], *scans[i + 1],
                 np.linalg.inv(poses[i]) @ poses[i + 1],
                 f"{group['name']}:{i}-{i + 1}")
            for i in range(len(scans) - 1)]


def _room_halves(group: dict) -> list[Pair]:
    rng = np.random.default_rng(group["seed"])
    pts, nrm, _ = make_room(rng, n_per_plane=group["n_per_plane"],
                            noise=group["noise"],
                            extra_planes=group["extra_planes"],
                            normal_noise_deg=group["normal_noise_deg"])
    perm = rng.permutation(pts.shape[0])
    half = pts.shape[0] // 2
    ti, si = perm[:half], perm[half:]
    R, t = random_rigid(rng, max_angle=group["max_angle"],
                        max_trans=group["max_trans"])
    sp, sn = transform_cloud(pts[si], nrm[si], R.T, -R.T @ t)
    truth = np.eye(4)
    truth[:3, :3] = R
    truth[:3, 3] = t
    return [Pair(pts[ti], nrm[ti], sp, sn, truth, group["name"])]


KINDS = {"scan_sequence": _scan_sequence, "room_halves": _room_halves}


def build_pool(groups: list[dict]) -> list[Pair]:
    """Every pair of every group, in the groups' order."""
    pool = []
    for group in groups:
        pool += KINDS[group["kind"]](group)
    return pool
