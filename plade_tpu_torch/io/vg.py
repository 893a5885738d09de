"""Mapple .vg plane-segmentation debug export.

A copy of ``plade_tpu/io/vg.py`` (that package imports JAX when it is
imported), pinned to it by ``tests/test_torch_host_io.py``.  Equivalent of
the reference's ``save_vg`` (code/PLADE/util.cpp:1553-1616; never called
there, but part of its tooling surface): dumps a cloud plus its
plane groups in Mapple's ASCII vertex-group format for visual inspection.
"""
from __future__ import annotations

import numpy as np


def save_vg(path: str, points: np.ndarray, normals: np.ndarray | None,
            point_plane: np.ndarray, num_planes: int, seed: int = 0):
    """points: (N, 3); point_plane: (N,) plane id per point or -1."""
    rng = np.random.default_rng(seed)
    points = np.asarray(points)
    point_plane = np.asarray(point_plane)
    n = points.shape[0]
    with open(path, "w") as out:
        out.write(f"num_points: {n}\n")
        out.write(" ".join(f"{v:.16g}" for v in points.reshape(-1)) + "\n")
        out.write("num_colors: 0\n")
        if normals is not None:
            out.write(f"num_normals: {n}\n")
            out.write(" ".join(f"{v:.16g}"
                               for v in np.asarray(normals).reshape(-1)) + "\n")
        else:
            out.write("num_normals: 0\n\n")
        groups = [np.nonzero(point_plane == k)[0] for k in range(num_planes)]
        out.write(f"num_groups: {len(groups)}\n")
        for idx in groups:
            out.write("group_type: 0\n")
            out.write("num_group_parameters: 4\n")
            out.write("group_parameters: 0 0 0 0 \n")
            out.write("group_label: unknown\n")
            r, g, b = rng.uniform(0.3, 1.0, size=3)
            out.write(f"group_color: {r:.6g} {g:.6g} {b:.6g}\n")
            out.write(f"group_num_point: {len(idx)}\n")
            out.write(" ".join(str(int(i)) for i in idx) + "\n")
            out.write("num_children: 0\n")
