"""Multi-scan scene registration: pairwise PLADE + global pose-graph sync
(``plade_tpu/cli/scene.py``).

The reference stops at independent pairwise registrations (batch mode,
code/PLADE/main.cpp:97-158).  This command registers a RESSO-style scene —
a directory of scans — pairwise along consecutive pairs (plus optional
loop-closure pairs), then synchronizes world-from-scan poses with
dist/posegraph and writes them as stacked 4x4 matrices.  Registration and
synchronization run on ``device`` (by default CUDA).
"""
from __future__ import annotations

import os
import sys

import numpy as np


def run_scene(scene_dir: str, out_file: str, cfg, seed: int = 0,
              loop_stride: int = 0, gt_file: str | None = None,
              device_batch: bool = False, device=None, mesh=None) -> int:
    """Register the scans of ``scene_dir`` pairwise and write their
    synchronized poses to ``out_file``.  With ``device_batch`` the pairs
    run through the device step on ``mesh`` (by default the mesh
    ``device`` names: every visible card for ``cuda``); the sequential
    registrations and the pose graph run on ``device``."""
    from ..dist import posegraph
    from ..dist.mesh import device_mesh, register_array_pairs
    from ..io import resso
    from ..io.ply import read_ply
    from ..pipeline import register_files

    scene = resso.load_scene(scene_dir, gt_file)
    n = len(scene.scan_files)
    if n < 2:
        print(f"scene needs >= 2 scans, found {n}", file=sys.stderr)
        return 1

    pairs = [(i, i + 1) for i in range(n - 1)]
    if loop_stride and loop_stride > 1:
        pairs += [(i, i + loop_stride) for i in range(n - loop_stride)]

    edges = []
    n_fail = 0
    if device_batch:
        # all pairwise registrations through the device step, 8 pairs at a
        # time a shard in lockstep (scans loaded once)
        clouds = {}
        for i, j in pairs:
            for k in (i, j):
                if k not in clouds:
                    clouds[k] = read_ply(scene.scan_files[k])
        outcomes = register_array_pairs(
            [(clouds[i][0], clouds[i][1], clouds[j][0], clouds[j][1])
             for i, j in pairs], cfg, seed,
            mesh=mesh if mesh is not None else device_mesh(device))
        for (i, j), r in zip(pairs, outcomes):
            if r.success:
                edges.append((i, j, r.transform, float(max(r.score, 1e-3))))
                print(f"pair ({i},{j}): score={r.score:.3f} "
                      f"overlap={r.overlap:.3f}")
            else:
                n_fail += 1
    else:
        for (i, j) in pairs:
            try:
                T, info = register_files(scene.scan_files[i],
                                         scene.scan_files[j], cfg, seed,
                                         device=device)
                ok = bool(info.get("success"))
            except (ValueError, FileNotFoundError) as e:
                print(f"pair ({i},{j}) failed: {e}", file=sys.stderr)
                ok = False
            if ok:
                w = float(max(info.get("score", 0.0), 1e-3))
                edges.append((i, j, T, w))
                print(f"pair ({i},{j}): score={info.get('score', 0):.3f} "
                      f"overlap={info.get('overlap', 0):.3f}")
            else:
                n_fail += 1
    if not edges:
        print("all pairwise registrations failed", file=sys.stderr)
        return 1

    graph = posegraph.from_edges(edges, n, device=device)
    R, t = posegraph.synchronize(graph, n)
    ang, terr = posegraph.residuals(graph, R, t)
    R = R.cpu().numpy()
    t = t.cpu().numpy()
    with open(out_file, "w") as out:
        for k in range(n):
            out.write(f"{os.path.basename(scene.scan_files[k])}\n")
            T = np.eye(4)
            T[:3, :3] = R[k]
            T[:3, 3] = t[k]
            out.write("\n".join(
                " ".join(f"{v:.6g}" for v in row) for row in T) + "\n")

    live = graph.weight.cpu().numpy() > 0
    ang = ang.cpu().numpy()[live]
    terr = terr.cpu().numpy()[live]
    print(f"scene: {n} scans, {len(edges)} edges ({n_fail} failed); "
          f"residuals rot max {ang.max():.2f} deg, trans max {terr.max():.4f}")

    if scene.gt_poses is not None:
        errs = []
        for k in range(n):
            gt_rel = np.linalg.inv(scene.gt_poses[0]) @ scene.gt_poses[k]
            c = (np.trace(gt_rel[:3, :3].T @ R[k]) - 1) / 2
            errs.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
        print(f"vs ground truth: pose rot err max {max(errs):.2f} deg")
    return 0


def export_view(result_file: str, out_prefix: str) -> int:
    """Headless counterpart of the reference ResultViewer
    (code/ResultViewer/main.cpp:37-95): loads the first pair of a results
    file, transforms the source cloud by its recorded matrix (normals by
    the inverse-transpose, main.cpp:84-92) and writes
    ``<prefix>_target.ply`` + ``<prefix>_source_registered.ply``."""
    from ..io.ply import read_ply, write_ply

    target = source = None
    rows = []
    with open(result_file) as f:
        for line in f:
            line = line.strip()
            if line.startswith("target:"):
                target = line.split(":", 1)[1].strip()
            elif line.startswith("source:"):
                source = line.split(":", 1)[1].strip()
            elif target and source and line and line[0] in "-0123456789":
                rows.append([float(v) for v in line.split()])
                if len(rows) == 4:
                    break
    if not (target and source and len(rows) == 4):
        print(f"no parsable pair in {result_file}", file=sys.stderr)
        return 1
    T = np.asarray(rows, np.float32)
    tp, tn = read_ply(target)
    sp, sn = read_ply(source)
    sp2 = sp @ T[:3, :3].T + T[:3, 3]
    # normals transform by the inverse transpose (pure rotation: same R)
    N = np.linalg.inv(T[:3, :3]).T
    sn2 = sn @ N.T if sn is not None else None
    write_ply(out_prefix + "_target.ply", tp, tn)
    write_ply(out_prefix + "_source_registered.ply", sp2.astype(np.float32),
              None if sn2 is None else sn2.astype(np.float32))
    print(f"wrote {out_prefix}_target.ply and "
          f"{out_prefix}_source_registered.ply")
    return 0
