"""RESSO dataset loader + batch evaluation harness.

A copy of ``plade_tpu/io/resso.py`` (that package imports JAX when it is
imported); ``evaluate_scene`` runs the port's registration on the port's
mesh (``dist/mesh.py``) or on ``device``.

RESSO ("Real-world Scans with Small Overlap", linked from the reference
README "Test Dataset" section; not bundled) is the reference's external
benchmark: several scenes, each a set of scans with pairwise ground-truth
transforms.  The distribution ships per-scene directories of PLY scans plus
a ground-truth file listing, per scan, a 4x4 matrix aligning it into the
scene frame (so the pairwise GT for (target i, source j) is
``T_i^{-1} @ T_j``).

This loader is format-tolerant: it accepts
  * a directory of ``*.ply`` scans with a ``*.txt``/``*.log`` ground-truth
    file of N stacked 4x4 matrices (optionally with a name line before each
    matrix), or
  * an explicit pairs file in the reference's batch format
    (two PLY paths per pair on consecutive lines — main.cpp:97-158).

Evaluation metrics follow the standard registration-recall convention:
a pair is "recalled" when rotation error < rot_thresh (deg) and translation
error < trans_thresh.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RessoScene:
    name: str
    scan_files: list[str]
    gt_poses: np.ndarray | None        # (N, 4, 4) scan -> scene frame

    def pair_ground_truth(self, i: int, j: int) -> np.ndarray:
        """GT transform aligning source scan j onto target scan i."""
        if self.gt_poses is None:
            raise ValueError(f"scene {self.name} has no ground truth")
        return np.linalg.inv(self.gt_poses[i]) @ self.gt_poses[j]


def _read_matrices(path: str) -> tuple[list[str], np.ndarray]:
    """Parse a ground-truth file of stacked 4x4 matrices, each optionally
    preceded by a non-numeric name/index line."""
    names, rows, mats = [], [], []
    pending_name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                pending_name = line
                continue
            if len(vals) < 4:
                # e.g. "0 1" pair-index lines in .log formats: treat as name
                pending_name = line
                continue
            rows.append(vals[:4])
            if len(rows) == 4:
                mats.append(np.asarray(rows, np.float64))
                names.append(pending_name or f"scan_{len(mats) - 1}")
                rows, pending_name = [], None
    if rows:
        raise ValueError(f"{path}: trailing partial matrix")
    return names, np.stack(mats) if mats else np.zeros((0, 4, 4))


def load_scene(scene_dir: str, gt_file: str | None = None) -> RessoScene:
    """Load one RESSO scene directory: sorted *.ply scans + ground truth."""
    scans = sorted(
        os.path.join(scene_dir, f) for f in os.listdir(scene_dir)
        if f.lower().endswith(".ply"))
    if gt_file is None:
        cands = [os.path.join(scene_dir, f) for f in os.listdir(scene_dir)
                 if re.search(r"(ground.?truth|gt|pose)", f, re.I)
                 and f.lower().endswith((".txt", ".log"))]
        gt_file = cands[0] if cands else None
    gt = None
    if gt_file and os.path.isfile(gt_file):
        _, gt = _read_matrices(gt_file)
        if len(gt) != len(scans):
            # name-matched or partial GT: keep only if counts line up
            gt = gt if len(gt) == len(scans) else None
    return RessoScene(name=os.path.basename(scene_dir.rstrip("/")),
                      scan_files=scans, gt_poses=gt)


def consecutive_pairs(scene: RessoScene) -> list[tuple[int, int]]:
    """The standard RESSO evaluation registers consecutive scan pairs."""
    return [(i, i + 1) for i in range(len(scene.scan_files) - 1)]


@dataclass
class PairResult:
    target: str
    source: str
    transform: np.ndarray
    success: bool
    rot_err_deg: float | None = None
    trans_err: float | None = None


@dataclass
class EvalSummary:
    results: list[PairResult] = field(default_factory=list)
    rot_thresh_deg: float = 5.0
    trans_thresh: float = 0.5

    @property
    def recall(self) -> float:
        scored = [r for r in self.results if r.rot_err_deg is not None]
        if not scored:
            return 0.0
        hits = sum(r.rot_err_deg < self.rot_thresh_deg
                   and r.trans_err < self.trans_thresh for r in scored)
        return hits / len(scored)

    @property
    def rmse_trans(self) -> float:
        errs = [r.trans_err for r in self.results if r.trans_err is not None]
        return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")


def rotation_error_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def evaluate_scene(scene: RessoScene, cfg=None, pairs=None, seed: int = 0,
                   rot_thresh_deg: float = 5.0, trans_thresh: float = 0.5,
                   verbose: bool = True, device_batch: bool = False,
                   mesh=None, device=None) -> EvalSummary:
    """Register scan pairs of a scene and score against ground truth, on
    ``device`` (by default CUDA; ``device="cpu"`` for the CPU).

    ``device_batch=True`` routes all pairs through the device step
    (dist/mesh.register_array_pairs, its default ``batch_pairs`` = 8 pairs
    at a time a shard in lockstep) on ``mesh``, by default the mesh
    ``device`` names (every visible card for ``cuda``), instead of the
    sequential host loop of ``register_files`` (the reference's per-pair
    orchestration, main.cpp:97-158).
    """
    from ..core.config import PladeConfig
    from ..pipeline import register_files

    cfg = cfg or PladeConfig()
    pairs = pairs if pairs is not None else consecutive_pairs(scene)
    summary = EvalSummary(rot_thresh_deg=rot_thresh_deg,
                          trans_thresh=trans_thresh)

    if device_batch:
        from ..dist.mesh import device_mesh, register_array_pairs
        from .ply import read_ply
        clouds = {}
        for i, j in pairs:
            for k in (i, j):
                if k not in clouds:
                    clouds[k] = read_ply(scene.scan_files[k])
        cloud_pairs = [(clouds[i][0], clouds[i][1],
                        clouds[j][0], clouds[j][1]) for i, j in pairs]
        outcomes = register_array_pairs(
            cloud_pairs, cfg, seed,
            mesh=mesh if mesh is not None else device_mesh(device))
    else:
        outcomes = None

    for idx, (i, j) in enumerate(pairs):
        tgt, src = scene.scan_files[i], scene.scan_files[j]
        if outcomes is not None:
            T, ok = outcomes[idx].transform, outcomes[idx].success
        else:
            try:
                T, info = register_files(tgt, src, cfg, seed, device=device)
                ok = bool(info.get("success"))
            except (ValueError, FileNotFoundError):
                T, ok = np.eye(4), False
        r = PairResult(target=tgt, source=src, transform=T, success=ok)
        if scene.gt_poses is not None:
            G = scene.pair_ground_truth(i, j)
            r.rot_err_deg = rotation_error_deg(G[:3, :3], T[:3, :3])
            r.trans_err = float(np.linalg.norm(T[:3, 3] - G[:3, 3]))
        summary.results.append(r)
        if verbose:
            err = (f" rot={r.rot_err_deg:.2f}deg trans={r.trans_err:.3f}"
                   if r.rot_err_deg is not None else "")
            print(f"[resso] {os.path.basename(tgt)} <- "
                  f"{os.path.basename(src)}: success={ok}{err}", flush=True)
    return summary
