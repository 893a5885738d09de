"""Pose errors of a transform against the truth."""
from __future__ import annotations

import math

import numpy as np


def pose_errors(T, truth) -> tuple[float, float]:
    """(rotation error in degrees, translation error) of the 4x4 ``T``
    against the 4x4 ``truth``.  The angle comes from
    ``||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2)``, which resolves small
    angles where the trace form's arccos does not.  Not finite where ``T``
    is not."""
    T = np.asarray(T, np.float64)
    truth = np.asarray(truth, np.float64)
    if not np.isfinite(T).all():
        return math.inf, math.inf
    d = np.linalg.norm(T[:3, :3] - truth[:3, :3])
    rot = math.degrees(2.0 * math.asin(min(1.0, d / (2.0 * math.sqrt(2.0)))))
    return rot, float(np.linalg.norm(T[:3, 3] - truth[:3, 3]))
