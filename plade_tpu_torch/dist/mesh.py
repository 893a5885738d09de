"""Batch registration of pairs on one card (``plade_tpu/dist/mesh.py``).

The reference vmaps its device step over a leading pair axis
(``make_batch_register``) and shards that batch over a JAX device mesh (a
``pairs`` axis of data parallelism, an ``intra`` axis for the point
buffers).  Here a batch is the device step of
``pipeline.build_register_device_fn`` over a leading pair axis on one card:
its B pairs run in lockstep, each kernel launched once for all of them
(K1/K2 with a pair axis, K3 over the lanes of all 2B clouds), each host
loop run to the slowest pair.  ``register_array_pairs`` takes its pairs
``batch_pairs`` at a time, where the reference takes the mesh's pairs axis
a call.  The mesh helpers (``make_mesh``, ``batch_specs``,
``result_specs``, ``make_batch_register``) are JAX sharding and have no
counterpart here; pairs over several cards are a later step of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PladeConfig
from ..core.types import Cloud, RegistrationResult, pad_cloud
from ..pipeline import (_cap_cloud, _pad_size, _run_device,
                        register_pair_device)


class PairOutcome(NamedTuple):
    """Per-pair batch result, with the truncation diagnostics the
    single-pair entry reports in its info dict."""
    transform: np.ndarray   # (4, 4)
    success: bool
    score: float
    overlap: float
    matched_planes: int
    cloud_capped: bool = False      # input subsampled to cfg.max_points
    match_saturated: int = 0        # dropped descriptor radius hits (rows)
    pen_overflow: int = 0           # dropped penetration tests
    cluster_truncated: int = 0      # hypotheses beyond the cluster prefix


def stack_clouds(clouds: list[Cloud]) -> Cloud:
    """Stack same-shape Clouds along a new leading batch axis."""
    return Cloud(*(torch.stack(xs) for xs in zip(*clouds)))


def register_batch(tgt_batch: Cloud, src_batch: Cloud, seeds,
                   cfg: PladeConfig, device=None) -> RegistrationResult:
    """Register a batch of pairs in lockstep on ``device`` (by default
    CUDA): the device step over the leading axis of ``tgt_batch`` /
    ``src_batch`` (Clouds of B pairs padded to one size), pair ``i``
    drawing from ``seeds[i]``.  Each pair's result is what the step gives
    that pair alone.  Returns the results stacked on that axis."""
    step = register_pair_device(cfg, tgt_batch.points.shape[1], device)
    return step(tgt_batch, src_batch, [int(s) for s in seeds])


def register_array_pairs(cloud_pairs, cfg: PladeConfig, seed: int = 0,
                         device=None, batch_pairs: int = 8
                         ) -> list[PairOutcome]:
    """Register a list of raw numpy cloud pairs through the device step:
    the host-level entry of batch flows.

    ``cloud_pairs``: list of (tgt_pts, tgt_nrm, src_pts, src_nrm).  Each
    cloud is capped at ``cfg.max_points`` (pair ``i``'s target drawn from
    ``seed + 2i``, its source from ``seed + 2i + 1``), all pairs are padded
    to one size, and pair ``i`` registers with seed ``seed + i``.  The
    pairs run ``batch_pairs`` at a time in lockstep (:func:`register_batch`;
    the last batch is smaller, never padded with a repeated pair), so every
    outcome is what the step gives that pair alone.  No target/source swap
    is applied (the device step mirrors the cloud-level reference
    overload, plade.cpp:638-662).  Returns one PairOutcome per input
    pair."""
    device = _run_device(device)
    if batch_pairs < 1:
        raise ValueError(f"batch_pairs must be >= 1, got {batch_pairs}")
    if not cloud_pairs:
        return []
    capped = []
    cap_flags = []
    max_n = 0
    for i, (tp, tn, sp, sn) in enumerate(cloud_pairs):
        tp, tn, t_capped = _cap_cloud(tp, tn, cfg.max_points, seed + 2 * i)
        sp, sn, s_capped = _cap_cloud(sp, sn, cfg.max_points,
                                      seed + 2 * i + 1)
        if t_capped or s_capped:
            print(f"[register_array_pairs] pair {i}: cloud capped to "
                  f"max_points={cfg.max_points}", flush=True)
        cap_flags.append(bool(t_capped or s_capped))
        max_n = max(max_n, tp.shape[0], sp.shape[0])
        capped.append((tp, tn, sp, sn))
    pad = _pad_size(max_n, maximum=cfg.max_points)
    outcomes = []
    for start in range(0, len(capped), batch_pairs):
        chunk = capped[start:start + batch_pairs]
        tgt_b = stack_clouds([pad_cloud(c[0], c[1], pad, device)
                              for c in chunk])
        src_b = stack_clouds([pad_cloud(c[2], c[3], pad, device)
                              for c in chunk])
        res = register_batch(tgt_b, src_b,
                             [seed + start + i for i in range(len(chunk))],
                             cfg, device)
        host = RegistrationResult(*(x.cpu().numpy() for x in res))
        outcomes += [PairOutcome(
            host.transform[i], bool(host.success[i]), float(host.score[i]),
            float(host.overlap[i]), int(host.matched_planes[i]),
            cloud_capped=cap_flags[start + i],
            match_saturated=int(host.match_saturated[i]),
            pen_overflow=int(host.pen_overflow[i]),
            cluster_truncated=int(host.cluster_truncated[i]))
            for i in range(len(chunk))]
    return outcomes
