"""Whether a run's answers are correct: the program's outputs of the
window held to the plain reference (``reference/``) and to the truth the
generator made.

The numbers compared, each with its limit (the limits file of the cell,
or the configuration where it states one):

* ``unanswered``: pairs of the window that got no answer (their call
  raised, or returned fewer outcomes than pairs); limit 0.
* ``nonfinite``: answers whose transform is not finite; limit 0.
* ``pose_miss_share``: the share of the window's pairs whose transform
  misses the generator's truth by the configuration's thresholds (5 deg,
  0.5), whatever the program's success flag says; limit 1 - the
  configuration's ``min_recall``.  Sound runs miss some pairs (a scan that
  runs off its world, a room's 180-degree symmetry).
* ``spacing_gap``: the largest relative gap between the source spacing the
  program derived for a pair in the window and the reference's, over every
  pair of the window whose spaced cloud has points.
* ``k2_gap`` / ``k1_gap``: over the K2 / K1 launches of one call of the
  window (drawn from the seed) and rows drawn from the seed among each
  launch's live queries, the largest relative gap between the kernel's
  answer and the reference's, the same answer worked out again from the
  launch's own inputs; for K2 also the gap between the distance to the
  reference point the kernel named and the least distance.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .reference import nn as ref_nn
from .reference import spacing as ref_spacing
from .reference.pose import pose_errors
from .yardstick import LIVE_LIMIT


def failed(out) -> bool:
    """Whether a pair's operation failed: its call raised or answered
    short (``out`` is None), or its transform is not finite.  A transform
    that misses the truth is an answer, judged by ``pose_miss_share``."""
    return out is None or not np.isfinite(out[0]).all()


def registered(out, pair, config) -> bool:
    """Whether answer ``out`` ((transform, success)) puts the pair within
    the configuration's success thresholds of its truth, whatever its
    success flag says."""
    rot, trans = pose_errors(out[0], pair.truth)
    return rot < config["success_rot_deg"] and trans < config["success_trans"]


def _source(pair, config, swaps: bool):
    """The cloud whose spacing the program derives: the source, or the
    target where the entry ``swaps`` them (a source at least
    ``swap_size_ratio`` times the target's size)."""
    ratio = config["plade_config"]["swap_size_ratio"]
    if swaps and pair.src_points.shape[0] >= pair.tgt_points.shape[0] * ratio:
        return pair.tgt_points
    return pair.src_points


def spacing_values(spacings, pool, config,
                   swaps: bool) -> list[tuple[int, float]]:
    """(pool index, the program's spacing) for every pair of the window
    whose call derived one, from the calls' (pool indices, [(first
    points, spacings)]): a pair's spacing is the one recorded with its
    spaced cloud's first point.  A call that derived none (one pair that
    stopped before its spacing) gives none; a pair of a call with
    spacings that has none of its own gives NaN."""
    out = []
    for idx, recorded in spacings:
        by_first = {}
        for first, values in recorded:
            by_first.update(zip(map(tuple, first.tolist()), values.tolist()))
        if not by_first:
            if len(idx) != 1:
                out += [(i, math.nan) for i in idx]
            continue
        for i in idx:
            cloud = _source(pool[i], config, swaps)
            if cloud.shape[0]:
                key = tuple(float(x) for x in cloud[0])
                out.append((i, by_first.get(key, math.nan)))
    return out


def _rows(q: torch.Tensor, count: int, rng) -> torch.Tensor:
    """Up to ``count`` (pair, row) indices drawn from the live rows of
    queries ``q`` (P, Q, 3)."""
    live = torch.nonzero(torch.amax(torch.abs(q), dim=-1) < LIVE_LIMIT)
    if live.shape[0] > count:
        pick = rng.choice(live.shape[0], size=count, replace=False)
        live = live[torch.as_tensor(np.sort(pick), device=live.device)]
    return live


def kernel_gaps(launches, rows_per_launch: int, seed: int,
                control: bool = False) -> dict:
    """{kind: largest gap} over the captured launches (``control``: the
    TF32 answers in place of the kernels')."""
    gaps = {}
    rng = np.random.default_rng([int(seed), 5])
    for kind, args, outs in launches:
        q = args[0]
        rows = _rows(q, rows_per_launch, rng)
        if kind == "k2":
            r = args[1]
            if control:
                d, i = ref_nn.k2_tf32(q, r, rows)
            else:
                d = outs[0][rows[:, 0], rows[:, 1]]
                i = outs[1][rows[:, 0], rows[:, 1]]
            least, at = ref_nn.k2_reference(q, r, rows, i)
            gap = max(ref_nn.relative_gap(d, least),
                      ref_nn.relative_gap(at, least))
        else:
            qn, r, rn, cos = args[1], args[2], args[3], float(args[4])
            if control:
                d = ref_nn.k1_tf32(q, qn, r, rn, cos, rows)
            else:
                d = outs[0][rows[:, 0], rows[:, 1]]
            gap = ref_nn.relative_gap(
                d, ref_nn.k1_reference(q, qn, r, rn, cos, rows))
        gaps[kind] = max(gaps.get(kind, 0.0), gap)
    return gaps


def spacing_gap(values, pool, config, device, swaps: bool,
                control: bool = False):
    """Largest relative gap of the program's spacings ``values`` ((pool
    index, spacing)) to the reference's (``control``: the TF32 spacing in
    the program's place)."""
    pc = config["plade_config"]
    k, samples = pc["spacing_k"], pc["spacing_samples"]
    ref, ctl = {}, {}
    gap = 0.0
    for i, value in values:
        if i not in ref:
            src = _source(pool[i], config, swaps)
            if src.shape[0] > pc["max_points"]:
                raise ValueError("the check covers clouds up to max_points")
            ref[i] = ref_spacing.average_spacing(src, k, samples, device)
            if control:
                ctl[i] = ref_spacing.average_spacing_tf32(src, k, samples,
                                                          device)
        v = ctl[i] if control else value
        g = abs(v - ref[i]) / ref[i]
        gap = max(gap, g if math.isfinite(g) else math.inf)
    return gap


def check(records, spacings, launches, pool, config, limits, seed: int,
          device, swaps: bool, control: bool = False) -> list:
    """[(name, value, limit, ok)] for a run: ``records`` (pool index,
    (transform, success) or None) of every pair of the window,
    ``spacings`` (pool indices, spacing tensors) a call, ``launches`` the
    captured K1/K2 launches, ``swaps`` whether the entry swaps a larger
    source with its target; the reference runs on ``device`` (the
    kernels' references on their launches' devices)."""
    answered = [(i, out) for i, out in records if out is not None]
    nonfinite = sum(not np.isfinite(out[0]).all() for _, out in answered)
    missed = sum(not registered(out, pool[i], config)
                 for i, out in answered)
    values = spacing_values(spacings, pool, config, swaps)
    with torch.no_grad():
        sgap = spacing_gap(values, pool, config, device, swaps, control)
        kgaps = kernel_gaps(launches, limits["rows_per_launch"], seed,
                            control)
    lines = [("unanswered", len(records) - len(answered), 0),
             ("nonfinite", int(nonfinite), 0),
             ("pose_miss_share", missed / max(len(answered), 1),
              1.0 - config["min_recall"]),
             ("spacing_gap", sgap, limits["spacing_gap"])]
    lines += [(f"{kind}_gap", kgaps[kind], limits[f"{kind}_gap"])
              for kind in ("k2", "k1") if kind in kgaps]
    print(f"[regbench] checked {len(records)} pairs, {len(values)} "
          f"spacings, launches K2 "
          f"{sum(k == 'k2' for k, *_ in launches)} / K1 "
          f"{sum(k == 'k1' for k, *_ in launches)}", file=sys.stderr)
    return [(name, value, limit, value <= limit)
            for name, value, limit in lines]
