"""K5, the penetration filter's point-counting walk (``csrc/penetration.cu``).

``penetration_walk`` replaces no Pallas kernel and takes CUDA tensors only:
``verify.penetration.run_tests`` gives CPU tensors to the plain two-tier
walk, ``verify.penetration.run_tests_plain``, whose verdicts it gives.  One
launch walks every test of every pair, over each plane's live points, and
reads nothing back to the host.  :func:`penetration_walk_counts` also
returns each test's four counts, for the tests.
"""
from __future__ import annotations

import torch

from .build import LAUNCHES, count_launch  # noqa: F401
from .nn import _raise_on


def _launch(tests, R, t, src_pts, src_counts, tgt_pts, tgt_counts,
            src_coeffs, tgt_coeffs, search_radius, min_distance,
            min_points: int, max_ratio: float, n_samples: int,
            with_counts: bool):
    dev = R.device
    B, K = tests.cand.shape
    C, Ps, M, Pt = R.shape[1], src_pts.shape[1], src_pts.shape[2], \
        tgt_pts.shape[1]
    # (tensor, its shape, float32 or an integer type)
    args = {"cand": (tests.cand, (B, K), False),
            "src": (tests.src, (B, K), False),
            "tgt": (tests.tgt, (B, K), False),
            "start": (tests.start, (B, K, 3), True),
            "direc": (tests.direc, (B, K, 3), True),
            "length": (tests.length, (B, K), True),
            "valid": (tests.valid, (B, K), False),
            "R": (R, (B, C, 3, 3), True), "t": (t, (B, C, 3), True),
            "src_pts": (src_pts, (B, Ps, M, 3), True),
            "src_counts": (src_counts, (B, Ps), False),
            "tgt_pts": (tgt_pts, (B, Pt, M, 3), True),
            "tgt_counts": (tgt_counts, (B, Pt), False),
            "src_coeffs": (src_coeffs, (B, Ps, 4), True),
            "tgt_coeffs": (tgt_coeffs, (B, Pt, 4), True),
            "search_radius": (search_radius, (B,), True),
            "min_distance": (min_distance, (B,), True)}
    for name, (x, shape, real) in args.items():
        if x.device != dev:
            raise ValueError(f"penetration_walk: tensors on {x.device} and "
                             f"{dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"penetration_walk: {name} is "
                             f"{tuple(x.shape)}, expected {shape}")
        if real and x.dtype != torch.float32:
            raise TypeError(f"penetration_walk: {name} is {x.dtype}, "
                            "expected float32")
    if dev.type != "cuda":
        raise ValueError(f"penetration_walk: K5 runs on a CUDA device, not "
                         f"{dev} (verify.penetration.run_tests_plain is the "
                         "CPU's)")
    out = torch.empty((B, K), dtype=torch.bool, device=dev)
    counts = torch.empty((B, K, 4), dtype=torch.int32, device=dev) \
        if with_counts else None
    if out.numel() == 0:
        return out, counts
    # the plain walk's thresholds, by the same operations
    args["r_occ"] = ((search_radius / 2) ** 2, None, True)
    args["r_near"] = (search_radius ** 2, None, True)
    # contiguous, in the C function's order (the order of ``args``)
    ptr = [x.contiguous() if real else
           x.to(torch.bool if name == "valid" else torch.int32).contiguous()
           for name, (x, _, real) in args.items()]
    from .build import library
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().plade_penetration_walk(
            *(x.data_ptr() for x in ptr), out.data_ptr(),
            counts.data_ptr() if with_counts else None, B, K, C, Ps, Pt, M,
            int(n_samples), int(min_points), float(max_ratio), stream)
    _raise_on("penetration_walk", err)
    count_launch("penetration_walk")
    return out, counts


def penetration_walk(tests, R, t, src_pts, src_counts, tgt_pts, tgt_counts,
                     src_coeffs, tgt_coeffs, search_radius, min_distance,
                     min_points: int, max_ratio: float,
                     n_samples: int) -> torch.Tensor:
    """K5: (B, K) ``penetrable`` of each test, the verdicts of
    ``verify.penetration.run_tests_plain``.  ``tests`` a
    ``verify.penetration.PenTests`` of (B, K) tests, ``R`` (B, C, 3, 3),
    ``t`` (B, C, 3), plane points (B, P, M, 3) with their live counts
    (B, P), plane coefficients (B, P, 4), ``search_radius`` and
    ``min_distance`` (B,); all on one CUDA device, floats float32."""
    return _launch(tests, R, t, src_pts, src_counts, tgt_pts, tgt_counts,
                   src_coeffs, tgt_coeffs, search_radius, min_distance,
                   min_points, max_ratio, n_samples, False)[0]


def penetration_walk_counts(tests, R, t, src_pts, src_counts, tgt_pts,
                            tgt_counts, src_coeffs, tgt_coeffs,
                            search_radius, min_distance, min_points: int,
                            max_ratio: float, n_samples: int):
    """For the tests: :func:`penetration_walk`'s verdicts and each test's
    (B, K, 4) int32 counts (pos1, neg1, pos2, neg2; 0 for invalid tests),
    every side walked in full."""
    return _launch(tests, R, t, src_pts, src_counts, tgt_pts, tgt_counts,
                   src_coeffs, tgt_coeffs, search_radius, min_distance,
                   min_points, max_ratio, n_samples, True)
