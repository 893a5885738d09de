"""The benchmark's yardstick: published peaks, the work a K1/K2 launch
needs, the union of busy intervals, percentiles and whole-pass counts.

Nothing here imports the program; later changes to the program are
measured against these definitions.
"""
from __future__ import annotations

import statistics

#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
#: 700 W limit): float32 outside the tensor cores, and HBM3 bandwidth.
#: The nearest-neighbour kernels compute in float32 on the SIMT cores.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: floating-point operations a (query, reference) pair: K2 3 subtractions,
#: 3 products, 2 additions (``d2 = dx*dx + dy*dy + dz*dz``); K1 those and
#: the 3-term normal dot (3 products, 2 additions)
FLOP_PER_PAIR = {"k2": 8, "k1": 13}
#: bytes a live row brings in: K2 a point (3 float32), K1 a point and its
#: normal; and a live query's output: K2 d2 and an int32 index, K1 d2
IN_BYTES_PER_ROW = {"k2": 12, "k1": 24}
OUT_BYTES_PER_QUERY = {"k2": 8, "k1": 4}
#: a row is live when every coordinate lies within this distance of the
#: origin: the program pads with points at 1e8 (rotated by a candidate
#: pose, still beyond 5e7), the scenes lie within tens of units
LIVE_LIMIT = 1.0e6


def launch_work(kind: str, live_q, live_r) -> tuple[float, float]:
    """(operations, bytes) a K1 (``kind`` "k1") or K2 ("k2") launch needs
    for the live rows it is given: ``live_q`` / ``live_r`` the live query
    and reference rows of each pair of the launch.  Every live query is
    compared with every live reference of its pair; each live input row is
    read once and each live query's output written once."""
    ops = nbytes = 0.0
    for q, r in zip(live_q, live_r):
        ops += FLOP_PER_PAIR[kind] * float(q) * float(r)
        nbytes += IN_BYTES_PER_ROW[kind] * float(q + r) \
            + OUT_BYTES_PER_QUERY[kind] * float(q)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs for ``ops`` and ``nbytes``: the larger
    of the two over their peaks."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def union_length(intervals) -> float:
    """Total length covered by ``intervals`` ((start, end) pairs), each
    instant counted once however many intervals cover it."""
    total = 0.0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out = []
    cursor = lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2

