"""One pair's nearest-neighbour passes over a group of devices: the
``intra`` axis of the reference's ``(pairs, intra)`` mesh
(``plade_tpu/dist/mesh.py``).

The reference shards each pair's point buffers over its group and lets
GSPMD choose the collectives.  Here the split is explicit, and it covers
only the passes whose work grows as queries x references and that need
nothing between devices but a gather of their rows: the spacing's exact
top-k, K1 in overlap phase 2 and the rescore, and K2 in the ICPs.  Each
computes every query (or block of queries) on its own, so the split result
is the one launch's, bit for bit.  Every other stage runs on the group's
first device, its home.

A group is a tuple of devices, home first; a device may stand more than
once (several parts on one card, each on a stream of its own).
:func:`on_group` binds a group into the ``knn.bruteforce.NNPasses`` that
the step hands down to its stages, which call them as they would call the
one-device passes.  Parts on distinct cards (a copy between two cards) are
written for, but no run has yet had two cards.
"""
from __future__ import annotations

import torch

from ..knn.bruteforce import (ONE_DEVICE, NNPasses, min_dist_sq,
                              nearest_neighbor, oriented_min_dist_sq,
                              topk_block, topk_dist_sq)

#: each helper part's stream, by (home's stream, device, part): drawn once
#: and reused, so that the caching allocator keeps blocks for a fixed set
#: of streams
_STREAMS: dict = {}


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _helper_stream(home_stream, device: torch.device, part: int):
    """The stream of a part that is not home's, one for each home stream,
    device and part, never home's own stream."""
    key = (home_stream, device, part)
    stream = _STREAMS.get(key)
    if stream is None:
        stream = torch.cuda.Stream(device)
        if stream == home_stream:
            # the pool hands its streams out in turn, so the next differs
            stream = torch.cuda.Stream(device)
        stream = _STREAMS.setdefault(key, stream)
    return stream


def query_cuts(Q: int, parts: int, align: int = 1) -> list[int]:
    """Offsets of ``Q`` query rows cut into ``parts`` contiguous parts at
    multiples of ``align``: whole blocks of ``align`` rows, their counts
    within 1 of each other (the larger first), then the last part takes
    the rows of the partial block, so that the parts differ by at most
    ``align`` rows.  A part may be empty."""
    full, rest = divmod(Q, align)
    q, r = divmod(full, parts)
    cuts = [(i * q + min(i, r)) * align for i in range(parts + 1)]
    cuts[-1] = Q
    return cuts


def _each(fn, out):
    """``fn`` on a tensor, or on each tensor of a tuple."""
    return tuple(map(fn, out)) if isinstance(out, tuple) else fn(out)


def split_queries(fn, devices, per_query, shared, align: int = 1):
    """``fn(*per_query, *shared)`` with the query rows of ``per_query``
    (axis -2, under any leading axes) split over ``devices`` (home first):
    each part, cut by :func:`query_cuts`, and ``shared`` go to its device,
    ``fn`` runs there, and the outputs (a tensor or a tuple of tensors with
    the queries on the inputs' query axis) are concatenated on home in row
    order.  An empty part launches nothing.

    On CUDA, home's part runs on home's current stream and every other
    part on a stream of its own device (:func:`_helper_stream`), ordered
    after home's work with events; home's stream waits for every part.  No host read is made.
    With one device ``fn`` is called as it is."""
    devices = tuple(_indexed(d) for d in devices)
    if len(devices) <= 1:
        return fn(*per_query, *shared)
    home = per_query[0].device
    dim = per_query[0].dim() - 2
    cuts = query_cuts(per_query[0].shape[dim], len(devices), align)
    jobs = [(i, d, lo, hi) for i, (d, lo, hi)
            in enumerate(zip(devices, cuts, cuts[1:])) if hi > lo]
    if not jobs:
        return fn(*per_query, *shared)
    home_stream = torch.cuda.current_stream(home) if home.type == "cuda" \
        else None
    outs = []
    for i, d, lo, hi in jobs:
        if d.type != "cuda" or (d == home and lo == 0):
            # home's part, or a part on the CPU, on the current stream
            out = fn(*(x[..., lo:hi, :].contiguous().to(d)
                       for x in per_query), *(x.to(d) for x in shared))
            outs.append(_each(lambda o: o.to(home), out))
            continue
        stream = _helper_stream(home_stream, d, i)
        if home_stream is not None:
            stream.wait_stream(home_stream)
        if d == home:
            # read on ``stream``: the allocator must not hand their memory
            # out again before ``stream`` is done with it
            for x in (*per_query, *shared):
                x.record_stream(stream)
        # card to card, no copy waits for the host (one from or to a CPU
        # home does)
        non_blocking = home_stream is not None
        with torch.cuda.device(d), torch.cuda.stream(stream):
            # a copy between two cards runs on the source card's current
            # stream and makes the destination's current stream wait
            out = fn(*(x[..., lo:hi, :].contiguous().to(
                d, non_blocking=non_blocking) for x in per_query),
                *(x.to(d, non_blocking=non_blocking) for x in shared))
            out = _each(lambda o: o.to(home, non_blocking=non_blocking),
                        out)
        if home_stream is not None:
            home_stream.wait_stream(stream)
            if d == home:
                # made on ``stream`` and read on home's by the concat
                _each(lambda o: o.record_stream(home_stream), out)
        outs.append(out)
    if not isinstance(outs[0], tuple):
        return torch.cat(outs, dim=dim)
    return tuple(torch.cat(parts, dim=dim) for parts in zip(*outs))


def on_group(devices) -> NNPasses:
    """The nearest-neighbour passes over the group ``devices`` (home
    first), each splitting its query rows by :func:`split_queries`: the
    top-k at the whole call's block boundaries, so that a part on a CPU
    runs the unsplit call's blocks of the plain version (K4, on a card,
    gives each query the same bits whatever the cut).  With one device,
    the one-device passes."""
    devices = tuple(_indexed(d) for d in devices)
    if len(devices) <= 1:
        return ONE_DEVICE

    def topk(queries, refs, k, block=512):
        block = topk_block(queries, refs, block)
        return split_queries(lambda q, r: topk_dist_sq(q, r, k, block),
                             devices, [queries], [refs], align=block)

    def oriented(queries, qnormals, refs, rnormals, normal_cos):
        return split_queries(
            lambda *a: oriented_min_dist_sq(*a, normal_cos), devices,
            [queries, qnormals], [refs, rnormals])

    return NNPasses(
        min_dist_sq=lambda q, r: split_queries(min_dist_sq, devices, [q],
                                               [r]),
        oriented_min_dist_sq=oriented,
        nearest_neighbor=lambda q, r: split_queries(nearest_neighbor,
                                                    devices, [q], [r]),
        topk_dist_sq=topk)
