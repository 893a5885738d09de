"""What the benchmark reads from inside the program: wrappers around its
K1/K2 entry points and its spacing, installed before the pipeline is
imported.

* K1 (``kernels.nn.oriented_min_dist_sq``) and K2
  (``kernels.nn.nearest_neighbor``): while tracing, each launch runs inside
  a ``regbench.k1`` / ``regbench.k2`` profiler range (its kernels are
  attributed by the range, whatever they are named) and its live rows are
  counted on the device (:data:`yardstick.LIVE_LIMIT`); while armed, each
  launch's inputs and outputs are cloned for the correctness check.
* the spacing (``pipeline.average_spacing``): the per-pair output of every
  call is kept (a tensor of one number a cloud) with a copy of each
  cloud's first point, by which the check finds the pair it belongs to
  (the shards of a mesh call it from threads of their own, in any order).

Between those, a wrapper only forwards the call.
"""
from __future__ import annotations

import threading

import torch

from .yardstick import LIVE_LIMIT


def _live(x: torch.Tensor) -> torch.Tensor:
    """Per pair (leading axis, or one) the rows of ``x`` ((P,) N, 3) whose
    coordinates all lie within :data:`LIVE_LIMIT`."""
    x = x if x.dim() == 3 else x[None]
    return torch.sum(torch.amax(torch.abs(x), dim=-1) < LIVE_LIMIT, dim=-1)


def _as_pairs(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x[None]


def installed() -> "Capture":
    """The process's :class:`Capture`, installed at the first call (the
    wrappers replace module attributes, so one serves every run of a
    process)."""
    global _INSTALLED
    if _INSTALLED is None:
        cap = Capture()
        cap.install()
        _INSTALLED = cap
    return _INSTALLED


_INSTALLED = None


class Capture:
    """The wrappers' state."""

    def __init__(self):
        self.lock = threading.Lock()
        self.tracing = False
        self.armed = False
        self.launches = []      # (kind, args, outputs), cloned, while armed
        self.live = []          # (kind, live_q tensor, live_r tensor)
        self.spacing = []       # (first points, spacings) since take

    # -- installation ------------------------------------------------------
    def install(self):
        """Wrap K1/K2 in ``plade_tpu_torch.kernels.nn`` and then the
        spacing in ``plade_tpu_torch.pipeline`` (imported here, after the
        wrap, so that every module binds the wrappers).  Raises when a
        nearest-neighbour pass of the pipeline does not reach them."""
        from plade_tpu_torch.kernels import nn
        nn.nearest_neighbor = self._kernel("k2", nn.nearest_neighbor)
        nn.oriented_min_dist_sq = self._kernel("k1",
                                               nn.oriented_min_dist_sq)
        from plade_tpu_torch import pipeline
        from plade_tpu_torch.knn import bruteforce
        pipeline.average_spacing = self._spacing(pipeline.average_spacing)
        one = bruteforce.ONE_DEVICE
        if one.nearest_neighbor is not nn.nearest_neighbor or \
                one.oriented_min_dist_sq is not nn.oriented_min_dist_sq:
            raise RuntimeError("the pipeline's K1/K2 passes were bound "
                               "before the benchmark's wrappers")

    def _kernel(self, kind: str, fn):
        def launch(*args):
            if self.tracing:
                with torch.profiler.record_function(f"regbench.{kind}"):
                    out = fn(*args)
                # queries, references: args 0 and 1 (K2), 0 and 2 (K1)
                live = (_live(args[0]), _live(args[1 if kind == "k2" else 2]))
                with self.lock:
                    self.live.append((kind, *live))
            else:
                out = fn(*args)
            if self.armed:
                kept = (tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args),
                        tuple(o.clone() for o in out) if isinstance(
                            out, tuple) else (out.clone(),))
                with self.lock:
                    self.launches.append((kind, *kept))
            return out
        launch.__wrapped__ = fn
        return launch

    def _spacing(self, fn):
        def spacing(points, *args, **kwargs):
            out = fn(points, *args, **kwargs)
            first = points[..., 0, :].clone()
            with self.lock:
                self.spacing.append((first, out))
            return out
        spacing.__wrapped__ = fn
        return spacing

    # -- reading -----------------------------------------------------------
    def take_spacing(self) -> list:
        """[(first points (B, 3), spacings (B,))] recorded since the last
        take."""
        with self.lock:
            got, self.spacing = self.spacing, []
        return [(f.reshape(-1, 3), t.reshape(-1)) for f, t in got]

    def take_live(self) -> list:
        """[(kind, live queries a pair, live references a pair)] of the
        launches traced since the last take, read on the host."""
        with self.lock:
            got, self.live = self.live, []
        return [(kind, q.reshape(-1).tolist(), r.reshape(-1).tolist())
                for kind, q, r in got]

    def take_launches(self) -> list:
        with self.lock:
            got, self.launches = self.launches, []
        return [(kind, tuple(_as_pairs(a) if torch.is_tensor(a) else a
                             for a in args),
                 tuple(o if o.dim() == 2 else o[None] for o in outs))
                for kind, args, outs in got]
