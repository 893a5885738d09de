"""Several processes over one pairs axis (``plade_tpu/dist/multihost.py``).

N processes (one a host, or one a card) each register their own pairs on
their own devices; only the small ``RegistrationResult`` travels between
them, gathered so that every process gets every pair's result.  The
process group is ``torch.distributed`` on ``gloo``: the results cross
ranks as pickled CPU tensors (~200 bytes a pair), ``gloo`` lets two ranks share
one card (NCCL refuses that), and its timeout makes a rank that died fail
the others instead of hanging them.

Usage on each process (e.g. under ``torchrun --nproc-per-node N``, which
sets the environment variables read below):

    from plade_tpu_torch.dist import mesh as mesh_mod, multihost
    multihost.initialize()                 # torch.distributed over TCP
    mesh = multihost.global_mesh()         # this rank's cards, rank, world
    batch, offsets = multihost.local_batch_to_global(mesh, tgt, src, seeds)
    results = mesh_mod.register_batch(*batch, cfg, mesh)   # every pair
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..core.types import Cloud
from ..pipeline import _run_device
from . import mesh as mesh_mod


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: float = 600.0) -> bool:
    """Join the process group when running multi-process.

    The arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``coordinator_address`` is ``host:port``),
    ``WORLD_SIZE`` and ``RANK``.  A collective that waits longer than
    ``timeout`` seconds for another rank raises.  Returns True when a
    process group was joined (or already is), False for a single-process
    run (everything keeps working on the local devices)."""
    env = os.environ
    num = num_processes if num_processes is not None else \
        int(env.get("WORLD_SIZE", "1"))
    if num <= 1 and coordinator_address is None and "MASTER_ADDR" not in env:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = \
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    rank = process_id if process_id is not None else \
        int(env.get("RANK", "0"))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return True


def global_mesh(intra: int = 1, devices=None) -> mesh_mod.Mesh:
    """This process's part of the pairs axis, with its rank and the world
    size (rank 0 of 1 without a process group).  ``devices`` defaults to
    this process's cards: under torchrun with ``LOCAL_WORLD_SIZE`` dividing
    the visible cards, ``LOCAL_RANK``'s share of them (one card with one
    process a card), else every visible card."""
    if devices is None:
        _run_device("cuda")                   # raises without a card
        n = torch.cuda.device_count()
        local = os.environ.get("LOCAL_RANK")
        per = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
        if local is not None and per and n % per == 0:
            k = n // per
            devices = [f"cuda:{int(local) * k + j}" for j in range(k)]
    mesh = mesh_mod.make_mesh(intra=intra, devices=devices)
    if not dist.is_initialized():
        return mesh
    return mesh._replace(rank=dist.get_rank(),
                         world_size=dist.get_world_size(),
                         group=dist.group.WORLD)


def local_batch_to_global(mesh: mesh_mod.Mesh, local_tgt: Cloud,
                          local_src: Cloud, local_seeds):
    """This rank's pairs as its part of the global batch.

    Each rank passes its own pairs (any number, 0 included, the ranks'
    counts may differ), padded to one size with a leading pair axis, and
    one seed a pair.  The counts are all-gathered into global offsets: rank
    ``r``'s pairs are global pairs ``offsets[r]`` to ``offsets[r + 1]``,
    the rows where they land in the results that every rank gets.  Returns
    ``((tgt, src, seeds), offsets)``: the batch :func:`mesh.register_batch`
    takes on ``mesh``, and the offsets."""
    B = local_tgt.points.shape[0]
    seeds = [int(s) for s in local_seeds]
    if local_src.points.shape[0] != B or len(seeds) != B:
        raise ValueError(f"local batch: {B} targets, "
                         f"{local_src.points.shape[0]} sources, "
                         f"{len(seeds)} seeds")
    counts = [B]
    if mesh.world_size > 1:
        counts = [None] * mesh.world_size
        dist.all_gather_object(counts, B, group=mesh.group)
    offsets = [0]
    for c in counts:
        offsets.append(offsets[-1] + c)
    return (local_tgt, local_src, seeds), offsets
