"""A rank of the port's 2-process ``gloo`` world (``tests/test_torch_dist.py``
(e)), and the small pairs and config that file registers.

    python torch_multihost_worker.py RANK WORLD HOST:PORT OUT.npz

Each rank joins the group (``multihost.initialize``) and takes a CPU
mesh of one shard (``global_mesh``).  Of the 4 pairs of :func:`make_pairs`
(pair ``i`` from seed ``i``) it then registers, gathering every rank's
results each time:

* ``ragged``: rank 0 holds pairs 0-2, rank 1 pair 3; each forms its part
  of the batch (``local_batch_to_global``) and calls ``register_batch`` on
  the mesh;
* ``empty``: the same with rank 0 holding no pair and rank 1 pair 3;
* ``array``: ``register_array_pairs`` on pairs 0-2, one pair a shard at a
  time, so that rank 1 has no pair in the last chunk.

It writes the gathered results to ``OUT.npz`` (``ragged_transform``, ...)
and prints ``WORKER_OK rank=R`` at the end.  The world has no JAX: the
test process holds the results to its own.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from plade_tpu_torch.core.config import PladeConfig  # noqa: E402
from plade_tpu_torch.io.synthetic import make_room  # noqa: E402

#: ``tests/test_pipeline.py``'s SMALL_CFG with a 1-mode rescore and the
#: budgets cut to these scenes (those of ``tests/test_torch_batch.py`` (e))
CFG = PladeConfig(
    ransac_candidates_per_round=64, ransac_init_min_support=2000,
    ransac_min_allowed_support=200, min_planes=6, max_planes=12,
    bitmap_grid=64, bitmap_cc_iters=48, spacing_samples=500,
    max_ds_points=1024, max_plane_points=256, max_lines=128,
    max_query_pairs=1024, max_target_pairs=2048, max_matches=1024,
    max_pose_clusters=128, max_candidate_results=16,
    max_penetration_tests=256, rescore_top_k=1, overlap_grid=64,
    max_cluster_hypotheses=1024)
#: the padded cloud size of :func:`make_pairs`' clouds
PAD = 8192
#: the pairs of each rank of the 2-process world, by batch
RANK_PAIRS = {"ragged": ((0, 3), (3, 4)), "empty": ((0, 0), (3, 4))}
#: the pairs ``register_array_pairs`` registers there
ARRAY_PAIRS = 3


def make_pairs(n: int = 5):
    """``n`` rooms, each registered against a shifted copy of itself (the
    pairs of ``tests/test_torch_batch.py`` (e))."""
    rng = np.random.default_rng(4)
    pairs = []
    for k in range(n):
        pts, nrm, _ = make_room(rng, n_per_plane=800, noise=0.003,
                                extra_planes=3)
        pairs.append((pts, nrm, pts + 0.02 * k, nrm))
    return pairs


def stacked(pairs, side: int):
    """The targets (``side`` 0) or sources (1) of ``pairs``, padded to
    ``PAD`` rows on the CPU and stacked (a Cloud of 0 pairs for none)."""
    from plade_tpu_torch.dist.mesh import _stack_padded
    return _stack_padded([p[2 * side:2 * side + 2] for p in pairs], PAD,
                         "cpu")


def main():
    rank, world, addr, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from plade_tpu_torch.dist import mesh as mesh_mod
    from plade_tpu_torch.dist import multihost
    assert multihost.initialize(addr, world, rank, timeout=300.0)
    try:
        mesh = multihost.global_mesh(devices=["cpu"])
        assert (mesh.rank, mesh.world_size) == (rank, world), mesh
        pairs, saved = make_pairs(4), {}
        for name, ranks in RANK_PAIRS.items():
            lo, hi = ranks[rank]
            batch, offsets = multihost.local_batch_to_global(
                mesh, stacked(pairs[lo:hi], 0), stacked(pairs[lo:hi], 1),
                range(lo, hi))
            counts = [hi - lo for lo, hi in ranks]
            assert offsets == [0, counts[0], sum(counts)], offsets
            res = mesh_mod.register_batch(*batch, CFG, mesh)
            saved.update({f"{name}_{f}": x.numpy()
                          for f, x in zip(res._fields, res)})
        outs = mesh_mod.register_array_pairs(
            pairs[:ARRAY_PAIRS], CFG, seed=0, mesh=mesh, batch_pairs=1)
        saved.update({f"array_{f}": np.stack([getattr(o, f) for o in outs])
                      for f in ("transform", "success", "score", "overlap",
                                "matched_planes", "match_saturated",
                                "pen_overflow", "cluster_truncated")})
        np.savez(out, **saved)
    finally:
        dist.destroy_process_group()
    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
