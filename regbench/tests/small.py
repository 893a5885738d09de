"""A cell at a size the CPU holds: a few small rooms, each split into two
halves of 6750 points, registered at a small PladeConfig (that of
the port's CPU tests of the mesh and the batch)."""
from __future__ import annotations

from regbench.harness import Spec, _json, HERE

#: ``tests/torch_multihost_worker.py``'s CFG over the default config
SMALL = dict(
    ransac_candidates_per_round=64, ransac_init_min_support=2000,
    ransac_min_allowed_support=200, min_planes=6, max_planes=12,
    bitmap_grid=64, bitmap_cc_iters=48, spacing_samples=500,
    max_ds_points=1024, max_plane_points=256, max_lines=128,
    max_query_pairs=1024, max_target_pairs=2048, max_matches=1024,
    max_pose_clusters=128, max_candidate_results=16,
    max_penetration_tests=256, rescore_top_k=1, overlap_grid=64,
    max_cluster_hypotheses=1024)


#: the small cell's limits: float32 against float64 reads ~1e-6 for the
#: spacing and ~2e-7 for K1/K2
LIMITS = {"rows_per_launch": 512, "spacing_gap": 1e-4, "k2_gap": 1e-5,
          "k1_gap": 1e-5}


def small_config(rooms: int = 3) -> dict:
    config = _json(HERE / "configs" / "resso60k.json")
    config["plade_config"] = {**config["plade_config"], **SMALL}
    # its rooms all register on the CPU: a quarter of them missed fails
    config["min_recall"] = 0.75
    config["pool"] = [
        {"kind": "room_halves", "name": f"room{k}", "seed": 10 + k,
         "n_per_plane": 1500, "noise": 0.003, "extra_planes": 3,
         "normal_noise_deg": 1.0, "max_angle": 0.6, "max_trans": 0.3}
        for k in range(rooms)]
    return config


def small_spec(traffic: str, chips: int = 1, rooms: int = 3, **changes):
    """A cell of :func:`small_config` under the mix ``traffic`` (with
    ``changes`` to the mix) and :data:`LIMITS`."""
    mix = {**_json(HERE / "traffic" / f"{traffic}.json"), **changes}
    cell = {"name": f"small.{traffic}", "config": "small",
            "traffic": traffic, "chips": chips}
    return Spec(cell, small_config(rooms), mix, dict(LIMITS), [], [])
