"""K5's inputs from real registrations: the ``run_tests`` call of one
registration of regbench pool pairs on the card, shared by the port's card
tests and ``chip_smoke.py``, which import it by name.  Torch only: the card
tests import no JAX."""
import json
from pathlib import Path

import torch

CONFIGS = Path(__file__).resolve().parent.parent / "regbench" / "configs"


def pool_walk(config: str, B: int, entry: str = "register_array_pairs",
              seed: int = 7):
    """Registers the first ``B`` pool pairs of regbench's configuration
    ``config`` on the card at its ``PladeConfig``, through ``entry``: the
    batch cells' ``register_array_pairs`` (one lockstep batch of ``B``) or
    the single cell's ``register_clouds`` (``B`` = 1).  Returns each
    ``penetration.run_tests`` call of that run as (args, keywords, its
    verdicts), CUDA tensors, and the K5 launches the run counted."""
    from plade_tpu_torch import pipeline
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.dist import mesh
    from plade_tpu_torch.kernels.build import LAUNCHES
    from plade_tpu_torch.verify import penetration
    from regbench import scenes
    spec = json.loads((CONFIGS / f"{config}.json").read_text())
    cfg = PladeConfig(**spec["plade_config"])
    pairs = []
    for group in spec["pool"]:
        pairs += scenes.build_pool([group])
        if len(pairs) >= B:
            break
    pairs = pairs[:B]
    seen = []
    real = penetration.run_tests

    def recorded(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, kw, out))
        return out
    penetration.run_tests = recorded
    before = LAUNCHES["penetration_walk"]
    try:
        if entry == "register_clouds":
            assert B == 1, "register_clouds registers one pair a call"
            p = pairs[0]
            pipeline.register_clouds(p.tgt_points, p.tgt_normals,
                                     p.src_points, p.src_normals, cfg, seed,
                                     device="cuda:0")
        else:
            mesh.register_array_pairs(
                [(p.tgt_points, p.tgt_normals, p.src_points, p.src_normals)
                 for p in pairs], cfg, seed=seed, device="cuda:0",
                batch_pairs=B)
        torch.cuda.synchronize()
    finally:
        penetration.run_tests = real
    return seen, LAUNCHES["penetration_walk"] - before
