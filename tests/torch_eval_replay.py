"""Pairs of an evaluation scene through the JAX package and the port on the
same random draws, on the CPU (``tests/test_torch_eval.py`` (c), and the
per-pair rerun that tells draw variance from a fault of the port).

    JAX_PLATFORMS=cpu python tests/torch_eval_replay.py SCENE I,J [I,J ...] \\
        [--seed S] [--base DIR] [--stages]

The scene is a ``SCENES`` entry of ``plade_tpu_torch.tools.run_eval``,
built (or reused) under ``--base`` at its full ``N_POINTS``, and both
packages run at the full default ``PladeConfig()``.  The pairs ``I,J``
(target scan I, source scan J) register as the JAX package's
``register_array_pairs(pairs, cfg, seed)`` on a mesh of one device
registers them: pair ``k`` with the key ``split(PRNGKey(seed + k), 1)[0]``,
its target and source drawing from ``split(key)``.  The JAX side is
``plade_tpu.dist.mesh.register_batch`` on those keys, one pair a call; the
port's side is ``plade_tpu_torch.dist.mesh.register_batch`` on the same
keys' draws replayed through the extractor's ``draws=`` hook.  For each
pair it prints both packages' rotation and translation errors against the
ground truth, their success flags and the difference of their transforms:
the same result on the same draws makes a gap between the packages draw
variance, a different one a fault of the port.  ``--stages`` also
compares, pair by pair, where the two could part: the planes each package
extracts and selects for each cloud, the source's average spacing (both
packages', and the port's formula in float64), and the downsampled point
counts the spacing's voxel size gives.  At the default config a pair
takes minutes on a CPU.
"""
import argparse
import contextlib
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from plade_tpu.core.config import PladeConfig as JPladeConfig  # noqa: E402
from plade_tpu.core.types import pad_cloud as jpad_cloud  # noqa: E402
from plade_tpu import pipeline as jpipeline  # noqa: E402
from plade_tpu.dist import mesh as jmesh  # noqa: E402
from plade_tpu.extract import ransac as jransac  # noqa: E402
from plade_tpu_torch import pipeline as tpipeline  # noqa: E402
from plade_tpu_torch.dist import mesh as tmesh  # noqa: E402
from plade_tpu_torch.extract import ransac as transac  # noqa: E402
from plade_tpu_torch.io.ply import read_ply  # noqa: E402
from plade_tpu_torch.io.resso import rotation_error_deg  # noqa: E402
from plade_tpu_torch.pipeline import _pad_size  # noqa: E402
from test_torch_extract import _replayed_draws  # noqa: E402


def jax_keys(seed: int, n: int) -> list:
    """The keys the JAX package's ``register_array_pairs(..., seed)`` gives
    ``n`` pairs on a mesh of one device."""
    return [jax.random.split(jax.random.PRNGKey(seed + k), 1)[0]
            for k in range(n)]


def scene_pairs(scene, pairs):
    """(target points, normals, source points, normals) of scan pairs
    ``(i, j)`` of a loaded scene, and the padded size
    ``register_array_pairs`` gives them."""
    clouds = {k: read_ply(scene.scan_files[k]) for p in pairs for k in p}
    out = [(*clouds[i], *clouds[j]) for i, j in pairs]
    return out, max(max(p[0].shape[0], p[2].shape[0]) for p in out)


def port_on_draws(cloud_pairs, keys, cfg, pad: int):
    """The port's lockstep batch of ``cloud_pairs`` padded to ``pad`` rows,
    pair ``k`` on the draws of ``keys[k]`` (target, source from
    ``split(key)``); a ``RegistrationResult`` of CPU tensors."""
    stacked = [tmesh._stack_padded([p[2 * s:2 * s + 2] for p in cloud_pairs],
                                   pad, "cpu") for s in (0, 1)]
    draws = [_replayed_draws(k, pad, cfg) for key in keys
             for k in jax.random.split(key)]
    return tmesh.register_batch(*stacked, [0] * len(cloud_pairs), cfg,
                                device="cpu", draws=draws)


def jax_on_keys(cloud_pairs, keys, jcfg, pad: int):
    """The JAX package's ``register_batch`` on one CPU device, one pair a
    call with its key; (transforms, successes) as numpy arrays."""
    dev = jmesh.make_mesh(1, intra=1, devices=jax.devices("cpu")[:1])
    Ts, oks = [], []
    for p, key in zip(cloud_pairs, keys):
        tgt = jmesh.stack_clouds([jpad_cloud(p[0], p[1], pad)])
        src = jmesh.stack_clouds([jpad_cloud(p[2], p[3], pad)])
        res = jmesh.register_batch(tgt, src, jnp.stack([key]), jcfg, dev)
        Ts.append(np.asarray(res.transform[0]))
        oks.append(bool(res.success[0]))
    return np.stack(Ts), oks


def jax_stages(p, key, jcfg, pad: int):
    """The JAX package's step on one pair, stage by stage as its
    ``build_register_device_fn`` runs it, up to the preparation: (the
    target's and the source's selected ``PlaneSet``, the source's average
    spacing, the two downsampled point counts)."""
    tgt, src = jpad_cloud(p[0], p[1], pad), jpad_cloud(p[2], p[3], pad)
    extract = jransac.build_extract_fn(jcfg, pad, max_extract=64)
    floor = jnp.int32(jcfg.ransac_min_allowed_support)
    both, _ = jax.jit(jax.vmap(lambda q, n, c, k: extract(q, n, c, k,
                                                          floor)))(
        jnp.stack([tgt.points, src.points]),
        jnp.stack([tgt.normals, src.normals]),
        jnp.stack([tgt.count, src.count]), jnp.stack(jax.random.split(key)))
    planes = [jransac.select_planes_device(
        jax.tree.map(lambda x, s=s: x[s], both), jcfg) for s in (0, 1)]
    sp = jpipeline.average_spacing(src.points, src.mask, jcfg.spacing_k,
                                   jcfg.spacing_samples)
    dsd = jcfg.downsample_factor * sp
    ds = [int(jpipeline.voxel_downsample(c.points, c.mask, dsd,
                                         jcfg.max_ds_points).count)
          for c in (tgt, src)]
    return planes, float(sp), ds


@contextlib.contextmanager
def port_stages():
    """Records the port's selected planes, spacing and prepared clouds of
    the steps run inside the block (``out["planes"]``, ...)."""
    out = {}
    real = [(transac, "select_planes_device", "planes"),
            (tpipeline, "average_spacing", "spacing"),
            (tpipeline, "prepare_cloud", "prepared")]
    saved = [getattr(module, fn) for module, fn, _ in real]

    def recorder(fn, name):
        def call(*a, **k):
            out[name] = fn(*a, **k)
            return out[name]
        return call

    for (module, fn, name), orig in zip(real, saved):
        setattr(module, fn, recorder(orig, name))
    try:
        yield out
    finally:
        for (module, fn, _), orig in zip(real, saved):
            setattr(module, fn, orig)


def print_stages(cloud_pairs, keys, jcfg, pad: int, seen: dict, cfg):
    """Pair by pair, the JAX package's stages (:func:`jax_stages`) beside
    the port's recorded ones (the step's clouds: targets, then sources)."""
    B = len(cloud_pairs)
    for k, (p, key) in enumerate(zip(cloud_pairs, keys)):
        jplanes, jsp, jds = jax_stages(p, key, jcfg, pad)
        for side, jpl in enumerate(jplanes):
            c = side * B + k
            n, jn = int(seen["planes"].count[c]), int(jpl.count)
            m = min(n, jn)
            print(f"pair {k} {('target', 'source')[side]}: planes port {n} "
                  f"JAX {jn}, sizes equal "
                  f"{np.array_equal(seen['planes'].sizes[c][:m].numpy(), np.asarray(jpl.sizes)[:m])}"  # noqa: E501
                  f", point_plane equal "
                  f"{np.array_equal(seen['planes'].point_plane[c].numpy(), np.asarray(jpl.point_plane))}"  # noqa: E501
                  f", coefficients within "
                  f"{np.abs(seen['planes'].coeffs[c][:m].numpy() - np.asarray(jpl.coeffs)[:m]).max():.3e}",  # noqa: E501
                  flush=True)
        src = tmesh._stack_padded([p[2:4]], pad, "cpu")
        exact = tpipeline.average_spacing(src.points.double(), src.mask,
                                          cfg.spacing_k, cfg.spacing_samples)
        ds = seen["prepared"].ds.count
        print(f"pair {k}: source spacing port "
              f"{float(seen['spacing'][k]):.9g} JAX {jsp:.9g} float64 "
              f"{float(exact[0]):.9g}; downsampled points (target, source) "
              f"port ({int(ds[k])}, {int(ds[B + k])}) JAX {tuple(jds)}",
              flush=True)


def pose_error(scene, pair, T):
    """(rotation error in degrees, translation error) of ``T`` against the
    pair's ground truth."""
    G = scene.pair_ground_truth(*pair)
    return (rotation_error_deg(G[:3, :3], T[:3, :3]),
            float(np.linalg.norm(T[:3, 3] - G[:3, 3])))


def main(argv=None) -> int:
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.io.resso import load_scene
    from plade_tpu_torch.tools import run_eval

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("scene")
    parser.add_argument("pairs", nargs="+", help="I,J: target, source scan")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--base", default=run_eval.DEFAULT_BASE)
    parser.add_argument("--stages", action="store_true")
    args = parser.parse_args(argv)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    sc, = [s for s in run_eval.SCENES if s["name"] == args.scene]
    scene = load_scene(run_eval.build_scene(sc, args.base))
    pairs = [tuple(int(x) for x in p.split(",")) for p in args.pairs]
    cfg = PladeConfig()
    jcfg = JPladeConfig(**dataclasses.asdict(cfg))
    cloud_pairs, n = scene_pairs(scene, pairs)
    pad = _pad_size(n, maximum=cfg.max_points)
    keys = jax_keys(args.seed, len(pairs))
    t0 = time.perf_counter()
    jT, jok = jax_on_keys(cloud_pairs, keys, jcfg, pad)
    t1 = time.perf_counter()
    with port_stages() as seen:
        res = port_on_draws(cloud_pairs, keys, cfg, pad)
    t2 = time.perf_counter()
    print(f"{args.scene}: {len(pairs)} pairs padded to {pad}, seed "
          f"{args.seed}; JAX {t1 - t0:.1f} s, port "
          f"{t2 - t1:.1f} s (CPU)", flush=True)
    same = True
    for k, pair in enumerate(pairs):
        T = res.transform[k].numpy()
        ok = bool(res.success[k])
        jr, jt = pose_error(scene, pair, jT[k])
        pr, pt = pose_error(scene, pair, T)
        dr = rotation_error_deg(jT[k][:3, :3], T[:3, :3])
        dt = float(np.linalg.norm(jT[k][:3, 3] - T[:3, 3]))
        agree = ok == jok[k] and dr < 0.1 and dt < 1e-3
        same &= agree
        print(f"pair {pair}: JAX success {jok[k]} rot {jr:.3f} deg trans "
              f"{jt:.4f}; port success {ok} rot {pr:.3f} deg trans "
              f"{pt:.4f} (counters {int(res.match_saturated[k])}/"
              f"{int(res.pen_overflow[k])}/{int(res.cluster_truncated[k])})"
              f"; transforms differ by {dr:.4f} deg / {dt:.2e}: "
              f"{'same result' if agree else 'DIFFERENT'}", flush=True)
    if args.stages:
        print_stages(cloud_pairs, keys, jcfg, pad, seen, cfg)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
