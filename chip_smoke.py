"""Smoke run of the PyTorch/CUDA port (``plade_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

(a) build the CUDA kernels from ``plade_tpu_torch/csrc``;
(b) hold each kernel against its plain PyTorch version on the card at the
    main path's shapes, with padded references, a query whose normal
    disagrees with every reference normal (+inf row) and duplicated
    references (ties), and time both;
(c) register a synthetic room (two disjoint halves of 96k points, the
    source moved by a known rigid transform, planes labelled from the
    generator planes) with ``register_with_planes`` at the default
    ``PladeConfig``: one warm-up, then three timed runs; the kernel launch
    counts and host syncs are those of the first timed run;
(d) profile one more registration of that scene: device time per
    pipeline stage, kernels launched, the device's busy share;
(e) register a small scene on the card and on the CPU (plain kernel
    versions) and require the same result.

The last lines are the kernels' JSON line, the card's name and power limit
from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

#: relative tolerance of a kernel's d2 against its plain version.  The
#: kernels and the plain versions compute d2 with the same operations in
#: the same order (csrc/nn.cu is built without fused multiply-add).
D2_RTOL = 1e-6
ROT_TOL_DEG = 1.0
TRANS_TOL = 0.05


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` of one call's device time, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(Q: int, T: int, seed: int = 0, device: str = "cuda"):
    """Points in a 4 m room-sized box; reference normals within ~25 deg of
    +z so that query 3, whose normal is -z, passes no gate."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(Q, 3, device=device, generator=g) * 4.0 - 2.0
    r = torch.rand(T, 3, device=device, generator=g) * 4.0 - 2.0
    qn = torch.nn.functional.normalize(
        torch.randn(Q, 3, device=device, generator=g), dim=1)
    rn = torch.nn.functional.normalize(
        torch.randn(T, 3, device=device, generator=g).clamp(-3, 3) * 0.15
        + torch.tensor([0.0, 0.0, 1.0], device=device), dim=1)
    r[10:20] = r[5]                   # duplicated refs: ties
    q[0:4] = r[5]                     # queries exactly on the duplicates
    qn[0:3] = torch.tensor([0.0, 0.0, 1.0], device=device)   # gates pass
    qn[3] = torch.tensor([0.0, 0.0, -1.0], device=device)     # none passes
    r[T - 512:] = 1.0e8               # padded refs: BIG, zero normals
    rn[T - 512:] = 0.0
    q[Q - 256:] = 1.0e8               # padded queries: finite, masked later
    return (q.contiguous(), qn.contiguous(), r.contiguous(),
            rn.contiguous())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() / b.abs().clamp(min=1e-30)


def check_kernels(nn):
    Q, T, cos = 131072, 16384, 0.7071067811865476
    q, qn, r, rn = kernel_inputs(Q, T)
    rows = []

    # K2: nearest_neighbor
    d, i = nn.nearest_neighbor(q, r)
    torch.cuda.synchronize()
    dp, ip = nn.nearest_neighbor_plain(q, r)
    if not torch.isfinite(d).all():
        fail("nearest_neighbor: non-finite d2")
    err = rel_err(d, dp)
    if err.max().item() > D2_RTOL:
        fail(f"nearest_neighbor: d2 rel err {err.max().item()}")
    qd = q.double()
    rd = r.double()
    da = ((qd - rd[i.long()]) ** 2).sum(1)
    db = ((qd - rd[ip.long()]) ** 2).sum(1)
    off = (i != ip) & ((da - db).abs() > D2_RTOL * db.clamp(min=1e-30))
    if off.any():
        fail(f"nearest_neighbor: {int(off.sum())} argmin disagreements off "
             "near-ties")
    if not (i[0:4] == 5).all():
        fail(f"nearest_neighbor: tie rule broken, got {i[0:4].tolist()}")
    agree = (i == ip).float().mean().item()
    ms = cuda_ms(lambda: nn.nearest_neighbor(q, r))
    plain_ms = cuda_ms(lambda: nn.nearest_neighbor_plain(q, r))
    print(f"[b] K2 nearest_neighbor Q={Q} T={T}: max abs d2 diff "
          f"{(d - dp).abs().max().item():.3e}, max rel {err.max().item():.3e}"
          f", argmin agreement {agree:.6f}, kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    rows.append({"name": "nearest_neighbor", "route": "cuda",
                 "source": "plade_tpu_torch/csrc/nn.cu",
                 "replaces": "plade_tpu/kernels/nn.py:87",
                 "max_abs_err": (d - dp).abs().max().item(), "ms": ms,
                 "plain_ms": plain_ms})

    # K1: oriented_min_dist_sq
    o = nn.oriented_min_dist_sq(q, qn, r, rn, cos)
    torch.cuda.synchronize()
    op = nn.oriented_min_dist_sq_plain(q, qn, r, rn, cos)
    fin = torch.isfinite(op)
    if not torch.equal(torch.isfinite(o), fin):
        fail("oriented_min_dist_sq: +inf rows differ")
    if fin[3].item() or not fin[:3].all():
        fail("oriented_min_dist_sq: gate rows wrong")
    if torch.isnan(o).any():
        fail("oriented_min_dist_sq: NaN")
    err = rel_err(o[fin], op[fin])
    if err.max().item() > D2_RTOL:
        fail(f"oriented_min_dist_sq: d2 rel err {err.max().item()}")
    abs_err = (o[fin] - op[fin]).abs().max().item()
    ms = cuda_ms(lambda: nn.oriented_min_dist_sq(q, qn, r, rn, cos))
    plain_ms = cuda_ms(lambda: nn.oriented_min_dist_sq_plain(q, qn, r, rn,
                                                             cos))
    print(f"[b] K1 oriented_min_dist_sq Q={Q} T={T}: max abs d2 diff "
          f"{abs_err:.3e}, max rel {err.max().item():.3e}, +inf rows "
          f"{int((~fin).sum())} (agree), kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    rows.append({"name": "oriented_min_dist_sq", "route": "cuda",
                 "source": "plade_tpu_torch/csrc/nn.cu",
                 "replaces": "plade_tpu/kernels/nn.py:182",
                 "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms})
    return rows


def generator_labels(points, gen_planes, max_planes):
    """Label each point with the nearest generator plane within 0.01 (-1
    for none); labels are renumbered by size, descending, and cut to
    ``max_planes``.  Returns (point_plane (N,) int32, number of planes)."""
    n = np.stack([np.asarray(p[0], np.float64) for p in gen_planes])
    d = np.array([p[1] for p in gen_planes], np.float64)
    dist = np.abs(points.astype(np.float64) @ n.T + d)      # (N, G)
    lab = np.argmin(dist, axis=1)
    lab[dist[np.arange(len(lab)), lab] > 0.01] = -1
    sizes = np.bincount(lab[lab >= 0], minlength=len(gen_planes))
    order = np.argsort(-sizes, kind="stable")
    order = order[sizes[order] > 0][:max_planes]
    point_plane = np.full(points.shape[0], -1, np.int32)
    for k, g in enumerate(order):
        point_plane[lab == g] = k
    return point_plane, len(order)


def fit_planes(points, normals, point_plane, count, max_planes, PlaneSet):
    """PlaneSet of labelled points: each label refit by PCA and oriented to
    its points' mean normal, padded to ``max_planes``."""
    coeffs = np.zeros((max_planes, 4), np.float32)
    sizes = np.zeros(max_planes, np.int32)
    for k in range(count):
        sel = point_plane == k
        p = points[sel].astype(np.float64)
        c = p.mean(0)
        _, v = np.linalg.eigh(np.cov((p - c).T))
        nk = v[:, 0]
        if nk @ normals[sel].mean(0) < 0:
            nk = -nk
        coeffs[k] = (*nk, -nk @ c)
        sizes[k] = sel.sum()
    return PlaneSet(coeffs=coeffs, sizes=sizes, count=np.int32(count),
                    point_plane=point_plane)


def make_scene(n_per_plane, seed, PlaneSet, max_planes, syn):
    """A room split into two disjoint random halves, the source half moved
    by a known rigid transform, each half with planes labelled from the
    generator planes (in the world frame) and refit in its own frame."""
    rng = np.random.default_rng(seed)
    pts, nrm, gen = syn.make_room(rng, n_per_plane=n_per_plane, noise=0.002,
                                  extra_planes=6, normal_noise_deg=2.0)
    perm = rng.permutation(pts.shape[0])
    half = pts.shape[0] // 2
    ti, si = perm[:half], perm[half:]
    R, t = syn.random_rigid(rng, max_angle=1.0, max_trans=0.5)
    spts, snrm = syn.transform_cloud(pts[si], nrm[si], R.T, -R.T @ t)
    tgt_planes = fit_planes(pts[ti], nrm[ti],
                            *generator_labels(pts[ti], gen, max_planes),
                            max_planes, PlaneSet)
    src_planes = fit_planes(spts, snrm,
                            *generator_labels(pts[si], gen, max_planes),
                            max_planes, PlaneSet)
    return (pts[ti], nrm[ti], spts, snrm, tgt_planes, src_planes, R, t)


def pose_errors(T, R, t):
    """(rotation error in degrees, translation error) of T against (R, t).
    The angle comes from ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), which
    resolves small angles in float32 where the trace form's arccos does
    not (it bottoms out near 0.03 deg)."""
    d = np.linalg.norm(T[:3, :3].astype(np.float64) - R)
    rot = math.degrees(2.0 * math.asin(min(1.0, d / (2.0 * math.sqrt(2.0)))))
    return rot, float(np.linalg.norm(T[:3, 3] - t))


def check_result(tag, T, info):
    if T.shape != (4, 4) or not np.isfinite(T).all():
        fail(f"{tag}: transform not a finite 4x4: {T}")
    for key in ("score", "overlap"):
        if not math.isfinite(info[key]):
            fail(f"{tag}: {key} not finite")
    if not info.get("success"):
        fail(f"{tag}: registration failed: {info}")


def profile_stages(run):
    """One profiled call of ``run``: device time per pipeline stage (the
    ``plade.*`` profiler ranges), kernels launched, and the device's busy
    share of the wall time.  Kernels are attributed to the stage whose
    host range encloses their launch (matched by correlation id in the
    exported trace)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("plade."))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    per_stage = {name: [0.0, 0, end - start] for start, end, name in stages}
    other = [0.0, 0]
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        slot = other
        for start, end, name in stages:
            if ts is not None and start <= ts <= end:
                slot = per_stage[name]
                break
        slot[0] += e["dur"]
        slot[1] += e.get("cat") == "kernel"
    busy_us = sum(e["dur"] for e in device)
    print(f"[d] profiled registration: wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"kernels {sum(e.get('cat') == 'kernel' for e in device)}",
          flush=True)
    print("[d] stage            host ms   device ms  kernels", flush=True)
    for name, (dev_us, n, host_us) in per_stage.items():
        print(f"[d] {name:<18}{host_us / 1e3:8.2f}  {dev_us / 1e3:9.2f}  "
              f"{n:7d}", flush=True)
    print(f"[d] {'(outside)':<18}{'':8}  {other[0] / 1e3:9.2f}  "
          f"{other[1]:7d}", flush=True)
    if busy_us <= 0:
        fail("profiler saw no device time")


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", flush=True)
        sys.exit(2)
    from plade_tpu_torch.core import types as ptypes
    from plade_tpu_torch.core.config import PladeConfig
    from plade_tpu_torch.io import synthetic as syn
    from plade_tpu_torch.kernels import build, nn
    from plade_tpu_torch.pipeline import register_with_planes

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}", flush=True)

    # (a) build
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"[a] kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # (b) kernels against their plain versions
    rows = check_kernels(nn)

    # (c) the slice at the default config
    cfg = PladeConfig()
    tp, tn, sp, sn, tpl, spl, R, t = make_scene(16000, 0, ptypes.PlaneSet,
                                               cfg.max_planes, syn)
    print(f"[c] scene: target {tp.shape[0]} pts / {int(tpl.count)} planes, "
          f"source {sp.shape[0]} pts / {int(spl.count)} planes", flush=True)
    T, info = register_with_planes(tp, tn, sp, sn, tpl, spl, cfg,
                                   device="cuda")          # warm-up
    walls = []
    for run in range(3):
        if run == 0:
            for k in nn.LAUNCHES:
                nn.LAUNCHES[k] = 0
            ptypes.HOST_SYNCS["count"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, info = register_with_planes(tp, tn, sp, sn, tpl, spl, cfg,
                                       device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            launches = dict(nn.LAUNCHES)
            syncs = ptypes.HOST_SYNCS["count"]
    check_result("[c]", T, info)
    rot, trans = pose_errors(T, R, t)
    print(f"[c] rotation error {rot:.6f} deg, translation error {trans:.6f}"
          f", matched_planes {info['matched_planes']}, score "
          f"{info['score']:.6f}, overlap {info['overlap']:.6f}", flush=True)
    print(f"[c] counters: match_saturated {info['match_saturated']}, "
          f"pen_overflow {info['pen_overflow']}, cluster_truncated "
          f"{info['cluster_truncated']}", flush=True)
    print(f"[c] launches per registration: {launches}; host syncs "
          f"{syncs}; wall per pair (median of 3) "
          f"{statistics.median(walls) * 1e3:.1f} ms, runs "
          f"{[round(w * 1e3, 1) for w in walls]} ms", flush=True)
    if rot >= ROT_TOL_DEG or trans >= TRANS_TOL:
        fail(f"pose error {rot} deg / {trans} beyond {ROT_TOL_DEG} / "
             f"{TRANS_TOL}")
    for key in ("match_saturated", "pen_overflow", "cluster_truncated"):
        if info[key] != 0:
            fail(f"{key} = {info[key]}")
    if launches["oriented_min_dist_sq"] < 2 or launches["nearest_neighbor"] \
            < 4:
        fail(f"kernel launches {launches} below K1 >= 2, K2 >= 4")
    for row in rows:
        row["launches"] = launches[row["name"]]

    # (d) one profiled registration: where the time goes
    profile_stages(lambda: register_with_planes(tp, tn, sp, sn, tpl, spl,
                                                cfg, device="cuda"))

    # (e) small scene: the card against the CPU (plain kernel versions)
    small = dataclasses.replace(
        cfg, max_ds_points=4096, max_plane_points=1024, max_lines=128,
        max_query_pairs=2048, max_target_pairs=4096, max_matches=8192,
        max_pose_clusters=512, max_candidate_results=64,
        max_penetration_tests=1024, spacing_samples=2000, max_planes=12)
    tp, tn, sp, sn, tpl, spl, R, t = make_scene(1500, 1, ptypes.PlaneSet,
                                               small.max_planes, syn)
    Tg, ig = register_with_planes(tp, tn, sp, sn, tpl, spl, small,
                                  device="cuda")
    Tc, ic = register_with_planes(tp, tn, sp, sn, tpl, spl, small,
                                  device="cpu")
    check_result("[e] gpu", Tg, ig)
    check_result("[e] cpu", Tc, ic)
    drot, dtrans = pose_errors(Tg, Tc[:3, :3], Tc[:3, 3])
    print(f"[e] small scene, card vs CPU: rotation diff {drot:.6f} deg, "
          f"translation diff {dtrans:.3e}, score {ig['score']:.6f} vs "
          f"{ic['score']:.6f}, matched_planes {ig['matched_planes']} vs "
          f"{ic['matched_planes']}", flush=True)
    if drot >= 0.1 or dtrans >= 1e-3 \
            or ig["matched_planes"] != ic["matched_planes"] \
            or abs(ig["score"] - ic["score"]) >= 1e-3:
        fail("card and CPU disagree on the small scene")

    print(json.dumps({"kernels": rows}))
    print(gpu_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
