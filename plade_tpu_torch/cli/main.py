"""Command-line interface mirroring the reference's two usage modes
(code/PLADE/main.cpp:30-159); the port of ``plade_tpu/cli/main.py``:

  python -m plade_tpu_torch.cli  target.ply source.ply result.txt   # single
  python -m plade_tpu_torch.cli  file_pairs.txt result.txt          # batch

Extensions over the reference (flagged, defaults match reference behavior):
  --icp          enable point-to-plane ICP refinement
  --seed N       explicit PRNG seed (reference uses time(0) —
                 RansacShapeDetector.cpp:463; we default to 0 for
                 reproducibility)
  --device-batch run batch pairs through the device step
                 (dist/mesh.register_array_pairs) instead of the sequential
                 host loop: 8 pairs at a time (its ``batch_pairs``) in
                 lockstep, each kernel launched once for all of them
  --resume       batch mode: record per-pair results in a sidecar state
                 file and skip already-completed pairs on restart
                 (checkpoint/resume — absent from the reference); the state
                 file is interchangeable with ``plade_tpu.cli``'s
  --profile DIR  write a torch.profiler Chrome trace of the run to
                 DIR/trace.json (CPU activity, and CUDA activity on the card)
  --device DEV   where the registration runs: ``cuda`` (the default; no
                 card raises) or ``cpu``
  scene DIR OUT  register a scan directory pairwise + pose-graph sync
  view RES OUT   ResultViewer: OUT.html -> self-contained interactive
                 WebGL viewer; other OUT -> transformed-PLY export
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

USAGE = """PLADE-TPU registers two point clouds dominated by planar structures.

Usage 1 (single pair):   plade-tpu target.ply source.ply result.txt
Usage 2 (batch):         plade-tpu file_pairs.txt result.txt
  The pairs file lists two file names per pair on consecutive lines:
  target first, then source. Results are 4x4 matrices aligning each
  source to its target."""


def _format_matrix(T: np.ndarray) -> str:
    # Eigen's default: rows on lines, space-separated
    return "\n".join(" ".join(f"{v:.6g}" for v in row) for row in T)


def _write_single(out, target, source, T, ok):
    out.write(f"target: {target}\n")
    out.write(f"source: {source}\n")
    if ok:
        out.write("transformation:\n" + _format_matrix(T) + "\n")
    else:
        out.write("registration failed, an identity matrix is recorded:\n"
                  + _format_matrix(np.eye(4)) + "\n")


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """Trace the block with ``torch.profiler`` and write its Chrome trace
    to ``trace_dir/trace.json``; a no-op when ``trace_dir`` is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="plade-tpu", usage=USAGE, add_help=True)
    parser.add_argument("paths", nargs="+",
                        help="target.ply source.ply result.txt | pairs.txt result.txt")
    parser.add_argument("--icp", action="store_true",
                        help="enable point-to-plane ICP refinement")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device-batch", action="store_true",
                        help="batch mode: run pairs through the device "
                             "step, 8 at a time in lockstep "
                             "(register_array_pairs' batch_pairs)")
    parser.add_argument("--resume", action="store_true",
                        help="batch mode: checkpoint per-pair results and "
                             "skip completed pairs on restart")
    parser.add_argument("--loop-stride", type=int, default=0,
                        help="scene mode: extra loop-closure pairs (i, i+k)")
    parser.add_argument("--gt", default=None,
                        help="scene mode: ground-truth pose file")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to "
                             "DIR/trace.json")
    parser.add_argument("--device", default="cuda",
                        help="where to register: cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..core.config import PladeConfig
    from ..pipeline import _run_device
    cfg = PladeConfig(enable_icp=True) if args.icp else PladeConfig()
    # no card and no --device cpu raises here, before any file is opened
    device = _run_device(args.device)

    with _profiled(args.profile, device):
        if args.paths[0] == "scene" and len(args.paths) == 3:
            from .scene import run_scene
            return run_scene(args.paths[1], args.paths[2], cfg, args.seed,
                             args.loop_stride, args.gt,
                             device_batch=args.device_batch, device=device)
        if args.paths[0] == "view" and len(args.paths) == 3:
            # RESULT OUT.html -> interactive WebGL viewer (self-contained
            # file, the ResultViewer equivalent); any other OUT -> headless
            # transformed-PLY export
            if args.paths[2].endswith(".html"):
                from .viewer import export_html
                return export_html(args.paths[1], args.paths[2])
            from .scene import export_view
            return export_view(args.paths[1], args.paths[2])
        if len(args.paths) == 3:
            target, source, result_file = args.paths
            return _run_single(target, source, result_file, cfg, args.seed,
                               device)
        if len(args.paths) == 2:
            pairs_file, result_file = args.paths
            return _run_batch(pairs_file, result_file, cfg, args.seed,
                              args.device_batch, args.resume, device)
    parser.error("expected 2 (batch) or 3 (single pair) positional paths")
    return 2


def _run_single(target, source, result_file, cfg, seed, device) -> int:
    from ..pipeline import register_files
    try:
        with open(result_file, "w") as out:
            try:
                T, info = register_files(target, source, cfg, seed,
                                         device=device)
                ok = bool(info.get("success"))
                if not ok:
                    reason = info.get("failure", "no verified candidate")
                    print(f"registration failed: {reason} (info: {info})",
                          file=sys.stderr)
            except (ValueError, FileNotFoundError) as e:
                print(f"registration failed: {e}", file=sys.stderr)
                T, ok = np.eye(4), False
            _write_single(out, target, source, T, ok)
    except OSError:
        print(f"failed opening the result file: {result_file}",
              file=sys.stderr)
        return 1
    if ok:
        print(f"the registration result has been written into file: "
              f"{result_file}")
        return 0
    return 1


def _read_pairs(pairs_file):
    """Two non-empty lines per pair; missing files skipped with a warning
    (main.cpp:110-133)."""
    pairs, pending = [], []
    with open(pairs_file) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            if not os.path.isfile(name):
                print(f"file doesn't exist: {name}", file=sys.stderr)
                continue
            pending.append(name)
            if len(pending) == 2:
                pairs.append(tuple(pending))
                pending = []
    return pairs


def _run_key(cfg, seed, pairs) -> str:
    """Fingerprint of everything that makes prior results reusable: config,
    seed, and the pair list.  A state file written under different flags
    (e.g. --icp) must not be silently reused.  The port's ``PladeConfig``
    has the original's repr, so the key is ``plade_tpu.cli``'s."""
    import hashlib
    blob = repr((cfg, seed, tuple(pairs))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _load_state(state_file, run_key):
    """Successfully completed pairs from a previous interrupted run:
    {(target, source): (T, ok)}.  Pairs recorded with ok=False are NOT
    treated as done — they are retried on resume.  A state file whose
    header run_key mismatches (different config/seed/pairs) is discarded.
    """
    import json
    done = {}
    if not os.path.isfile(state_file):
        return done
    with open(state_file) as f:
        lines = f.readlines()
    if not lines:
        return done
    try:
        header = json.loads(lines[0])
        if header.get("run_key") != run_key:
            print("resume state was written under a different "
                  "config/seed/pair list — starting fresh", file=sys.stderr)
            os.remove(state_file)
            return done
    except (ValueError, KeyError):
        os.remove(state_file)  # pre-header or corrupt file — start fresh
        return done
    for line in lines[1:]:
        try:
            rec = json.loads(line)
            if bool(rec["ok"]):
                done[(rec["target"], rec["source"])] = (
                    np.asarray(rec["T"], np.float64), True)
        except (ValueError, KeyError):
            continue  # torn write from a crash — redo that pair
    return done


def _write_state_header(state_file, run_key):
    import json
    if not os.path.isfile(state_file):
        with open(state_file, "w") as f:
            f.write(json.dumps({"run_key": run_key}) + "\n")
            f.flush()
            os.fsync(f.fileno())


def _append_state(state_file, target, source, T, ok):
    import json
    with open(state_file, "a") as f:
        f.write(json.dumps({"target": target, "source": source,
                            "T": np.asarray(T).tolist(), "ok": bool(ok)})
                + "\n")
        f.flush()
        os.fsync(f.fileno())


def _run_batch(pairs_file, result_file, cfg, seed, device_batch,
               resume, device) -> int:
    from ..pipeline import register_files
    try:
        pairs = _read_pairs(pairs_file)
    except OSError:
        print(f"failed opening the file containing pairs of point cloud "
              f"names: {pairs_file}", file=sys.stderr)
        return 1

    state_file = result_file + ".state.jsonl"
    run_key = _run_key(cfg, seed, pairs)
    done = _load_state(state_file, run_key) if resume else {}
    if resume:
        _write_state_header(state_file, run_key)
    if done:
        print(f"resuming: {len(done)} pairs already completed",
              file=sys.stderr)

    try:
        out = open(result_file, "w")
    except OSError:
        print(f"failed opening the result file: {result_file}",
              file=sys.stderr)
        return 1

    n_success = n_failure = 0
    with out:
        if device_batch and pairs:
            todo = [p for p in pairs if p not in done]
            results_map = dict(zip(todo, _register_batch_device(
                todo, cfg, seed, device))) if todo else {}
        else:
            results_map = None
        for target, source in pairs:
            if (target, source) in done:
                T, ok = done[(target, source)]
            elif results_map is not None:
                outcome = results_map[(target, source)]
                T, ok = outcome.transform, outcome.success
                # truncation diagnostics per pair (mirrors the info dict
                # of the single-pair path; PairOutcome carries them so
                # batch results are not silently degraded)
                if outcome.cloud_capped or outcome.match_saturated \
                        or outcome.pen_overflow or outcome.cluster_truncated:
                    print(f"pair ({target}, {source}): "
                          f"cloud_capped={outcome.cloud_capped} "
                          f"match_saturated={outcome.match_saturated} "
                          f"pen_overflow={outcome.pen_overflow} "
                          f"cluster_truncated={outcome.cluster_truncated}",
                          file=sys.stderr)
                if resume:
                    _append_state(state_file, target, source, T, ok)
            else:
                try:
                    T, info = register_files(target, source, cfg, seed,
                                             device=device)
                    ok = bool(info.get("success"))
                except (ValueError, FileNotFoundError) as e:
                    print(f"registration failed: {e}", file=sys.stderr)
                    T, ok = np.eye(4), False
                if resume:
                    _append_state(state_file, target, source, T, ok)
            _write_single(out, target, source, T, ok)
            out.write("\n")
            n_success += ok
            n_failure += not ok
    if resume and os.path.isfile(state_file) and n_failure == 0:
        os.remove(state_file)  # clean finish -> drop the checkpoint

    if n_success == 0:
        print(f"registration all failed ({n_failure} pairs)", file=sys.stderr)
        return 1
    if n_failure > 0:
        print(f"registration of {n_failure} (out of "
              f"{n_failure + n_success}) pairs failed", file=sys.stderr)
    print(f"the registration result has been written into file: {result_file}")
    return 0


def _register_batch_device(pairs, cfg, seed, device):
    """All pairs through the device step (``register_array_pairs``, its
    default ``batch_pairs`` in lockstep)."""
    from ..dist.mesh import register_array_pairs
    from ..io import native
    from ..io.ply import read_ply

    # threaded native batch load when the library builds (io/native.py
    # preloader); the reader's numpy fallback for a file it does not load
    flat_paths = [p for pair in pairs for p in pair]
    loaded = native.read_ply_batch(flat_paths) if native.available() \
        else [None] * len(flat_paths)
    clouds = []
    for i, (target, source) in enumerate(pairs):
        tgt, src = loaded[2 * i], loaded[2 * i + 1]
        tpts, tnrm = tgt if tgt else read_ply(target)
        spts, snrm = src if src else read_ply(source)
        clouds.append((tpts, tnrm, spts, snrm))
    return register_array_pairs(clouds, cfg, seed, device)


if __name__ == "__main__":
    sys.exit(main())
