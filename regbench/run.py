"""The benchmark of ``plade_tpu_torch`` on NVIDIA cards: one run of one
cell.

    python3 -m regbench.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout; the cell ``NAME`` is an entry of
``BENCHMARK.json``'s ``workloads``.  The run makes its pairs and their
truth from the cell's configuration, registers them in the cell's traffic
mix for ``S`` seconds after a warm-up, checks the answers against the
plain reference, and prints one JSON line: the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics (from a profiler stretch of a
few calls inside the window) with ``--trace 1``.  Every number compared
is printed with its limit as the last lines of standard error.

Exit codes: 0 with a result (``correct`` may be false); 2 without the
cards the cell asks for or for an unknown cell; 3 when the program
(``plade_tpu_torch``) cannot be imported; 4 when the run holds ``jax`` or
the JAX package once its window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_line() -> str:
    """The cards' names and power limits as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m regbench.run",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must not be negative")
    from regbench.harness import Refused, load_spec, run_cell
    try:
        spec = load_spec(args.workload)
        import torch
        chips = spec.cell["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Refused(2, f"the cell needs {chips} CUDA card(s); "
                             f"torch sees {torch.cuda.device_count()}")
        try:
            import plade_tpu_torch  # noqa: F401
        except ImportError as e:
            raise Refused(3, f"the program cannot be imported: {e}")
        print(f"[regbench] {args.workload} seed {args.seed}: "
              f"{card_line()}; torch {torch.__version__}",
              file=sys.stderr, flush=True)
        result, lines, _ = run_cell(spec, args.seed, args.seconds,
                                    bool(args.trace), T_START)
    except Refused as e:
        print(f"regbench: {e}", file=sys.stderr)
        return e.code
    for name, value, limit, ok in lines:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
