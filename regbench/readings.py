"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 -m regbench.readings --workload NAME --seeds 1,2,... --seconds S

In one process (set-up is paid once), for each seed: one run of the cell
of ``S`` seconds, and every compared number as the program gives it and
as the control gives it: the reference in TF32 put in the program's place
(the spacing, K1 and K2 answers of the same run).  One JSON line a run;
the benchmark's own runs never do this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402


def _numbers(lines) -> dict:
    return {name: value for name, value, _, _ in lines}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m regbench.readings")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--seconds", type=float, default=6.0)
    args = parser.parse_args(argv)
    import torch

    from regbench import check
    from regbench.harness import load_spec, run_cell
    spec = load_spec(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("the readings need a CUDA card")

    def both(*a, **kw):
        both.control = check.check(*a, control=True, **kw)
        return check.check(*a, **kw)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        result, lines, run = run_cell(spec, seed, args.seconds, False,
                                      time.perf_counter(), check_fn=both)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "pairs": run.pairs,
            "attempted": result["attempted"], "failed": result["failed"],
            "numbers": _numbers(lines), "correct": result["correct"],
            "control": _numbers(both.control),
            "control_correct": all(ok for *_, ok in both.control)}),
            flush=True)
    print(f"readings done in {time.perf_counter() - T_START:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
