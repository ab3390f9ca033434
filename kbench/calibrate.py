"""Readings for the limits: the program's numbers and the control's on
several seeds of one cell, in one process (the kernels are built once).

    python3 kbench/calibrate.py --workload danube-chat --seconds 40 --seeds 11 12 13
    python3 kbench/calibrate.py --workload danube-chat --seconds 20 --seeds 5 --no-check \
        --rates 1.6 2.0 2.4

Each seed is a whole run (set-up, ramp, window) whose check also computes
the control: the reference in float8 at the same positions, judged by the
cell's own limits (``judge.verdict``), which it has to fail. One JSON line
per seed goes to standard output and to ``--out``; the exit code is 1 when
a control came out correct or a run did not. ``--no-check`` (the knee
sweep) compares nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rates", type=float, nargs="*", default=[None],
                    help="run at each of these rates in place of the cell's (the knee sweep)")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "kbench"]
    import torch

    torch.set_num_threads(4)
    from kbench import harness, judge, metrics

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"]
             if args.workload in m.get("workloads", [args.workload])]
    bad = 0
    for rate, seed in [(r, s) for r in args.rates for s in args.seeds]:
        over = {"cell": {"rate_per_s": rate}} if rate else None
        out = harness.run(args.workload, seed, args.seconds, False, overrides=over,
                          control=not (args.no_control or args.no_check),
                          check=not args.no_check)
        run = out["run"]
        control_correct = (judge.verdict(out["control"], run.cell["limits"])[0]
                           if "control" in out else None)
        bad += out["correct"] is False or control_correct is True
        line = {"workload": args.workload, "seed": seed, "rate": rate,
                "numbers": out["numbers"], "control": out.get("control"),
                "control_correct": control_correct, "limits": run.cell["limits"],
                "compared": out["compared"], "correct": out["correct"],
                "metrics": {n: metrics.read(n, run) for n in names},
                "attempted": run.attempted, "queue": run.queue,
                "finished_in_window": sum(1 for t in run.token_times.values()
                                          if t and run.t0 <= t[-1] <= run.t1),
                "steps": len(run.steps), "step_walls": harness.step_walls(run),
                "memory_peak_bytes": out["memory_peak_bytes"],
                "setup_parts": run.setup_parts}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out, run
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
