"""Runs one cell as the check does: one process per run, and reports each
metric's spread.

    python3 kbench/sets.py --workload danube-chat --seconds 40 --seeds 1 2 3 4 5 6 --sets 2

Each run is ``kbench/run.py`` in a fresh process (``--trace`` as given);
with ``--sets 2`` the seeds run twice, set after set. Every result line is
appended to ``--out`` with its stderr tail; the summary gives per metric
the values, the median and the spread of each set (quartile distance over
the median, ``statistics.quantiles(n=4)``), leaving out each set's first
run for ``setup_s`` (it may build the kernels).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if pathlib.Path(p or ".").resolve() != ROOT / "kbench"]

from kbench.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sets = []
    for s in range(args.sets):
        rows = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "kbench/run.py", "--workload", args.workload,
                                "--seed", str(seed), "--seconds", str(args.seconds),
                                "--trace", str(args.trace)], cwd=ROOT, capture_output=True,
                               text=True)
            wall = time.perf_counter() - t0
            last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
            try:
                res = json.loads(last)
            except json.JSONDecodeError:
                res = None
            rec = {"workload": args.workload, "set": s, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "card": smi, "result": res,
                   "stderr_tail": p.stderr[-3000:]}
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            brief = {k: round(v["value"], 4) for k, v in (res or {}).get("metrics", {}).items()}
            print(f"set {s} seed {seed} rc {p.returncode} wall {wall:.1f} "
                  f"correct {res and res['correct']} {brief} "
                  f"checks {res and {k: round(c['value'], 5) for k, c in res['checks'].items() if c['value'] is not None}}",
                  flush=True)
            if res is None:
                print(p.stderr[-4000:], flush=True)
            rows.append(res)
        sets.append(rows)
    names = sorted({k for rows in sets for r in rows if r for k in r["metrics"]})
    for n in names:
        line = []
        for rows in sets:
            v = [r["metrics"][n]["value"] for r in rows if r and n in r["metrics"]]
            if n == "setup_s":
                v = v[1:]
            if len(v) >= 2:
                line.append(f"median {statistics.median(v):.5g} spread {spread(v):.4f} "
                            f"values {[round(x, 4) for x in v]}")
        print(n, " | ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
