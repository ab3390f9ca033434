"""Runs one cell of the benchmark once and prints its result line.

    python3 kbench/run.py --workload danube-chat --seed 7 --seconds 40 --trace 0

from the root of a checkout. The cell is ``BENCHMARK.json``'s workload of
that name (``kbench/cells/<name>.json``); ``--trace 0`` reports its
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced run
(``torch.profiler`` over the window). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), and last ``checks``: each
number compared against the reference beside its limit, which also close
standard error. Without as many CUDA cards as the cell asks for, or with
JAX or the JAX package loaded after the window, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def _workload(name: str) -> tuple[dict, list, list]:
    """The workload's entry and the end-to-end and per-layer metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return wl, mine(bench["end_to_end"]), mine(bench["per_layer"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    wl, e2e, per_layer = _workload(args.workload)
    _caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"kbench: the cell needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the package and the program by their own names, not kbench/'s files
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "kbench"]
    torch.set_num_threads(4)
    from kbench import harness, metrics

    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_process=T_PROCESS)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"kbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    run = out["run"]
    wanted = per_layer if args.trace else e2e
    values = {m["name"]: metrics.read(m["name"], run) for m in wanted}
    result = {
        "correct": out["correct"],
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in wanted if values[m["name"]] is not None},
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": wl["chips"], "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if args.trace and run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.top_gaps()}
    result["checks"] = out["checks"]
    info = {"compared": out["compared"], "numbers": out["numbers"],
            "setup_parts": run.setup_parts, "steps": len(run.steps), "queue": run.queue,
            "step_walls": harness.step_walls(run)}
    if run.trace is not None:
        info["trace"] = {"steps": sum(1 for s in run.steps if s.get("traced")),
                         "device_events": len(run.trace.device),
                         "lut_gemm_launches": run.trace.kernel_ns("fused_lut_gemm_kernel")[1],
                         "attention_launches": run.trace.kernel_ns("paged_attn::kernel")[1]}
    print(json.dumps(info), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
