"""Dry run of every (architecture x input shape x mesh) cell (port of
``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for 512 host-platform placeholder devices
and reads XLA's memory and cost analyses. Here one process per mesh joins a
``"fake"`` process group of 256 (single pod, ``(16, 16)``) or 512 ranks
(two pods, ``(2, 16, 16)``) as rank 0, builds the mesh on CPU placeholders
(``launch/mesh.py::make_mesh(..., device_type="cpu")``), places the cell's
fake arguments (``specs.build_cell``) on it with the cell's specs, and runs
the step once under ``roofline.analyze_step`` and the cell's rules: the
per-device matmul FLOPs, the collectives with their mesh dimension and
call path, and the argument, output and peak live bytes. Nothing is
allocated and no collective moves data.

The devices are CPU placeholders by design, as JAX's are host-platform
ones: the kernel routes resolve to their plain versions there, so the
serving cells count the plain routes (the plain LUT-GEMM's centroid
products, the sort-based detection), as JAX's dry run counted its jnp
routes. Nothing here is a path of the served model on the card.

One JSON per cell goes to ``results/dryrun_torch/``: JAX's fields, with
``trace_s`` for ``lower_s`` / ``compile_s``, ``fits_80GB`` for
``fits_16GB``, and ``per_device_hbm_bytes`` the peak live bytes (arguments,
temporaries and outputs as they coexist). A failing cell is recorded as
``error`` with its traceback.

Usage (from the repository root):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # both meshes, a process each, at once
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config, get_smoke_config, list_archs
from repro_torch.distributed.param_sharding import (distribute_caches, distribute_params,
                                                    parameter_specs)
from repro_torch.distributed.sharding import (distribute_replicated, placements_for,
                                              use_rules)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import HW, analyze_step, roofline_terms
from repro_torch.launch.specs import CellSetup, build_cell, skip_reason

__all__ = ["MESHES", "RESULTS_DIR", "init_fake_world", "place_args", "run_cell", "main"]

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# mesh name -> (shape, axes)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_world(world: int) -> None:
    """Join a ``"fake"`` process group of ``world`` ranks as rank 0: its
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def place_args(setup: CellSetup, mesh) -> tuple:
    """The cell's arguments as DTensors on ``mesh`` with its ``in_specs``
    (parameters and optimizer moments by ``parameter_specs``, caches by
    ``distribute_caches``, inputs sharded on the batch axes); the train
    state in place."""
    place = lambda t, spec: distribute_replicated(t, mesh, placements_for(spec, mesh))
    if setup.meta["kind"] == "train":
        (state, batch), (sspec, bspec) = setup.args, setup.in_specs
        params = state["params"]
        for key in ("m", "v"):
            specs = parameter_specs(params, sspec["opt"][key])
            state["opt"][key] = {n: place(t, specs[n]) for n, t in state["opt"][key].items()}
        distribute_params(params, sspec["params"], mesh)
        return state, {k: place(v, bspec[k]) for k, v in batch.items()}
    params, caches, *rest = setup.args
    pspec, cspec, *rest_specs = setup.in_specs
    distribute_params(params, pspec, mesh)
    caches = distribute_caches(caches, setup.cfg, cspec, mesh)
    if setup.meta["kind"] == "prefill":
        batch, bspec = rest[0], rest_specs[0]
        return params, caches, {k: place(v, bspec[k]) for k, v in batch.items()}
    (tokens, pos), (tspec, pos_spec) = rest, rest_specs
    return params, caches, place(tokens, tspec), place(pos, pos_spec)


def run_cell(arch: str, shape: str, mesh_name: str, mesh, out_dir: pathlib.Path,
             kv_quant: bool = False, overrides: dict | None = None, tag: str = "",
             save_trace: bool = False, smoke: bool = False) -> dict:
    """Set up, place and analyse one cell on ``mesh``; write and return its
    record."""
    name = f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{name}.json"
    reason = skip_reason((get_smoke_config if smoke else get_config)(arch), SHAPES[shape])
    if reason:
        rec = {"cell": name, "status": "skipped", "reason": reason}
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    t0 = time.time()
    try:
        setup = build_cell(arch, shape, mesh_name == "multi", kv_quant=kv_quant,
                           overrides=overrides, smoke=smoke)
        args = place_args(setup, mesh)
        with use_rules(setup.rules, mesh):
            analysis = analyze_step(setup.step_fn, *args, mesh=mesh)
        trace_s = time.time() - t0
        rr = roofline_terms(analysis)
        hbm_used = analysis["peak_bytes"]
        rec = {
            "cell": name,
            "status": "ok",
            "arch": arch,
            "shape": shape,
            "mesh": list(MESHES[mesh_name][0]),
            "kind": setup.meta["kind"],
            "meta": setup.meta,
            "trace_s": round(trace_s, 1),
            "memory_analysis": {
                "argument_bytes": analysis["argument_bytes"],
                "output_bytes": analysis["output_bytes"],
                "temp_bytes": analysis["temp_bytes"],
                "per_device_hbm_bytes": hbm_used,
                "fits_80GB": bool(hbm_used < HW().hbm_bytes),
            },
            "step_analysis": {k: analysis[k] for k in (
                "matmul_flops", "flops_by_op", "collective_bytes", "collective_breakdown",
                "collective_bytes_by_dim", "n_ops")},
            "roofline": rr.as_dict(),
        }
        if save_trace:
            (out_dir / f"{name}.collectives.json").write_text(json.dumps(
                {"cell": name, "mesh": analysis["mesh"], "collectives": analysis["collectives"],
                 "flops_by_source": analysis["flops_by_source"]}, indent=1))
        print(f"[dryrun] {name}: OK trace={trace_s:.0f}s hbm/dev={hbm_used / 1e9:.2f}GB "
              f"fits={rec['memory_analysis']['fits_80GB']} bottleneck={rr.bottleneck} "
              f"(c={rr.compute_s * 1e3:.2f}ms m={rr.memory_s * 1e3:.2f}ms "
              f"x={rr.collective_s * 1e3:.2f}ms)", flush=True)
    except Exception as e:  # noqa: BLE001 -- a failing cell is a result to record
        rec = {"cell": name, "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {name}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs(), action="append")
    ap.add_argument("--shape", choices=list(SHAPES), action="append")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true", help="all assigned (arch x shape) cells")
    ap.add_argument("--kv-quant", action="store_true", help="int4 K-Means KV cache variant")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-trace", action="store_true",
                    help="also write each cell's collectives (profile_comms reads them)")
    ap.add_argument("--skip-done", action="store_true", help="skip cells with existing OK results")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configurations (tag 'smoke' unless --tag), for quick checks")
    args = ap.parse_args(argv)
    if args.smoke and not args.tag:
        args.tag = "smoke"
    archs = args.arch or (list_archs(assigned_only=True) if args.all else [])
    if not archs:
        ap.error("pass --arch or --all")
    if args.mesh == "both":  # one process per mesh: each joins its own fake world
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--mesh") if "--mesh" in argv else None
        if i is not None:
            del argv[i : i + 2]
        procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                                   "--mesh", m]) for m in ("single", "multi")]
        return max(p.wait() for p in procs)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    shape_mesh, axes = MESHES[args.mesh]
    torch.set_num_threads(1)
    init_fake_world(int(torch.tensor(shape_mesh).prod()))
    mesh = make_mesh(shape_mesh, axes, device_type="cpu")
    shapes = args.shape or list(SHAPES)
    counts = {"ok": 0, "error": 0, "skipped": 0}
    try:
        for arch in archs:
            for shape in shapes:
                name = f"{arch}__{shape}__{args.mesh}" + (f"__{args.tag}" if args.tag else "")
                f = out_dir / f"{name}.json"
                if args.skip_done and f.exists():
                    if json.loads(f.read_text()).get("status") in ("ok", "skipped"):
                        continue
                rec = run_cell(arch, shape, args.mesh, mesh, out_dir, kv_quant=args.kv_quant,
                               tag=args.tag, save_trace=args.save_trace, smoke=args.smoke)
                counts[rec["status"]] += 1
    finally:
        dist.destroy_process_group()
    print(f"[dryrun] done: {counts['ok']} ok, {counts['error']} failed, "
          f"{counts['skipped']} skipped (documented)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
