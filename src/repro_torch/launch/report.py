"""Render the dry-run matrix and the roofline table from
``results/dryrun_torch/*.json`` (port of ``repro/launch/report.py``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]
Prints markdown. Every time in it is a bound from the H100's published peaks
(``roofline.HW``) and the dry run's counts, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.launch.dryrun import MESHES, RESULTS_DIR

__all__ = ["model_flops", "load", "render", "main"]

_NOTES = {
    "compute": "tensor-core bound: raise arithmetic efficiency (larger tiles, fusion)",
    "memory": "HBM bound: shrink resident and streamed bytes (quantize more, shard wider)",
    "collective": "NVLink / inter-host bound: cut communication (SP/FSDP schedule, "
                  "fewer regathers, overlap)",
}


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def model_flops(arch: str, shape_name: str) -> float:
    """6 N D (train; MoE: active N), 2 N tokens (prefill), 2 N per sequence
    (decode: one token each)."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    n = cfg.n_active_params
    if sh.kind == "train":
        return 6.0 * n * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n * sh.global_batch * sh.seq_len
    return 2.0 * n * sh.global_batch


def load(dir_: pathlib.Path, mesh: str) -> dict:
    out = {}
    for f in sorted(dir_.glob(f"*__{mesh}.json")):
        d = json.loads(f.read_text())
        arch, shape = f.stem.split("__")[:2]
        out[(d.get("arch", arch), d.get("shape", shape))] = d
    return out


def render(dir_: pathlib.Path) -> str:
    chips = math.prod(MESHES["single"][0])
    single, multi = load(dir_, "single"), load(dir_, "multi")
    shapes = list(SHAPES)
    lines = ["### Dry-run matrix (status 16x16 / 2x16x16; single mesh: HBM a device, "
             "fits 80 GB, trace s)\n",
             "| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for arch in list_archs(assigned_only=True):
        row = []
        for shape in shapes:
            s, m = single.get((arch, shape)), multi.get((arch, shape))
            if s is None:
                row.append("-")
            elif s["status"] == "skipped":
                row.append("skip")
            elif s["status"] != "ok":
                row.append(f"{s['status']} / {m['status'] if m else '?'}")
            else:
                mem = s["memory_analysis"]
                fits = "" if mem["fits_80GB"] else " **no**"
                row.append(f"ok / {m['status'] if m else '?'}: "
                           f"{mem['per_device_hbm_bytes'] / 1e9:.2f} GB{fits}, {s['trace_s']} s")
        if any(r != "-" for r in row):
            lines.append(f"| {arch} | " + " | ".join(row) + " |")
    lines += ["\n### Roofline (single-pod 16x16, per H100; bounds, not measurements)\n",
              "| arch | shape | compute | memory | collective | bottleneck | "
              "model FLOPs / counted FLOPs | note |",
              "|---|---|---|---|---|---|---|---|"]
    for arch in list_archs(assigned_only=True):
        for shape in SHAPES:
            s = single.get((arch, shape))
            if not s or s["status"] != "ok":
                continue
            rr = s["roofline"]
            ratio = model_flops(arch, shape) / chips / max(rr["flops"], 1.0)
            dom = rr["bottleneck"]
            lines.append(f"| {arch} | {shape} | {_fmt_s(rr['compute_s'])} | "
                         f"{_fmt_s(rr['memory_s'])} | {_fmt_s(rr['collective_s'])} | {dom} | "
                         f"{ratio:.2f} | {_NOTES[dom]} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    print(render(pathlib.Path(args.dir)))


if __name__ == "__main__":
    main()
