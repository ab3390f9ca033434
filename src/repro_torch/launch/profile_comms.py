"""Collective profile of one dry-run cell (the counterpart of
``repro/launch/profile_hlo.py``, which reads a compiled HLO dump; eager
PyTorch has no HLO, so this reads the collectives the dry run recorded).

``dryrun --save-trace`` writes ``<cell>.collectives.json``: one row per
collective op, mesh dimension, issuing call path and size, with its count
in the step. This prints the top rows by bytes x count, each with the call
path that issued it -- the dry run's counterpart of reading a profiler's
communication lanes -- and the seconds each takes at its dimension's link
rate (``roofline.link_bandwidth``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile_comms results/dryrun_torch/<cell>.collectives.json [top_n]
"""

from __future__ import annotations

import json
import pathlib
import sys

from repro_torch.launch.roofline import link_bandwidth

__all__ = ["collect", "render", "main"]


def collect(trace: dict, top_n: int = 15) -> list[dict]:
    """The ``top_n`` collectives of a saved trace by bytes x count, each with
    ``total_bytes`` and ``seconds`` at its mesh dimension's link rate."""
    rows = [{**c, "total_bytes": c["bytes"] * c["count"],
             "seconds": c["bytes"] * c["count"] / link_bandwidth(trace["mesh"], c["dim"])}
            for c in trace["collectives"]]
    return sorted(rows, key=lambda r: -r["total_bytes"])[:top_n]


def render(trace: dict, top_n: int = 15) -> str:
    rows = collect(trace, top_n)
    lines = [f"{trace['cell']}: {len(trace['collectives'])} collective kinds",
             f"{'total_GB':>9} {'per_op_MB':>10} {'count':>6} {'ms':>9}  {'op':<14} {'dim':<6} source"]
    for r in rows:
        lines.append(f"{r['total_bytes'] / 1e9:>9.3f} {r['bytes'] / 1e6:>10.2f} {r['count']:>6} "
                     f"{r['seconds'] * 1e3:>9.2f}  {r['op']:<14} {r['dim']:<6} {r['source']}")
    total = sum(r["total_bytes"] for r in rows)
    lines.append(f"top-{len(rows)} total: {total / 1e9:.2f} GB, "
                 f"{sum(r['seconds'] for r in rows) * 1e3:.2f} ms at the links' rates")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    trace = json.loads(pathlib.Path(argv[0]).read_text())
    print(render(trace, int(argv[1]) if len(argv) > 1 else 15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
