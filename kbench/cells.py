"""Finds a cell, its configuration and its traffic mix by name."""

from __future__ import annotations

import json
import pathlib

from kbench import traffic

__all__ = ["HERE", "load"]

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str, overrides: dict | None = None) -> tuple[dict, dict, dict]:
    """(cell, config, mix) of the cell ``name`` (``cells/<name>.json``),
    its configuration (``configs/<config>.json``) and its mix
    (``traffic/<traffic>.json``). ``overrides`` replaces entries of the
    three (keys ``cell``, ``config``, ``traffic``): the CPU tests run a
    cell at a tiny size so."""
    cell = json.loads((HERE / "cells" / f"{name}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    mix = traffic.load(cell["traffic"])
    for key, d in (("cell", cell), ("config", cfg), ("traffic", mix)):
        d.update((overrides or {}).get(key, {}))
    return cell, cfg, mix
