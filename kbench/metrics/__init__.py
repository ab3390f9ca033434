"""Metric readers, one module each, found by the metric's name.

``metrics/<base>.py`` reads the metric ``<base>`` or ``<base>.<suffix>``
(the suffix names the end-to-end metric it moves: ``.serve`` for the
online cell, ``.batch`` for the offline ones) and defines ``read(run)``:
the value from a ``harness.Run``, or None when the run holds nothing to
read (the harness then leaves the metric out of the line).
"""

from __future__ import annotations

import importlib

__all__ = ["read"]


def read(name: str, run):
    return importlib.import_module(f"kbench.metrics.{name.split('.')[0]}").read(run)
