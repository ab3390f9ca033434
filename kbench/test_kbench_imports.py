"""What a run loads: no JAX and no JAX package; the reference and the
yardstick load nothing of the program either."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
YARDSTICK = ["kbench.reference", "kbench.judge", "kbench.counts", "kbench.traffic",
             "kbench.stats", "kbench.weights", "kbench.tracing", "kbench.cells"]
PROGRAM = ["repro_torch.models.model", "repro_torch.serving.engine",
           "repro_torch.serving.telemetry", "repro_torch.core.qlinear",
           "repro_torch.core.quantspec", "repro_torch.configs.base"]


def _loaded(modules: list[str]) -> list[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}"),
                         timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _every_kbench_module() -> list[str]:
    mods = []
    for p in sorted((ROOT / "kbench").rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if not p.name.startswith("test_") and p.name != "conftest.py":
            mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = _every_kbench_module()
    assert "kbench.run" in mods and "kbench.metrics.step_mfu" in mods
    tops = {m.split(".")[0] for m in _loaded(mods + PROGRAM)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops  # compared whole: the port's name begins with "repro"


def test_the_reference_and_the_yardstick_load_nothing_of_the_program():
    laws = ("kbench.metrics", "kbench.arrivals", "kbench.lengths", "kbench.prompts")
    readers = [m for m in _every_kbench_module() if m.startswith(laws)]
    assert any(m.startswith("kbench.arrivals.") for m in readers)
    tops = {m.split(".")[0] for m in _loaded(YARDSTICK + readers)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
