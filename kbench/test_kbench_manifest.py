"""BENCHMARK.json against the benchmark's contract: names, units and
characters, and every name found by the harness."""

import importlib
import json
import pathlib
import re

import pytest

from kbench import cells, traffic

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads", "layer", "moves"}


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kbench"]
    assert all(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) for p in BENCH["paths"])
    assert BENCH["command"][1] == "kbench/run.py" and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for p in pathlib.Path(ROOT / "kbench").rglob("*"):
        if "__pycache__" not in p.parts and p.is_file():
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", str(p.relative_to(ROOT))), p


def test_names_units_and_lines_use_allowed_characters():
    names = [m["name"] for m in metrics()] + [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names + [w["config"] for w in BENCH["workloads"]] + [
            w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in metrics():
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert LINE.fullmatch(text), text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        reported = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells_of = lambda m: m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in cells_of(m):
            assert cell in cells_of(e2e[m["moves"]]), (m["name"], cell)
        # a reader of its own, found by the name
        importlib.import_module(f"kbench.metrics.{m['name'].split('.')[0]}").read
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert any(w["name"] in cells_of(m) for m in BENCH["per_layer"])


def test_configs_cells_and_mixes_are_found_by_name():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == [] and len(c["reduced"]) <= 16
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        cell, cfg, mix = cells.load(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cfg["name"] == w["config"]
        assert traffic.plan(mix, 1, cfg["vocab_size"], cell.get("rate_per_s")).open == (
            "rate_per_s" in cell)
        assert set(cell["limits"]) <= {"served_gap_max", "served_gap_mean", "step_err_max",
                                       "step_err2_mean"}


@pytest.mark.parametrize("name", ["danube-chat", "granite-batch"])
def test_cells_fit_their_cache_and_drop_no_expert_assignment(name):
    from kbench import reference

    cell, cfg, mix = cells.load(name)
    p = traffic.plan(mix, 1, cfg["vocab_size"], cell.get("rate_per_s"))
    longest = max(a + b for a, b in zip(p.prompt_lens, p.output_lens))
    assert longest <= cell["cache_len"]
    budget = cell["slots"] + cell["prefill_chunk"]
    if cfg.get("num_local_experts"):
        assert reference.moe_drops_nothing(budget, cfg)
