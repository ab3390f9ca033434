"""The readers of the program's region marks and host phases, on hand-made
run records: the shares and the Orizuru roofline from replays split at the
marker kernels of a given ``region_marks`` (a replay missing a marker is
refused), also where the device timestamps stray from the host's, the host
idle by phase, and None on steps that carry neither field (as the parent
program's do)."""

import pytest

from kbench import counts, metrics, tracing
from kbench.harness import Run
from kbench.metrics import orizuru_roofline
from kbench.metrics.host_idle_ms_per_step import idle_spans, overlap_ns
from kbench.metrics.replays import step_regions, stray_ns

CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
       "intermediate_size": 128, "num_hidden_layers": 2, "vocab_size": 256,
       "torch_dtype": "bfloat16"}
CELL = {"quant": {"w_bits": 4, "a_bits": 4, "detection": "dynamic", "outlier_frac": 0.05,
                  "rules": [["mlp/wd", {"w_bits": 8}]]}}
NEW = ["comp_share.serve", "comp_share.batch", "dispatch_share.batch", "orizuru_roofline.serve",
       "host_idle_ms_per_step.serve", "host_idle_ms_per_step.batch"]
# one replay: a marker 3 us after each region's offset below, the region's
# one op 5 us after it, each 1 us long, and the closing marker at 158 us;
# an op counts up to the next marker's start, so the regions take ``WANT``
MARKS = ("other", "qlinear.main", "qlinear.detect", "qlinear.residual",
         "qlinear.comp_dequant", "qlinear.comp_matmul", "moe.route", "moe.dispatch",
         "moe.experts", "moe.combine", "head", "other")
STARTS = (0, 10, 40, 50, 60, 100, 110, 120, 130, 140, 150)
WANT = {"other": 8, "qlinear.main": 28, "qlinear.detect": 8, "qlinear.residual": 8,
        "qlinear.comp_dequant": 38, "qlinear.comp_matmul": 8, "moe.route": 8,
        "moe.dispatch": 8, "moe.experts": 8, "moe.combine": 8, "head": 3}  # 133 us
MARKER = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
US = 1000


def record(steps, trace=None) -> Run:
    return Run(cfg=CFG, cell=CELL, mix={}, t0=0.0, t1=1.0, steps=steps, trace=trace)


def step(**kw) -> dict:
    return {"budget": 8, "cells": 8, "host_s": 0.001, "device_s": 0.1, "sampled": 1} | kw


def _replays(bases, drop=None, stray=0):
    """Device events of replays starting at ``bases`` (us), each after its
    upload, and the steps whose replay phases hold them; replay ``drop``
    lacks its third marker; the device timestamps lie ``stray`` ns after
    the host's."""
    dev, steps = [], []
    for i, base in enumerate(bases):
        b = base * US + stray
        dev.append(("Memcpy HtoD (Pinned -> Device)", b, b + 2 * US))
        for k, at in enumerate(STARTS):
            if not (i == drop and k == 2):
                dev.append((MARKER, b + (at + 3) * US, b + (at + 4) * US))
            dev.append((f"op{k}", b + (at + 5) * US, b + (at + 6) * US))
        dev.append((MARKER, b + 158 * US, b + 159 * US))
        a = base * US
        phases = [("pack", a - US, a), ("replay", a, a + 170 * US),
                  ("sample", a + 170 * US, a + 180 * US)]
        steps.append(step(region_marks=MARKS, phases=phases, traced=True, budget=8 * (i + 1)))
    window = (0, (bases[-1] + 400) * US + stray)
    return tracing.Trace(dev, window, {"kbench.window": [window]}), steps


def test_replays_split_at_their_markers_give_the_region_shares():
    tr, steps = _replays([1000, 2000, 3000], drop=1)
    run = record(steps + [step(region_marks=MARKS, phases=steps[0]["phases"])], trace=tr)
    got = step_regions(run)
    assert [s["budget"] for s, _ in got] == [8, 24]  # the replay missing a marker is refused
    assert got[0][1] == {k: v * US for k, v in WANT.items()}
    assert metrics.read("comp_share.serve", run) == pytest.approx(100.0 * 54 / 133)
    assert metrics.read("comp_share.batch", run) == pytest.approx(100.0 * 54 / 133)
    assert metrics.read("dispatch_share.batch", run) == pytest.approx(100.0 * 24 / 133)
    # marks longer than any replay the trace holds: nothing is split
    longer = [dict(s, region_marks=MARKS + ("other",)) for s in steps]
    assert metrics.read("comp_share.serve", record(longer, trace=tr)) is None


def test_replays_are_found_where_the_device_timestamps_stray():
    # 3 ms late: past the replay phases' close (170 us), within the search
    tr, steps = _replays([10_000, 20_000], stray=3_000 * US)
    run = record(steps, trace=tr)
    assert stray_ns(run) == 3_000 * US
    assert len(step_regions(run)) == 2
    assert metrics.read("comp_share.serve", run) == pytest.approx(100.0 * 54 / 133)


def test_orizuru_roofline_comes_from_the_detect_time():
    tr, steps = _replays([1000, 2000])
    run = record(steps, trace=tr)
    # every projection's K: wq wk wv 64, wo 4 x 16, wi 64, wd 128
    ks = [64, 64, 64, 64, 64, 128]
    least = 0.0
    for m in (8, 16):
        for k in ks:
            per_side = round(k * 0.05)
            least += (m * k * 2 + m * 2 * per_side * 8) / counts.H100["hbm_bytes_per_s"]
    assert orizuru_roofline.detect_least_s(8, 128, 0.05, 2) == pytest.approx(
        (8 * 128 * 2 + 8 * 2 * 6 * 8) / 3.35e12)
    assert metrics.read("orizuru_roofline.serve", run) == pytest.approx(
        100.0 * 2 * least / 16e-6)  # two layers, 2 x 8 us of detection


def _trace():
    # device busy 0..100, 150..200, 300..420 ns of a 0..500 ns slice
    dev = [("k", 0, 60), ("k", 40, 100), ("k", 150, 200), ("k", 300, 420)]
    return tracing.Trace(dev, (0, 500), {"kbench.window": [(0, 500)]})


def test_idle_in_host_phases_counts_and_idle_in_replay_does_not():
    tr = _trace()
    assert idle_spans(tr) == [(100, 150), (200, 300), (420, 500)]
    assert overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    # idle 100..150 falls in sample, 200..300 in replay, 420..500 in commit
    # and in no phase (480..500)
    phases = [("admit", 0, 20), ("plan", 20, 30), ("pack", 30, 40), ("replay", 40, 120),
              ("sample", 120, 160), ("commit", 160, 170)]
    later = [("admit", 170, 180), ("plan", 180, 190), ("pack", 190, 200),
             ("replay", 200, 430), ("sample", 430, 440), ("commit", 440, 480)]
    run = record([step(phases=phases, traced=True), step(phases=later, traced=True),
                  step(phases=phases, traced=False)], trace=tr)
    # sample 120..150 (30 ns), replay idle not counted, 430..480 (50 ns)
    want = (30 + 50) / 2 / 1e6
    assert metrics.read("host_idle_ms_per_step.serve", run) == pytest.approx(want)
    assert metrics.read("host_idle_ms_per_step.batch", run) == pytest.approx(want)
    # the same idle moved inside a replay phase counts nothing
    inside = [("replay", 0, 500)]
    assert metrics.read("host_idle_ms_per_step.serve",
                        record([step(phases=inside, traced=True)], trace=tr)) == 0.0


def test_host_idle_follows_the_device_timestamps_where_they_stray():
    """Each replay's upload opens its phase: device timestamps 2 ms late
    move the phases with them, and the idle per phase stays."""
    def idle(stray):
        tr, steps = _replays([10_000, 20_000], stray=stray)
        for s in steps:  # the sample phase holds 10 us of idle after the graph
            a, b = next((a, b) for n, a, b in s["phases"] if n == "replay")
            s["phases"] = [("pack", a - US, a), ("replay", a, a + 159 * US),
                           ("sample", a + 159 * US, a + 169 * US)]
        return metrics.read("host_idle_ms_per_step.serve", record(steps, trace=tr))

    assert idle(0) == pytest.approx(idle(2_000 * US)) == pytest.approx(11e-3)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_on_steps_without_the_new_fields(name):
    # the parent program's records: no marks, no phases
    tr, steps = _replays([1000, 2000])
    bare = [{k: v for k, v in s.items() if k not in ("region_marks", "phases")} for s in steps]
    assert metrics.read(name, record(bare, trace=tr)) is None
    assert metrics.read(name, record([])) is None
