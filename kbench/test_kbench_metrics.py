"""The metric arithmetic on hand-made run records."""

from collections import defaultdict

import numpy as np
import pytest

from kbench import counts, metrics, stats, tracing
from kbench.metrics import attn_roofline, lut_gemm_roofline
from kbench.harness import Run

CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
       "intermediate_size": 128, "num_hidden_layers": 2, "vocab_size": 256, "sliding_window": 8}
CELL = {"quant": {"w_bits": 4, "a_bits": 4, "rules": [["mlp/wd", {"w_bits": 8}]]}}


def record(**kw) -> Run:
    run = Run(cfg=CFG, cell=CELL, mix={}, t0=100.0, t1=110.0)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_percentile_is_linear_between_ranks():
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_ttft_tail_counts_every_request_due_in_the_window_and_the_censored():
    due = {i: 100.0 + i for i in range(10)}
    due[99] = 95.0  # due before the window: not counted
    first = {i: 100.0 + i + 0.1 * (i + 1) for i in range(9)}  # 0.1 .. 0.9 s
    first[99] = 95.5
    # request 9 (due at 109) has no token at the close (110): it waited 1 s
    run = record(due=due, first=first)
    vals = sorted(stats.ttft_values(due, first, 100.0, 110.0))
    assert vals == pytest.approx([0.1 * k for k in range(1, 10)] + [1.0])
    assert metrics.read("ttft_p90_ms", run) == pytest.approx(
        1e3 * (0.9 + 0.1 * 0.1))


def test_itl_takes_every_gap_that_ends_in_the_window():
    times = defaultdict(list, {1: [99.0, 100.5, 101.0, 111.0], 2: [105.0, 105.2]})
    run = record(token_times=times)
    assert sorted(stats.itl_values(times, 100.0, 110.0)) == pytest.approx([0.2, 0.5, 1.5])
    assert metrics.read("itl_p95_ms", run) == pytest.approx(
        1e3 * stats.percentile([0.2, 0.5, 1.5], 95))


def test_rates_and_step_ring_metrics_take_the_whole_window():
    steps = [{"budget": 10, "cells": 10, "host_s": 0.002, "sampled": 3},
             {"budget": 10, "cells": 4, "host_s": 0.004, "sampled": 1}]
    run = record(prefilled=1500, generated=500, steps=steps, lags=[0.001 * i for i in range(21)])
    assert metrics.read("tokens_per_s", run) == pytest.approx(200.0)
    assert metrics.read("budget_util.batch", run) == pytest.approx(70.0)
    assert metrics.read("host_ms_per_step.serve", run) == pytest.approx(3.0)
    assert metrics.read("arrival_lag_p95_ms.serve", run) == pytest.approx(19.0)
    assert metrics.read("step_mfu.serve", run) is None  # no positions recorded


def test_step_mfu_counts_valid_tokens_the_window_and_the_head():
    pos = np.array([[0], [1], [20], [-1]])
    run = record(steps=[{"budget": 4, "cells": 3, "host_s": 0.0, "sampled": 2,
                         "pos": pos, "slots": np.array([0, 0, 1, 0])}])
    flops = (counts.token_flops(CFG, 1) + counts.token_flops(CFG, 2)
             + counts.token_flops(CFG, 8) + 2 * counts.head_flops(CFG))
    assert metrics.read("step_mfu.batch", run) == pytest.approx(
        100.0 * flops / (10.0 * counts.H100["bf16_flops"]))


def _trace():
    # window 0..1000 ns; two steps, each one LUT-GEMM launch per projection
    # of both layers and one attention launch per layer
    per_step = len(lut_gemm_roofline.projections(CFG, CELL["quant"])) * 2
    dev, t = [], 100
    for _ in range(2):
        for _ in range(per_step):
            dev.append(("void fused_lut_gemm_kernel<8>(...)", t, t + 10))
            t += 10
        for _ in range(2):
            dev.append(("void paged_attn::kernel<3>(...)", t, t + 5))
            t += 5
        dev.append(("aten::copy_", t, t + 30))
        t += 130
    host = {"kbench.window": [(0, 1000)], "kbench.step": [(50, 500), (500, 990)],
            "packed_step": [(90, 400), (590, 900)]}
    return tracing.Trace(dev, (0, 1000), host), per_step


def test_trace_shares_and_rooflines():
    tr, per_step = _trace()
    busy = 2 * (per_step * 10 + 2 * 5 + 30)
    assert tr.busy_ns == busy
    steps = [{"budget": 4, "cells": 4, "host_s": 0.0, "sampled": 1,
              "pos": np.array([[0], [1], [2], [3]]), "slots": np.array([0, 0, 0, 0]),
              "traced": True}] * 2
    run = record(trace=tr, steps=steps)
    assert metrics.read("device_idle.serve", run) == pytest.approx(100.0 * (1 - busy / 1000))
    hand = 2 * (per_step * 10 + 2 * 5)
    assert metrics.read("plain_share.serve", run) == pytest.approx(100.0 * (1 - hand / busy))
    least = sum(counts.lut_gemm_least_s(4, k, n, b) for k, n, b in
                lut_gemm_roofline.projections(CFG, CELL["quant"]))
    assert metrics.read("lut_gemm_roofline.serve", run) == pytest.approx(
        100.0 * 2 * 2 * least / (2 * per_step * 10e-9))
    att = attn_roofline.step_least_s(CFG, steps[0]["slots"], steps[0]["pos"])
    assert metrics.read("attn_roofline.serve", run) == pytest.approx(
        100.0 * 2 * 2 * att / (2 * 2 * 5e-9))
    # a trace that is not made of whole steps gives no roofline; steps
    # before the traced slice do not count
    assert metrics.read("lut_gemm_roofline.serve", record(trace=tr, steps=steps[:1])) is None
    early = [dict(steps[0], traced=False)] + steps
    assert metrics.read("lut_gemm_roofline.serve", record(trace=tr, steps=early)) == \
        metrics.read("lut_gemm_roofline.serve", run)
    # idle 0..100 inside the first step before its replay; 260..360 and
    # 520..1000 inside a replay
    assert dict(tr.top_gaps()) == pytest.approx({"step.pack": 100e-9, "step.replay": 580e-9})
    # the same device timeline under one short step: 260..360 after its
    # replay, 520..1000 outside any step
    late = tracing.Trace(tr.device, (0, 1000), {"kbench.step": [(50, 320)],
                                                 "packed_step": [(60, 200)]})
    assert dict(late.top_gaps()) == pytest.approx(
        {"step.pack": 100e-9, "step.sample": 100e-9, "harness": 480e-9})
    assert tr.top_ops()[0][0].startswith("void fused_lut_gemm_kernel")
