"""One run of one cell: set-up, the measured window, the check.

Set-up makes the float weights on the device from the seed
(``weights.make``), builds the program's model from them
(``params_from_tree``), quantizes it with the program's ``quantize_model``
under the cell's spec, builds ``ServingEngine(..., graph=True)`` and
captures its packed step, then sends ``ramp_s`` seconds of the cell's
traffic. The window drives ``Scheduler.step`` for ``seconds``: requests
are submitted when due (an open arrival law) or whenever the queue runs
short (a closed one) before each step, and when the scheduler has nothing
to do the harness sleeps until the next arrival. Token times are taken on
the harness's clock through the engine's telemetry object, whose
``first_token`` and ``tokens_committed`` calls it wraps. The traced run
(``--trace 1``) fences every step (``TelemetryConfig(fence=True)``), so
the step ring's ``host_s`` leaves out the wait for the device; the runs
that give the end-to-end metrics do not.

At the window's open the set-up's objects are frozen out of the garbage
collector (``gc.freeze``, as a server does after start-up), so that a
collection in the window does not walk them.

After the window the program's state is freed, the weights are made again
from the seed and the reference (``judge``) checks a sample of finished
requests and of the window's last step.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import defaultdict

import numpy as np
import torch

from kbench import cells, judge, traffic, weights

__all__ = ["Run", "run", "step_walls", "model_config", "quant_spec"]

STEP_RING = 1 << 16  # the telemetry's step ring holds every step of a window
TRACE_STEPS = 16  # the traced slice (--trace 1): about the window's last 16 steps
SAMPLE_TOKENS = 300  # served tokens the check compares at least (all, if fewer finished)
LAST_STEP_REQUESTS = 16  # requests of the last step whose cells the check compares


@dataclasses.dataclass
class Run:
    """What a run leaves for the metric readers (``metrics/*.py``)."""

    cfg: dict
    cell: dict
    mix: dict
    t0: float = 0.0  # window start and end, harness clock
    t1: float = 0.0
    steps: list = dataclasses.field(default_factory=list)  # the window's packed steps
    due: dict = dataclasses.field(default_factory=dict)  # rid -> due time (open law)
    first: dict = dataclasses.field(default_factory=dict)  # rid -> first token time
    token_times: dict = dataclasses.field(default_factory=lambda: defaultdict(list))
    lags: list = dataclasses.field(default_factory=list)  # submit - due, open law, window
    prefilled: int = 0  # prompt tokens prefilled in the window
    generated: int = 0  # tokens generated in the window
    attempted: int = 0
    failed: int = 0
    queue: list = dataclasses.field(default_factory=list)  # waiting requests at open, close
    last_slots: dict = dataclasses.field(default_factory=dict)  # slot -> request, last step
    trace: object = None  # tracing.Trace of the window (--trace 1)
    setup_s: float = 0.0
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds of each set-up stage

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def step_walls(rec: Run) -> dict:
    """The window's steps on the harness's clock, in ms: the median and
    the longest step, the steps over twice the median, and the longest
    time between two steps (arrivals and the harness's own work): where a
    stall of the host shows."""
    walls = sorted(1e3 * (s["t1"] - s["t0"]) for s in rec.steps)
    if not walls:
        return {}
    med = walls[len(walls) // 2]
    between = [1e3 * (b["t0"] - a["t1"]) for a, b in zip(rec.steps, rec.steps[1:])]
    return {"median": med, "max": walls[-1], "over_2x_median": sum(w > 2 * med for w in walls),
            "between_max": max(between, default=0.0)}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import ModelConfig

    moe = bool(cfg.get("num_local_experts"))
    kw = dict(n_experts=cfg["num_local_experts"], experts_per_token=cfg["num_experts_per_tok"],
              capacity_factor=cfg["capacity_factor"],
              moe_dispatch_groups=cfg["moe_dispatch_groups"]) if moe else {}
    return ModelConfig(
        arch_id=cfg["name"], family=cfg["family"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        sliding_window=cfg.get("sliding_window") or 0, rope_theta=cfg["rope_theta"],
        act_fn=cfg["hidden_act"], norm="rms", tie_embeddings=cfg["tie_word_embeddings"],
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"], **kw)


def quant_spec(quant: dict):
    """The program's ``QuantSpec`` for a cell's ``quant`` entry."""
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec

    base = QLinearConfig(w_bits=quant["w_bits"], a_bits=quant["a_bits"],
                         detection=quant["detection"], outlier_frac=quant["outlier_frac"])
    return QuantSpec(base=base, rules=[tuple(r) for r in quant.get("rules", ())],
                     kv_bits=quant.get("kv_bits"), kv_dtype=quant["kv_dtype"])


class _Clock:
    """The token hooks: wraps the telemetry's ``first_token`` and
    ``tokens_committed`` so that each token's time lands in ``rec``."""

    def __init__(self, tel, rec: Run):
        self.emitted = 0
        first, committed = tel.first_token, tel.tokens_committed

        def first_token(rid):
            t = time.perf_counter()
            rec.first.setdefault(rid, t)
            rec.token_times[rid].append(t)
            self.emitted += 1
            first(rid)

        def tokens_committed(rid, n):
            t = time.perf_counter()
            rec.token_times[rid].extend([t] * n)
            self.emitted += n
            committed(rid, n)

        tel.first_token, tel.tokens_committed = first_token, tokens_committed


def _span(name: str):
    return torch.profiler.record_function(name)


def _drive(sched, plan, cell, rec: Run, clock: _Clock, results: dict, prompts: dict,
           t_start: float, window_t0: float, seconds: float, trace: bool, on_window=None,
           on_trace=None):
    """Send the traffic from ``t_start`` and step the scheduler; the window
    opens at the first step boundary after ``window_t0`` and lasts
    ``seconds``, and ``on_trace`` is called at the first step boundary
    from which about ``TRACE_STEPS`` steps of the mean length so far are
    left. Steps in the window are recorded in ``rec``, with their cells'
    slots and positions when ``trace``."""
    tel = sched.telemetry
    queue = tel.gauge("serving_queue_depth")
    prefill_c = tel.counter("serving_prefill_tokens")
    target = 0 if plan.open else plan.target(cell["slots"])
    opened = traced = False
    t_end = float("inf")
    i = 0
    busy = False
    while True:
        now = time.perf_counter()
        if not opened and now >= window_t0:
            if on_window is not None:
                on_window()
            opened, rec.t0 = True, time.perf_counter()
            t_end = rec.t0 + seconds
            prefill0, emitted0 = prefill_c.value, clock.emitted
            rec.queue.append(queue.value)
        if now >= t_end:
            break
        if (opened and not traced and on_trace is not None and rec.steps
                and now >= t_end - TRACE_STEPS * (now - rec.t0) / len(rec.steps)):
            on_trace()
            traced = True
        with _span("kbench.arrivals"):
            while True:
                if plan.open:
                    if i >= len(plan.due) or t_start + plan.due[i] > now:
                        break
                    due = t_start + plan.due[i]
                elif queue.value < target:
                    due = now
                else:
                    break
                prompt, n_new = plan.request(i)
                i += 1
                rec.attempted += opened
                try:
                    rid = sched.submit(prompt, n_new)
                except ValueError:
                    rec.failed += opened
                    continue
                prompts[rid] = prompt
                busy = True
                if opened and plan.open:
                    rec.lags.append(time.perf_counter() - due)
                    rec.due[rid] = due
        if not busy:
            wake = t_end if opened else window_t0
            if plan.open and i < len(plan.due):
                wake = min(wake, t_start + plan.due[i])
            with _span("kbench.sleep"):
                time.sleep(max(0.0, wake - time.perf_counter()))
            continue
        n_rec = len(tel.steps)
        emitted = clock.emitted
        before = {r.slot: r for r in sched._running}
        s0 = time.perf_counter()
        with _span("kbench.step"):
            busy = sched.step(results)
        s1 = time.perf_counter()
        if len(tel.steps) == n_rec:
            continue  # no packed step ran
        # the step's requests: those still running and those it finished
        rec.last_slots = before | {r.slot: r for r in sched._running}
        if opened:
            step = dict(tel.steps[-1], t0=s0, t1=s1, sampled=clock.emitted - emitted)
            if trace:
                host = sched._in.host
                step.update(slots=host[1].numpy().copy(), pos=host[2].numpy().copy(),
                            traced=traced)
            rec.steps.append(step)
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    rec.t1 = time.perf_counter()
    # requests that fell due in the window but were not yet submitted wait
    # to its close (keys below 0: no request id was given)
    while plan.open and i < len(plan.due) and t_start + plan.due[i] < rec.t1:
        rec.due[-1 - i] = t_start + plan.due[i]
        rec.attempted += 1
        i += 1
    rec.queue.append(queue.value)
    rec.prefilled = prefill_c.value - prefill0
    rec.generated = clock.emitted - emitted0


def _last_step_cases(sched, by_slot: dict, vocab: int, seed: int) -> list:
    """The window's last packed step: for every cell of a sample of its
    requests, the request's tokens up to the cell, its position and the
    program's logits. The sample is the request with the most cells (a
    prefill chunk, where there is one) and others drawn from the seed, up
    to ``LAST_STEP_REQUESTS``. ``by_slot`` maps the step's slots to their
    requests."""
    host = sched._in.host
    slots, pos = host[1].numpy(), host[2].numpy()
    rows: dict[int, list[int]] = defaultdict(list)
    for row in range(pos.shape[0]):
        p = int(pos[row, 0])
        r = by_slot.get(int(slots[row]))
        if p >= 0 and r is not None and p < len(r.context):
            rows[r.rid].append(row)
    rng = np.random.default_rng([seed, 1])
    most = max(rows, key=lambda rid: len(rows[rid]), default=None)
    rest = [rid for rid in rng.permutation(sorted(rows)).tolist() if rid != most]
    cases = []
    for rid in ([most] + rest)[:LAST_STEP_REQUESTS] if rows else []:
        rr = rows[rid]
        r = next(q for q in by_slot.values() if q.rid == rid)
        ps = [int(pos[row, 0]) for row in rr]
        logits = sched.last_logits[torch.tensor(rr, device=sched.last_logits.device), 0, :vocab]
        cases.append(judge.Case(tokens=list(r.context[: max(ps) + 1]), positions=ps,
                                logits=logits.float().clone()))
    return cases


def _served_cases(results: dict, running: list, prompts: dict, seed: int) -> list:
    """A sample of served tokens, drawn from the seed: the finished request
    with the longest context first, then the other finished requests, then
    the tokens that running requests were served so far, until
    ``SAMPLE_TOKENS`` tokens (or all)."""
    rng = np.random.default_rng(seed)
    order = []
    if results:
        longest = max(results, key=lambda rid: len(prompts[rid]) + len(results[rid]))
        order = [longest] + [rid for rid in rng.permutation(sorted(results)).tolist()
                             if rid != longest]
    served = {rid: list(out) for rid, out in results.items()}
    served.update({r.rid: list(r.generated) for r in running if r.generated})
    order += rng.permutation(sorted(served.keys() - set(order))).tolist()
    cases, n = [], 0
    for rid in order:
        if n >= SAMPLE_TOKENS:
            break
        p, out = prompts[rid], served[rid]
        cases.append(judge.Case(tokens=p + out[:-1],
                                positions=list(range(len(p) - 1, len(p) + len(out) - 1)),
                                served=out))
        n += len(out)
    return cases


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict | None = None, control: bool = False,
        t_process: float | None = None, check: bool = True) -> dict:
    """One run; returns {"run": Run, "memory_peak_bytes",
    "numbers", "correct", "checks", "compared"} and with ``control`` the
    control's numbers on the same cases. ``Run.setup_s`` runs from
    ``t_process`` (the process's start; default: this call) to the
    window's start. Without ``check`` (the knee sweep) nothing is compared
    and ``correct`` is None."""
    from repro_torch.models.model import build, params_from_tree, quantize_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.telemetry import TelemetryConfig

    t_process = time.perf_counter() if t_process is None else t_process
    parts = {}
    mark = [time.perf_counter()]

    def lap(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    cell, cfg, mix = cells.load(cell_name, overrides)
    dev = torch.device(device)
    parts["start_s"] = mark[0] - t_process  # interpreter, imports, CUDA's start
    model = build(model_config(cfg))
    params = params_from_tree(weights.make(cfg, seed, dev), model.cfg)
    lap("weights_s")
    qparams = quantize_model(model, params, quant_spec(cell["quant"]))
    del params
    lap("ptq_s")
    sc = ServeConfig.from_spec(
        quant_spec(cell["quant"]), cache_len=cell["cache_len"], block_size=cell["block_size"],
        prefill_chunk=cell["prefill_chunk"],
        telemetry=TelemetryConfig(level="metrics", step_ring=STEP_RING, fence=trace))
    engine = ServingEngine(model, qparams, sc, batch_slots=cell["slots"],
                           graph=dev.type == "cuda")
    sched = engine.scheduler
    lap("engine_s")
    if sched.graph is not None:
        sched.graph.capture(sched.pools)
    lap("capture_s")
    rec = Run(cfg=cfg, cell=cell, mix=mix, setup_parts=parts)
    clock = _Clock(sched.telemetry, rec)
    results: dict[int, list[int]] = {}
    prompts: dict[int, list[int]] = {}
    ramp = mix["ramp_s"]
    plan = traffic.plan(mix, seed, cfg["vocab_size"], cell.get("rate_per_s"))
    prof = None
    if trace:
        # started before the traffic: the profiler's own start-up is set-up;
        # the slice's first step switches it from warm-up (recording nothing)
        # to recording, and the window's close stops it
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1))
        prof.start()
    slice_span = _span("kbench.window")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def on_window():
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        gc.collect()
        gc.freeze()

    def on_trace():
        sync()
        prof.step()
        slice_span.__enter__()
        prof.sliced = True

    sync()
    t_start = time.perf_counter()
    _drive(sched, plan, cell, rec, clock, results, prompts, t_start, t_start + ramp,
           seconds, trace, on_window, on_trace if prof is not None else None)
    gc.unfreeze()
    rec.setup_s = rec.t0 - t_process
    parts["traffic_s"] = rec.t0 - t_start
    if prof is not None:
        from kbench import tracing

        if getattr(prof, "sliced", False):
            slice_span.__exit__(None, None, None)
        prof.stop()
        rec.trace = tracing.read(prof)
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    cases = (_served_cases(results, sched._running, prompts, seed)
             + _last_step_cases(sched, rec.last_slots, cfg["vocab_size"], seed))
    del engine, sched, qparams, model, clock
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not check:
        return {"run": rec, "memory_peak_bytes": peak, "numbers": {}, "correct": None,
                "checks": {}, "compared": {}}
    tree = weights.make(cfg, seed, dev)
    numbers, ref = judge.readings(tree, cfg, cell["quant"], cases, dev)
    correct, checks = judge.verdict(numbers, cell["limits"])
    out = {"run": rec, "memory_peak_bytes": peak, "numbers": numbers,
           "correct": correct, "checks": checks,
           "compared": {"served_tokens": sum(len(c.positions) for c in cases if c.served),
                        "last_step_cells": sum(len(c.positions) for c in cases
                                               if c.logits is not None)}}
    if control:
        out["control"] = judge.control_readings(tree, cfg, cell["quant"], cases, ref, dev)
    return out
