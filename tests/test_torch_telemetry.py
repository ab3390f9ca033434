"""PyTorch port vs JAX package: serving telemetry (``serving/telemetry.py``).

* Registry primitives (counter, gauge with ``set_max`` and a callback,
  histogram percentiles with a constant series, empty and bad bounds, the
  bucket helpers, ``StreamingStats``, ``StepMonitor``): the same calls into
  both packages give equal ``snapshot()`` dicts and the same ``ValueError``s.
* The request lifecycle under an injected fake clock -- re-admission,
  idempotent TTFT, the bounded step ring, spans, quality counter tracks,
  ``reset`` -- gives an equal ``snapshot()``, an equal
  ``export_chrome_trace`` JSON and an equal ``expfmt`` text. Host
  arithmetic on the same floats in the same order: equality is exact.
* Engines on the smoke artifact: registry counters equal JAX's for the same
  traffic, after every step (prefix hits and copy-on-write mid-run), for the
  fixed-slot engine's ``serving_fallback_*`` and for speculation. The known
  difference: JAX adds each preemption to ``serving_preemptions`` twice
  (``Scheduler._preempt`` and ``Telemetry.request_preempted``), the port
  once. Time-valued metrics (``*_s`` counters and histograms) are compared
  by observation count only, and the route gauges not at all (JAX counts
  traces, the port calls).
* ``off`` reads all zeros. (That the packed step runs the same aten ops at
  off, metrics and trace, fenced or not, is in
  ``tests/test_torch_graph_step.py``.)
* The host phases of a step record (port only): ``admit`` .. ``commit`` in
  order and disjoint under an injected phase clock, absent from every
  export; under a CPU ``torch.profiler`` run the ``replay`` phase and the
  ``packed_step`` range agree within 100 us (both on the profiler's clock).
* The region boundaries (port only): on the CPU, a recorder set by hand
  sees one flat sequence per packed step -- per quantized projection
  ``qlinear.main``, ``qlinear.detect``, ``qlinear.residual``,
  ``qlinear.comp_dequant``, ``qlinear.comp_matmul``, then ``other``; per
  layer ``attn.core``; ``head`` last -- and the boundaries issue no aten op.
  ``RegionMarks`` launches one marker per boundary while it records and
  keeps the regions in order.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")

import repro.distributed.fault_tolerance as jft  # noqa: E402
import repro.serving.paged_cache as jpc  # noqa: E402
import repro.serving.telemetry as JT  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

import repro_torch.distributed.fault_tolerance as pft  # noqa: E402
import repro_torch.serving.paged_cache as ppc  # noqa: E402
import repro_torch.serving.telemetry as PT  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.speculative import SpeculativeConfig  # noqa: E402

MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")


def _fake_clock():
    t = [0.0]
    return t, (lambda: t[0])


# ---------------------------------------------------------------------------
# registry primitives: the same calls into both packages
# ---------------------------------------------------------------------------

def _counter(T):
    r = T.MetricsRegistry()
    c = r.counter("c", "a counter")
    c.add()
    c.add(2.5)
    assert r.counter("c") is c  # get-or-create
    r.counter("z")
    return r.snapshot()


def _gauge(T):
    r = T.MetricsRegistry()
    g = r.gauge("g", "settable")
    g.set(3)
    g.set_max(2)
    g.set_max(7)
    box = [41]
    r.gauge("cb", fn=lambda: box[0] + 1)
    box[0] = 9
    snap = r.snapshot()
    g.reset()
    return snap, r.snapshot()


def _histogram(T):
    r = T.MetricsRegistry()
    h = r.histogram("h", T.log_buckets(1e-3, 10.0), "latency")
    for v in (5e-4, 0.002, 0.002, 0.03, 0.7, 0.7, 4.0, 50.0):
        h.observe(v)
    lin = r.histogram("lin", T.linear_buckets(0.0, 1.0, 20))
    for v in np.linspace(0.0, 1.0, 33):
        lin.observe(float(v))
    default = r.histogram("default")
    default.observe(0.25)
    return r.snapshot(), [h.percentile(q) for q in (0, 10, 50, 90, 100)]


def _constant(T):
    h = T.Histogram("c", T.linear_buckets(0.0, 1.0, 10))
    for _ in range(7):
        h.observe(0.35)
    return h.summary(), [h.percentile(q) for q in (1, 50, 99)]


def _empty(T):
    h = T.Histogram("e", [1.0])
    return h.summary(), h.percentile(50)


def _buckets(T):
    return T.log_buckets(1e-5, 100.0), T.log_buckets(0.5, 2.0, 3), T.linear_buckets(-1.0, 1.0, 7)


def _streaming(T):
    s = T.StreamingStats(window=4)
    out = [T.StreamingStats().summary()]
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        s.record(v)
        out.append((s.summary(), s.percentile(95), s.median(), s.times))
    return out


def _monitor(ft):
    mon = ft.StepMonitor(window=16, straggler_factor=2.0)
    out = [mon.summary()]
    for v in [0.1] * 12 + [0.15, 0.5, 0.1, 0.9]:
        out.append(mon.is_straggler(v))
        mon.record(v)
    return out + [mon.summary(), mon.straggler_count, mon.times, mon.window]


REGISTRY_CASES = {"counter": _counter, "gauge": _gauge, "histogram": _histogram,
                  "constant series": _constant, "empty histogram": _empty,
                  "bucket helpers": _buckets, "streaming stats": _streaming}


@pytest.mark.parametrize("case", list(REGISTRY_CASES))
def test_registry_primitives_match_jax(case):
    fn = REGISTRY_CASES[case]
    assert fn(PT) == fn(JT)


def test_step_monitor_matches_jax():
    assert pft.StreamingStats is PT.StreamingStats
    assert _monitor(pft) == _monitor(jft)
    assert isinstance(pft.StepMonitor().stats, PT.StreamingStats)


def _raises(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    return None


BAD_CALLS = {
    "histogram bounds descending": lambda T: T.Histogram("h", [2.0, 1.0]),
    "histogram bounds empty": lambda T: T.Histogram("h", []),
    "log_buckets lo >= hi": lambda T: T.log_buckets(1.0, 1.0),
    "log_buckets lo <= 0": lambda T: T.log_buckets(0.0, 1.0),
    "linear_buckets n < 1": lambda T: T.linear_buckets(0.0, 1.0, 0),
    "linear_buckets hi <= lo": lambda T: T.linear_buckets(1.0, 0.0, 4),
    "level": lambda T: T.TelemetryConfig(level="verbose"),
    "step_ring": lambda T: T.TelemetryConfig(step_ring=0),
    "max_requests": lambda T: T.TelemetryConfig(max_requests=0),
    "quality_sample_every": lambda T: T.TelemetryConfig(level="quality",
                                                        quality_sample_every=0),
    "quality_shadow_every": lambda T: T.TelemetryConfig(quality_shadow_every=0),
    "drift threshold": lambda T: T.TelemetryConfig(quality_drift_threshold=0.0),
    "parse": lambda T: T.TelemetryConfig.parse(3),
    "Telemetry at off": lambda T: T.Telemetry(T.TelemetryConfig(level="off")),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_errors_match_jax(case):
    got = _raises(lambda: BAD_CALLS[case](PT))
    assert got is not None and got == _raises(lambda: BAD_CALLS[case](JT))


def test_config_parse_and_levels_match_jax():
    for v in (None, False, True, "off", "metrics", "trace", "quality"):
        assert PT.TelemetryConfig.parse(v).level == JT.TelemetryConfig.parse(v).level
        p, j = PT.make_telemetry(v), JT.make_telemetry(v)
        assert (p.enabled, p.tracing, p.quality, p.fence) == (j.enabled, j.tracing, j.quality,
                                                              j.fence)
    assert PT.make_telemetry("off") is PT.NULL_TELEMETRY
    cfg = PT.TelemetryConfig(level="metrics", fence=True)
    assert PT.make_telemetry(cfg).cfg is cfg


def test_null_telemetry_is_inert(tmp_path):
    n = PT.NULL_TELEMETRY
    n.request_submitted(1, 5)
    n.first_token(1)
    n.tokens_committed(1, 3)
    n.request_preempted(1)
    n.request_finished(1)
    n.step_record(host_s=1, device_s=1, cells=1, budget=1)
    n.counter("x").add(5)
    assert n.counter("x").value == 0 and n.histogram("h").summary() == {"count": 0}
    assert n.snapshot() == {"level": "off"} and n.expfmt() == ""
    with n.annotate("span"):
        pass
    p = n.export_chrome_trace(tmp_path / "t.json")
    assert json.loads(p.read_text()) == json.loads(
        JT.NULL_TELEMETRY.export_chrome_trace(tmp_path / "j.json").read_text())


# ---------------------------------------------------------------------------
# lifecycle and exports under a fake clock
# ---------------------------------------------------------------------------

def _lifecycle(T, level, tmp_path, tag, ring=4, reset_at=None):
    """A scripted run: five requests (one preempted and re-admitted, one
    speculative with two rounds, one still live at the end), step records
    past the ring's bound, spans and quality counter samples. Returns the
    snapshot, the Perfetto JSON and the Prometheus text."""
    t, clock = _fake_clock()
    t[0] = 10.0
    tel = T.Telemetry(T.TelemetryConfig(level=level, step_ring=ring), clock=clock)

    def at(x, fn, *a, **kw):
        t[0] = x
        fn(*a, **kw)

    at(10.5, tel.request_submitted, 0, 4)
    at(10.75, tel.request_submitted, 1, 7)
    at(11.0, tel.request_submitted, 2, 3)
    at(11.25, tel.request_admitted, 0, prefix_hit_tokens=16)
    at(11.5, tel.request_admitted, 1)
    at(11.5, tel.request_event, 1, "prefill_chunk", start=0, n=7)
    at(12.0, tel.first_token, 0)
    at(12.0, tel.first_token, 0)  # idempotent TTFT
    at(12.5, tel.request_preempted, 1)
    at(13.0, tel.tokens_committed, 0, 1)
    at(13.0, tel.tokens_committed, 0, 0)
    at(14.0, tel.request_admitted, 1, prefix_hit_tokens=8)  # re-admission
    at(14.5, tel.first_token, 1)
    at(15.0, tel.tokens_committed, 1, 3)  # a verify round committing 3
    at(15.0, tel.request_event, 1, "verify_round", drafted=3, accepted=2, committed=3)
    at(15.25, tel.request_finished, 0, n_generated=3)
    at(15.5, tel.request_admitted, 2)
    at(16.0, tel.first_token, 2)
    at(16.25, tel.request_submitted, 3, 2)
    at(17.0, tel.request_finished, 1)
    at(17.5, tel.request_finished, 9)  # never submitted: counted, no timeline
    for i in range(7):
        t[0] = 18.0 + i
        tel.step_record(host_s=0.001 * (i + 1), device_s=0.25 / (i + 1), cells=i + 3,
                        budget=16, decode_rows=i % 3, verify_rows=1, prefill_rows=2,
                        blocks_allocated=i, blocks_freed=1, blocks_copied=i % 2)
        if i == reset_at:
            tel.reset()
    t[0] = 30.0
    with tel.annotate("draft_scan"):
        t[0] = 30.125
    tel.quality_counter("numerics_drift_max", 0.25)
    t[0] = 31.0
    tel.quality_counter("numerics_sqnr_db_min", 12.5)
    tel.gauge("numerics_sqnr_db.000.attn.q", "per site").set(12.5)
    tel.counter("serving_block_evictions_pressure").add(2)
    p = tel.export_chrome_trace(tmp_path / f"{tag}.json")
    return tel.snapshot(), json.loads(p.read_text()), tel.expfmt()


@pytest.mark.parametrize("level,reset_at", [("metrics", None), ("trace", None),
                                            ("quality", None), ("trace", 3)])
def test_lifecycle_and_exports_match_jax(tmp_path, level, reset_at):
    got = _lifecycle(PT, level, tmp_path, "port", reset_at=reset_at)
    want = _lifecycle(JT, level, tmp_path, "jax", reset_at=reset_at)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    snap, trace, text = got
    if reset_at is None:
        assert snap["requests"]["ttft_s"]["count"] == 3
        assert snap["requests"]["queue_wait_s"]["count"] == 3  # re-admission kept the first
        assert snap["steps"]["recorded"] == 4  # the ring's bound
        assert snap["counters"]["serving_preemptions"] == 1
    if level != "metrics":
        lanes = {e["tid"] for e in trace["traceEvents"] if e["pid"] == 1 and e["ph"] == "X"}
        assert lanes == ({0, 1, 2} if reset_at is None else set())
        assert any(e["ph"] == "C" and e["pid"] == 2 for e in trace["traceEvents"])
    for line in text.splitlines():  # Prometheus text: comments or "name[{..}] value"
        assert line.startswith("# ") or len(line.rsplit(" ", 1)) == 2


# ---------------------------------------------------------------------------
# engines: the same traffic through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_smoke("llama3_2_1b")
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    qp = j_quantize_model(model, params, MAIN_SPEC)
    d = tmp_path_factory.mktemp("artifact")
    save_quantized(d, cfg, MAIN_SPEC, qp)
    return str(d), model, qp, load_quantized(str(d), device="cpu")


def _comparable(snap: dict) -> dict:
    """A snapshot without what the packages measure or count differently:
    times (``*_s``: counters by value, histograms beyond their count) and
    the route gauges (JAX counts traces, the port calls)."""
    out = {"counters": {k: v for k, v in snap["counters"].items() if not k.endswith("_s")},
           "gauges": {k: v for k, v in snap["gauges"].items()
                      if not (k.startswith("serving_lut_") or k.startswith("serving_outlier_"))},
           "histograms": {k: (h if not k.endswith("_s") else h["count"])
                          for k, h in snap["histograms"].items()}}
    return out


def _once(snap: dict) -> dict:
    """JAX's snapshot with its preemptions counted once."""
    snap = json.loads(json.dumps(snap))
    c = snap["counters"]
    assert c["serving_preemptions"] % 2 == 0
    c["serving_preemptions"] //= 2
    return snap


SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6, 8, 7, 3, 2, 5, 1, 4, 6]  # two full blocks at block 8


def _traffic(vocab):
    rng = np.random.RandomState(11)
    rand = lambda n: [int(x) for x in rng.randint(0, vocab, n)]
    prompts = [SYSTEM + rand(5), rand(4), rand(23), list(SYSTEM), SYSTEM + rand(3), rand(9)]
    return prompts, [14, 2, 6, 8, 7, 5]


def _lockstep(port_sched, jax_sched, prompts, budgets):
    """Submit two requests, then one more every other step; compare the
    comparable registry after every step."""
    done_p, done_j, n, steps = {}, {}, 2, 0
    for i in range(2):
        port_sched.submit(prompts[i], budgets[i], salt=i)
        jax_sched.submit(prompts[i], budgets[i], salt=i)
    while True:
        more_p = port_sched.step(done_p)
        more_j = jax_sched.step(done_j)
        assert more_p == more_j
        steps += 1
        got = _comparable(port_sched.telemetry.snapshot())
        want = _comparable(_once(jax_sched.telemetry.snapshot()))
        assert got == want, f"step {steps}"
        if n < len(prompts) and steps % 2 == 0:
            port_sched.submit(prompts[n], budgets[n], salt=n)
            jax_sched.submit(prompts[n], budgets[n], salt=n)
            n += 1
        elif not more_p and n >= len(prompts):
            break
    assert done_p == done_j
    return port_sched.telemetry.snapshot(), steps


@pytest.mark.parametrize("n_blocks", [0, 9])
def test_registry_counters_match_jax_every_step(artifact, n_blocks):
    _, jmodel, jqp, art = artifact
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8, n_blocks=n_blocks)
    prompts, budgets = _traffic(jmodel.cfg.vocab_size)
    port = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                         batch_slots=3)
    jeng = JEngine(jmodel, jqp, JServe.from_spec(MAIN_SPEC, **kw), batch_slots=3)
    snap, steps = _lockstep(port.scheduler, jeng.scheduler, prompts, budgets)
    c, g = snap["counters"], snap["gauges"]
    assert 0 < c["serving_packed_steps"] == snap["steps"]["recorded"] <= steps
    assert c["serving_prefix_hits"] > 0 and c["serving_cow_copies"] > 0
    assert (c["serving_preemptions"] > 0) == bool(n_blocks)
    assert snap["requests"]["ttft_s"]["count"] == len(prompts)
    assert g["serving_blocks_live"] == 0 and g["serving_running_requests"] == 0
    st = port.stats  # the legacy dict is the registry's
    assert st["packed_steps"] == c["serving_packed_steps"]
    assert st["preemptions"] == c["serving_preemptions"]
    assert st["lut_jnp_calls"] == g["serving_lut_jnp_calls"] > 0


def test_speculative_counters_match_jax(artifact):
    _, jmodel, jqp, art = artifact
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8)
    prompts, budgets = _traffic(jmodel.cfg.vocab_size)
    port = ServingEngine(art.model, art.params,
                         ServeConfig.from_spec(art.spec, speculative=SpeculativeConfig(k=2),
                                               **kw),
                         batch_slots=3, draft=(art.model, art.params))
    jeng = JEngine(jmodel, jqp, JServe.from_spec(MAIN_SPEC, speculative=jspec.SpeculativeConfig(
        k=2), **kw), batch_slots=3, draft=(jmodel, jqp))
    snap, _ = _lockstep(port.scheduler, jeng.scheduler, prompts, budgets)
    c = snap["counters"]
    assert c["serving_spec_rounds"] > 0 and c["serving_accepted_tokens"] > 0
    assert c["serving_draft_steps"] == port.scheduler.draft.steps
    assert snap["histograms"]["serving_spec_accepted_per_round"]["count"] == \
        c["serving_spec_rounds"]
    assert c["serving_draft_time_s"] > 0 and c["serving_target_time_s"] > 0


def test_fixed_slot_counters_match_jax(artifact):
    _, jmodel, jqp, art = artifact
    prompts = [[1, 2, 3, 4], [5, 6], [7]]  # two batches of 2 slots, left padding
    port = ServingEngine(art.model, art.params,
                         ServeConfig.from_spec(art.spec, cache_len=32, paged=False),
                         batch_slots=2)
    jeng = JEngine(jmodel, jqp, JServe.from_spec(MAIN_SPEC, cache_len=32, paged=False),
                   batch_slots=2)
    assert port.generate(prompts, max_new_tokens=4) == jeng.generate(prompts, max_new_tokens=4)
    got = port.snapshot()["counters"]
    assert got == jeng.snapshot()["counters"]
    assert got["serving_fallback_prefills"] == 2 and got["serving_fallback_steps"] == 6
    keys = ("prefills", "steps", "tokens", "prompt_tokens", "pad_tokens", "pad_fraction")
    assert {k: port.stats[k] for k in keys} == {k: jeng.stats[k] for k in keys}


def test_trace_level_timelines_and_perfetto(artifact, tmp_path):
    _, _, _, art = artifact
    eng = ServingEngine(art.model, art.params,
                        ServeConfig.from_spec(art.spec, cache_len=64, block_size=8,
                                              telemetry="trace"), batch_slots=2)
    eng.generate([[1, 2, 3], [4, 5], [6, 7, 8, 9]], max_new_tokens=3)
    tel = eng.telemetry
    assert len(tel.completed) == 3 and not tel._live
    for tr in tel.completed:
        assert tr.t_enqueue <= tr.t_admit <= tr.t_first_token <= tr.t_finish
        assert tr.n_generated == 3
        assert [n for _, n, _ in tr.events][:2] == ["enqueue", "admit"]
        assert {"first_token", "finish", "prefill_chunk"} <= {n for _, n, _ in tr.events}
    data = json.loads(eng.export_chrome_trace(tmp_path / "t.json").read_text())
    ev = data["traceEvents"]
    assert any(e["ph"] == "X" and e["name"] == "packed_step" and e["pid"] == 0 for e in ev)
    assert any(e["ph"] == "X" and e["name"] == "packed_step" and e["tid"] == 1 for e in ev)
    lanes = {e["tid"] for e in ev if e["pid"] == 1 and e["ph"] == "X"}
    assert len(lanes) == 3
    for line in eng.telemetry.expfmt().splitlines():
        assert line.startswith("# ") or float(line.rsplit(" ", 1)[1]) == float(
            line.rsplit(" ", 1)[1])


def test_off_stats_all_zero(artifact):
    _, _, _, art = artifact
    eng = ServingEngine(art.model, art.params,
                        ServeConfig.from_spec(art.spec, cache_len=64, block_size=8,
                                              telemetry="off"), batch_slots=2)
    want = ServingEngine(art.model, art.params,
                         ServeConfig.from_spec(art.spec, cache_len=64, block_size=8),
                         batch_slots=2).generate([[1, 2, 3], [4, 5]], max_new_tokens=4)
    assert eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=4) == want
    assert eng.telemetry is PT.NULL_TELEMETRY and eng.snapshot() == {"level": "off"}
    st = eng.stats
    assert all(v == 0 for k, v in st.items() if k != "graph_capture_s"), st
    assert st["graph_capture_s"] is None


def test_allocator_gauges_match_jax():
    def run(pc, T):
        tel = T.Telemetry(T.TelemetryConfig(level="metrics"))
        a = pc.BlockAllocator(3, prefix_cache=True, telemetry=tel)
        snaps = []
        got = a.alloc(2)
        snaps.append(tel.registry.snapshot())
        a.register(pc.chain_hash(b"s", [1]), got[0])
        a.free(got)
        snaps.append(tel.registry.snapshot())
        a.alloc(3)  # evicts the cached block
        snaps.append(tel.registry.snapshot())
        return snaps, a.evictions

    got = run(ppc, PT)
    assert got == run(jpc, JT)
    assert got[0][-1]["counters"]["serving_block_evictions_pressure"] == 1
    assert got[0][1]["gauges"] == {"serving_blocks_cached": 1, "serving_blocks_free": 2,
                                   "serving_blocks_live": 0}


# ---------------------------------------------------------------------------
# host phases and region boundaries (port only)
# ---------------------------------------------------------------------------

PHASES = ["admit", "plan", "pack", "replay", "sample", "commit"]


def test_step_phases_are_ordered_and_disjoint(artifact, tmp_path):
    """Under a phase clock that counts its reads, every record's phases
    are the six in order, each boundary one read (``pack`` ends where
    ``replay`` starts, as does ``sample`` where ``commit`` starts), and no
    export carries them."""
    from repro_torch.serving.scheduler import Scheduler

    _, _, _, art = artifact
    reads = iter(range(10**6))
    tel = PT.Telemetry(PT.TelemetryConfig(level="trace"), phase_clock=lambda: next(reads))
    sc = ServeConfig.from_spec(art.spec, cache_len=64, block_size=8, prefill_chunk=4)
    sched = Scheduler(art.model, art.params, sc, slots=2, telemetry=tel)
    for p in ([1, 2, 3, 4, 5], [6, 7], [8, 9, 10]):
        sched.submit(p, 4)
    sched.run()
    recs = list(tel.steps)
    assert len(recs) > 3
    at = 0
    for rec in recs:
        names = [n for n, _, _ in rec["phases"]]
        assert names == PHASES
        assert rec["phases"] == [("admit", at, at + 1), ("plan", at + 2, at + 3),
                                 ("pack", at + 4, at + 5), ("replay", at + 5, at + 6),
                                 ("sample", at + 7, at + 8), ("commit", at + 8, at + 9)]
        at += 10
        assert "region_marks" not in rec  # no graph on the CPU
    trace = json.loads(tel.export_chrome_trace(tmp_path / "t.json").read_text())
    steps = [e for e in trace["traceEvents"] if e["name"] == "packed_step" and e["tid"] == 0]
    assert len(steps) == len(recs) and all("phases" not in e["args"] for e in steps)
    assert "phases" not in json.dumps(tel.snapshot()) and "phases" not in tel.expfmt()


def test_replay_phase_is_the_profilers_packed_step_range(artifact):
    """The phases' clock is the profiler's: on the CPU, each step's
    ``replay`` phase and its ``packed_step`` range open and close within
    100 us of each other (after a first run, which pays the profiler
    range's one-time set-up)."""
    from torch.profiler import ProfilerActivity, profile

    _, _, _, art = artifact
    eng = ServingEngine(art.model, art.params,
                        ServeConfig.from_spec(art.spec, cache_len=64, block_size=8),
                        batch_slots=2)
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    eng.generate(prompts, max_new_tokens=3)
    n = len(eng.telemetry.steps)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(prompts, max_new_tokens=3)
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "packed_step")
    replays = [next((a, b) for name, a, b in rec["phases"] if name == "replay")
               for rec in list(eng.telemetry.steps)[n:]]
    assert len(replays) == len(ranges) > 2
    for (a, b), (x, y) in zip(replays, ranges):
        assert abs(a - x) < 100_000 and abs(b - y) < 100_000, (a - x, b - y)


class _Marks:
    """A stand-in region recorder: keeps the names, records nothing."""

    def __init__(self):
        self.names: list[str] = []

    def mark(self, name):
        self.names.append(name)


def test_region_boundaries_are_flat_and_issue_no_op(artifact):
    """One packed step on the CPU with a recorder set by hand: each
    quantized projection marks main, detect, residual, comp_dequant and
    comp_matmul, then other; attention's core and the head come once a
    layer and once; every region is closed by the next boundary. The aten
    ops are the same as without the recorder, and with none set a boundary
    does nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.serving.speculative import make_packed_fn

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    _, _, _, art = artifact
    step = make_packed_fn(art.model)
    n = art.model.cfg.n_layers

    def run(marks):
        pools = art.model.init_caches(2, 64, "float32", quantized=True, layout="paged",
                                      block_size=8, device="cpu")
        bt = torch.tensor([[0, 1, -1, -1, -1, -1, -1, -1], [2, -1, -1, -1, -1, -1, -1, -1]],
                          dtype=torch.int32)
        pos = torch.tensor([[0], [1], [2], [0]], dtype=torch.int32)
        slots = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
        token = PT._REGIONS.set(marks) if marks is not None else None
        try:
            with Ops() as rec:
                _, logits = step(art.params, pools, bt, slots, pos, pos[:, 0] + 1, pos * 5)
        finally:
            if token is not None:
                PT._REGIONS.reset(token)
        return rec.ops, logits

    marks = _Marks()
    ops_marked, logits_marked = run(marks)
    ops_plain, logits_plain = run(None)
    assert ops_marked == ops_plain and torch.equal(logits_marked, logits_plain)
    proj = ["qlinear.main", "qlinear.detect", "qlinear.residual", "qlinear.comp_dequant",
            "qlinear.comp_matmul", "other"]
    layer = proj * 3 + ["attn.core", "other"] + proj * 3  # wq wk wv, core, wo wi wd
    assert marks.names == layer * n + ["head", "other"]
    assert PT.region("qlinear.main") is None  # no recorder: nothing happens


def test_region_marks_record_one_marker_per_boundary(monkeypatch):
    """While recording, each boundary launches one marker kernel and keeps
    its region's name, between the step's opening and closing ``other``;
    before and after, a boundary does neither."""
    launched = []
    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    marks = PT.RegionMarks()
    PT.region("head")
    with marks.recording():
        PT.region("qlinear.main")
        PT.region("other")
        PT.region("head")
    PT.region("head")
    assert marks.names == ("other", "qlinear.main", "other", "head", "other")
    assert launched == [1] * 5
