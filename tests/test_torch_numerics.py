"""PyTorch port vs JAX package: the quantization-quality probes
(``core/numerics.py``), ``calib_stats`` and the ``quality`` telemetry level.

Tolerances, stated once:

* Index histograms (and ``util``, ``dead``, ``act_tokens``) are exact when
  both packages are handed the same ``QuantizedActivation`` (the parity
  contract). When each side quantizes for itself, an index can flip where
  PyTorch's per-token RMS sits a few ulps from XLA's; on the inputs below
  none flips, and the trained fixture is held with a margin of
  ``HIST_MARGIN`` counts per site (a flip moves one count between two bins,
  so 2 per flip), stated where it is used.
* Float statistics (entropy, saturation, SQNR, moments, energy): rtol 1e-5
  and atol 1e-6, the rounding of float32 sums of a few thousand terms in two
  orders (measured: under 2e-6 relative on the smoke engine).
* ``activation_stats``, ``drift_score`` and ``QualityMonitor`` run the same
  host arithmetic on the same floats: exact.
* ``topk_overlap``: the port ranks against its plain detection route (the
  kernels' order), JAX against ``lax.top_k``. They agree (1.0 and the same
  partial overlaps) on rows without tied +-0 values, which every input here
  is; on a row with tied +-0 values ``lax.top_k`` orders -0.0 below +0.0 and
  the port does not (ROADMAP queue 3), which ``test_topk_overlap_signed_zero``
  pins.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import numerics as jnx  # noqa: E402
from repro.core import outlier as jol  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized as j_save  # noqa: E402
from repro.core.artifact import load_calib_stats as j_load_calib_stats  # noqa: E402
from repro.core.qlinear import qlinear_apply as j_apply  # noqa: E402
from repro.core.qlinear import quantize_linear  # noqa: E402
from repro.core.quantspec import _cfg_to_json  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.telemetry import TelemetryConfig as JTelCfg  # noqa: E402
from repro.serving.telemetry import make_telemetry as j_make_telemetry  # noqa: E402

from repro_torch.core import numerics as nx  # noqa: E402
from repro_torch.core import outlier as ol  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core.artifact import load_calib_stats, load_quantized, save_quantized  # noqa: E402
from repro_torch.core.qlinear import QLinearParams, qlinear_apply  # noqa: E402
from repro_torch.core.quantize import QuantizedWeight  # noqa: E402
from repro_torch.core.quantspec import _cfg_from_json  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.speculative import (SpeculativeConfig, make_packed_fn,  # noqa: E402
                                             make_probed_packed_fn)
from repro_torch.serving.telemetry import TelemetryConfig, make_telemetry  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
HIST_MARGIN = 4  # counts per site on the trained fixture: two index flips
INT_STATS = {"a_hist", "w_hist", "a_util", "a_dead", "w_util", "w_dead", "act_tokens",
             "out_overlap"}
MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
FLOAT_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                   rules=[("mlp/wd", {"w_bits": 8})], kv_dtype="float32")
TRAINED = pathlib.Path(__file__).resolve().parent / "fixtures" / "trained_oasis_smoke"


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def to_port(p) -> QLinearParams:
    qw = QuantizedWeight(packed=t(p.qw.packed), codebook=t(p.qw.codebook),
                         scale=t(p.qw.scale), shape=p.qw.shape, nbits=p.qw.nbits)
    return QLinearParams(qw=qw, act_codebook=t(p.act_codebook), bias=t(p.bias),
                         thr_lo=t(p.thr_lo), thr_hi=t(p.thr_hi),
                         cfg=_cfg_from_json(_cfg_to_json(p.cfg)))


def _layer(detection="dynamic", frac=0.1, w_bits=4, a_bits=4, seed=0, k=32, n=24):
    rng = np.random.RandomState(seed)
    w = jnp.asarray(rng.randn(k, n).astype(np.float32))
    calib = jnp.asarray(rng.randn(128, k).astype(np.float32))
    cfg = JCfg(w_bits=w_bits, a_bits=a_bits, detection=detection, outlier_frac=frac)
    jp = quantize_linear(w, calib, cfg)
    return jp, to_port(jp)


def _host(d: dict) -> dict:
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def assert_stats_match(got: dict, want: dict, hist_margin: int = 0):
    """Port probe dict vs JAX's (both on the host), under the tolerances of
    the module docstring."""
    assert sorted(got) == sorted(want)
    for key in want:
        stat = key.rpartition("/")[2]
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        assert g.shape == w.shape, key
        if stat in ("a_hist", "w_hist") and hist_margin:
            assert np.abs(g - w).sum() <= hist_margin and g.sum() == w.sum(), key
        elif stat in INT_STATS:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

def _naming(mod):
    col = mod.ProbeCollector()
    col.announce("attn.q")
    col.emit({"a": 1.0})
    col.emit({"b": 2.0})  # not announced: a numbered site
    col.announce("attn.q")
    col.emit({"a": 3.0})
    return col.out, [mod.site_tap(s) for s in ("000.attn.q", "017.mlp.wi", "noprefix")]


def test_collector_naming_matches_jax():
    assert _naming(nx) == _naming(jnx)
    assert not nx.collecting()
    with nx.collect() as col:
        assert nx.collecting()
        nx.announce("mlp.wd")
        nx.announce(None)  # no name: keeps the last
        assert col.site() == "000.mlp.wd"
    assert not nx.collecting()
    nx.announce("attn.q")  # outside collect: nothing to name


def test_probe_flag_mutes_sites():
    _, p = _layer()
    x = torch.ones((2, 32))
    qlinear_apply(p, x)  # no collector: nothing happens
    muted = dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, probe=False))
    with nx.collect() as col:
        qlinear_apply(muted, x)
    assert col.out == {}
    with nx.collect() as col:
        y = qlinear_apply(p, x)
    assert col.out and torch.equal(y, qlinear_apply(p, x))  # the output is untouched


# ---------------------------------------------------------------------------
# reductions against JAX's
# ---------------------------------------------------------------------------

def _x(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("n_bins,weighted", [(16, False), (16, True), (8, False),
                                             (256, True)])
def test_index_stats_match_jax(n_bins, weighted):
    rng = np.random.RandomState(n_bins)
    idx = rng.randint(0, n_bins // 2 if n_bins > 8 else n_bins, (3, 5, 40)).astype(np.int32)
    w = (rng.rand(3, 5, 1) > 0.3).astype(np.float32) if weighted else None
    got = _host(nx.index_stats(t(idx), n_bins, weights=t(w)))
    want = _host(jnx.index_stats(jnp.asarray(idx), n_bins,
                                 weights=None if w is None else jnp.asarray(w)))
    assert_stats_match(got, want)
    ref = np.bincount(idx.reshape(-1), minlength=n_bins,
                      weights=None if w is None else np.broadcast_to(w, idx.shape).reshape(-1))
    np.testing.assert_array_equal(got["hist"], ref.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reductions_on_the_same_qa_match_jax(dtype):
    """Saturation, SQNR, outlier energy, overlap and moments, each package
    handed the same indices, scale and outlier set."""
    jp, p = _layer(seed=3)
    xs = _x(1, (6, 32), 2.0)
    xs[:, 5] *= 6.0
    xj = jnp.asarray(xs).astype(jnp.dtype(dtype))
    xp = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)
    jqa = jqz.quantize_activation(xj, jp.act_codebook, "rms")
    qa = qz.QuantizedActivation(idx=t(jqa.idx).int(), scale=t(jqa.scale),
                                codebook=p.act_codebook, nbits=4)
    jouts = jol.detect_outliers_topk(xj.astype(jnp.float32), 3)
    outs = ol.OutlierSet(values=t(jouts.values), channels=t(jouts.channels), mask=t(jouts.mask))
    partial = ol.OutlierSet(values=outs.values, channels=outs.channels.roll(1, dims=0),
                            mask=outs.mask)
    jpartial = jol.OutlierSet(values=jouts.values, channels=jnp.roll(jouts.channels, 1, 0),
                              mask=jouts.mask)
    for m in (None, mask):
        mt, mj = t(m), None if m is None else jnp.asarray(m)
        got = {"sat": nx.saturation_rate(xp, p.act_codebook, "rms", mt),
               "sqnr": nx.sqnr_db(xp, qa, mt),
               "energy": nx.outlier_energy_fraction(xp, outs, mt),
               "overlap": nx.topk_overlap(outs, xp, 3, mt),
               "partial_overlap": nx.topk_overlap(partial, xp, 3, mt),
               **nx.activation_moments(xp, mt)}
        want = {"sat": jnx.saturation_rate(xj, jp.act_codebook, "rms", mj),
                "sqnr": jnx.sqnr_db(xj, jqa, mj),
                "energy": jnx.outlier_energy_fraction(xj, jouts, mj),
                "overlap": jnx.topk_overlap(jouts, xj, 3, mj),
                "partial_overlap": jnx.topk_overlap(jpartial, xj, 3, mj),
                **jnx.activation_moments(xj, mj)}
        g, w = _host(got), _host(want)
        assert g["overlap"] == w["overlap"] == 1.0
        assert g["partial_overlap"] == w["partial_overlap"] < 1.0
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_topk_overlap_signed_zero():
    """A row whose low side reaches tied +-0 values: the port (the kernels'
    order: +-0 tie, lowest channel first) takes the +0 at channel 2,
    ``lax.top_k`` (-0.0 below +0.0) the -0 at channel 3, so JAX scores the
    port's detection 3/4 where the port scores it 1."""
    x = np.array([[1.0, 2.0, 0.0, -0.0, -1.0]], np.float32)
    exact = ol.detect_outliers_topk(t(x), 2)  # what the port's kernels detect
    assert exact.channels.tolist() == [[1, 0, 4, 2]]
    assert nx.topk_overlap(exact, t(x), 2).item() == 1.0
    jouts = jol.OutlierSet(values=jnp.asarray(exact.values.numpy()),
                           channels=jnp.asarray(exact.channels.numpy()),
                           mask=jnp.asarray(exact.mask.numpy()))
    assert float(jnx.topk_overlap(jouts, jnp.asarray(x), 2)) == 0.75


@pytest.mark.parametrize("detection,dtype,route", [
    ("dynamic", "float32", "jnp"), ("dynamic", "bfloat16", "pallas"),
    ("static", "float32", "jnp"), ("none", "float32", "pallas")])
def test_probe_qlinear_matches_jax(detection, dtype, route):
    """The whole hook: one projection under ``collect`` in both packages
    (each quantizes for itself; on these inputs no index flips)."""
    jp, p = _layer(detection=detection, frac=0.1 if detection != "none" else 0.0, seed=5)
    jp = dataclasses.replace(jp, cfg=dataclasses.replace(jp.cfg, kernel=route))
    p = dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, kernel=route))
    xs = _x(2, (2, 3, 32), 1.5)
    xj = jnp.asarray(xs).astype(jnp.dtype(dtype))
    xp = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    mask = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    with nx.collect(mask=t(mask)) as col:
        nx.announce("attn.q")
        qlinear_apply(p, xp)
    with jnx.collect(mask=jnp.asarray(mask)) as jcol:
        jnx.announce("attn.q")
        j_apply(jp, xj)
    got, want = _host(col.out), _host(jcol.out)
    assert_stats_match(got, want)
    assert ("000.attn.q/out_overlap" in got) == (detection == "dynamic")


def test_mask_drops_padded_tokens():
    _, p = _layer(seed=7)
    x_valid = _x(4, (3, 32))
    x_pad = np.concatenate([x_valid, 1e3 * _x(5, (2, 32))])
    with nx.collect(mask=t(np.array([1, 1, 1, 0, 0], np.float32))) as col:
        qlinear_apply(p, t(x_pad))
    with nx.collect() as clean:
        qlinear_apply(p, t(x_valid))
    masked = {k.rpartition("/")[2]: v for k, v in _host(col.out).items()}
    want = {k.rpartition("/")[2]: v for k, v in _host(clean.out).items()}
    for stat in ("a_hist", "a_util", "a_dead", "a_entropy", "a_sat", "sqnr_db", "act_mean",
                 "act_rms", "act_absmax_mean", "act_absmax_max", "act_tokens", "out_energy",
                 "out_overlap"):
        np.testing.assert_allclose(masked[stat], want[stat], rtol=RTOL, atol=ATOL,
                                   err_msg=stat)


def test_pathological_codebook_matches_jax():
    idx = np.array([[0, 1, 1, 0], [1, 0, 0, 1]], np.int32)
    got = _host(nx.index_stats(t(idx), 8))
    assert_stats_match(got, _host(jnx.index_stats(jnp.asarray(idx), 8)))
    assert got["dead"] == 6 and got["util"] == 2 / 8
    xs = _x(0, (16, 32))
    for book in (np.linspace(-8.0, 8.0, 16), np.linspace(-0.2, 0.2, 16)):
        book = book.astype(np.float32)
        g = nx.saturation_rate(t(xs), t(book), "rms").item()
        w = float(jnx.saturation_rate(jnp.asarray(xs), jnp.asarray(book), "rms"))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert nx.saturation_rate(t(xs), t(np.linspace(-0.2, 0.2, 16).astype(np.float32)),
                              "rms").item() > 0.5


def test_activation_stats_and_drift_score_match_jax():
    acts = _x(0, (256, 32))
    st = nx.activation_stats(t(acts))
    assert st == jnx.activation_stats(acts) == nx.activation_stats(acts)
    shifted = {**st, "rms": st["rms"] * 5.0, "absmax_mean": st["absmax_mean"] * 5.0}
    for a, b in ((st, st), (shifted, st), (st, shifted), ({}, st), (st, {})):
        assert nx.drift_score(a, b) == jnx.drift_score(a, b)
    assert nx.drift_score(shifted, st) > 3.0


# ---------------------------------------------------------------------------
# QualityMonitor on JAX-produced probe dicts
# ---------------------------------------------------------------------------

def _jax_probe_dicts():
    """Probe dicts of a small JAX forward, then the same with every
    activation statistic scaled 5x (a distribution shift), then normal."""
    jp, _ = _layer(seed=9)
    xs = jnp.asarray(_x(6, (4, 32)))
    with jnx.collect() as col:
        jnx.announce("attn.q")
        j_apply(jp, xs)
        jnx.announce("mlp.wd")
        j_apply(jp, xs * 0.5)
    base = {k: np.asarray(v) for k, v in jax.device_get(col.out).items()}
    shifted = {k: v * 5.0 if k.rpartition("/")[2].startswith("act_") else v
               for k, v in base.items()}
    return [base, base, shifted, base] + [base] * 9 + [shifted]


@pytest.mark.parametrize("calib", ["calibration stats", "self-baseline"])
def test_quality_monitor_matches_jax(calib):
    seq = _jax_probe_dicts()
    stats = None
    if calib == "calibration stats":
        stats = {"attn.q": jnx.activation_stats(_x(7, (64, 32))),
                 "wd": {"mean": 0.0, "rms": 0.3, "absmax_mean": 1.0}}
    tcfg = dict(level="quality", quality_sample_every=1)
    ptel, jtel = make_telemetry(TelemetryConfig(**tcfg)), j_make_telemetry(JTelCfg(**tcfg))
    pmon = nx.QualityMonitor(ptel, calib_stats=stats, drift_threshold=0.5)
    jmon = jnx.QualityMonitor(jtel, calib_stats=stats, drift_threshold=0.5)
    for probes in seq:
        assert pmon.ingest(probes) == jmon.ingest(probes)
        assert ptel.snapshot() == jtel.snapshot()
    assert [v for _, _, v in ptel.quality_series] == [v for _, _, v in jtel.quality_series]
    snap = ptel.snapshot()
    assert snap["counters"]["numerics_drift_alarms"] >= 2  # both shifted steps
    assert snap["counters"]["numerics_probe_steps"] == len(seq)
    families = {k.split(".", 1)[0] for k in snap["gauges"] if "." in k}
    assert families == set(nx._GAUGE_OF.values()) | {"numerics_drift"}


# ---------------------------------------------------------------------------
# calib_stats in the artifact manifest, across the packages
# ---------------------------------------------------------------------------

def test_calib_stats_read_across_packages(tmp_path):
    cfg = j_smoke("llama3_2_1b")
    jmodel = j_build(cfg)
    qp = j_quantize_model(jmodel, jmodel.init(jax.random.PRNGKey(0)), MAIN_SPEC)
    acts = _x(1, (64, cfg.d_model))
    summary = jnx.activation_stats(acts)
    j_save(tmp_path / "jax", cfg, MAIN_SPEC, qp, calib_stats={"attn.q": acts, "mlp.wi": summary})
    assert load_calib_stats(str(tmp_path / "jax")) == j_load_calib_stats(tmp_path / "jax")
    art = load_quantized(str(tmp_path / "jax"), device="cpu")
    save_quantized(str(tmp_path / "port"), cfg, art.spec, art.params,
                   calib_stats={"attn.q": t(acts), "mlp.wi": summary})
    assert j_load_calib_stats(tmp_path / "port") == {"attn.q": summary, "mlp.wi": summary}
    save_quantized(str(tmp_path / "plain"), cfg, art.spec, art.params)
    assert load_calib_stats(str(tmp_path / "plain")) is None
    assert j_load_calib_stats(tmp_path / "plain") is None
    with pytest.raises(FileNotFoundError):
        load_calib_stats(str(tmp_path / "nowhere"))


# ---------------------------------------------------------------------------
# the quality level on the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    cfg = j_smoke("llama3_2_1b")
    jmodel = j_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    out = {}
    for name, spec in (("int4", MAIN_SPEC), ("float", FLOAT_SPEC)):
        qp = j_quantize_model(jmodel, params, spec)
        d = tmp_path_factory.mktemp(name)
        j_save(d, cfg, spec, qp)
        out[name] = (jmodel, qp, spec, load_quantized(str(d), device="cpu"))
    return out


def _quality(sample=1, shadow=2):
    return dict(level="quality", quality_sample_every=sample, quality_shadow_every=shadow)


def _capture_ingest(sched, into: list):
    ingest = sched._quality.ingest
    sched._quality.ingest = lambda probes: (into.append(probes), ingest(probes))[1]


SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6]  # one full block at block_size 8
PROMPTS = [SYSTEM + [40 + i] for i in range(3)] + [[7, 2, 9, 4, 4, 1, 8, 3, 5, 2, 6]]


def test_quality_tokens_and_probes_match_off_and_jax(artifacts):
    """Every step probed, the shadow every other step, prefix sharing on:
    tokens equal the ``off`` level's and JAX's; every probed step's site keys
    equal JAX's letter for letter and its statistics match; the shadow and
    drift metrics equal JAX's."""
    jmodel, jqp, spec, art = artifacts["int4"]
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8)
    off = ServingEngine(art.model, art.params,
                        ServeConfig.from_spec(art.spec, telemetry="off", **kw), batch_slots=2)
    want = off.generate(PROMPTS, max_new_tokens=5)
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(
        art.spec, telemetry=TelemetryConfig(**_quality()), **kw), batch_slots=2)
    jeng = JEngine(jmodel, jqp, JServe.from_spec(spec, telemetry=JTelCfg(**_quality()), **kw),
                   batch_slots=2)
    got_p, got_j = [], []
    _capture_ingest(eng.scheduler, got_p)
    _capture_ingest(jeng.scheduler, got_j)
    assert eng.generate(PROMPTS, max_new_tokens=5) == want == jeng.generate(
        PROMPTS, max_new_tokens=5)
    assert eng.stats["prefix_hits"] > 0
    assert len(got_p) == len(got_j) == eng.stats["packed_steps"]
    sites = sorted({k.rpartition("/")[0] for k in got_p[0]})
    assert sites == [f"{i:03d}.{tap}" for i, tap in enumerate(
        ["attn.q", "attn.k", "attn.v", "attn.o", "mlp.wi", "mlp.wd"] * 2)]
    for p, j in zip(got_p, got_j):
        assert_stats_match(p, j)
    ps, js = eng.snapshot(), jeng.snapshot()
    for name in ("numerics_probe_steps", "numerics_drift_alarms", "numerics_shadow_probes"):
        assert ps["counters"][name] == js["counters"][name], name
    assert ps["counters"]["numerics_probe_steps"] > 0 and ps["counters"]["numerics_shadow_probes"] > 0
    for name in ("numerics_shadow_token_agreement", "numerics_shadow_top1_agreement"):
        assert ps["gauges"][name] == js["gauges"][name]
    kl_p, kl_j = ps["histograms"]["numerics_shadow_logit_kl"], js[
        "histograms"]["numerics_shadow_logit_kl"]
    assert kl_p["count"] == kl_j["count"] > 0
    np.testing.assert_allclose(kl_p["sum"], kl_j["sum"], rtol=1e-3)
    for fam in nx._GAUGE_OF.values():  # every gauge family, every site
        assert all(f"{fam}.{s}" in ps["gauges"] for s in sites), fam
    overlaps = [v for g, v in ps["gauges"].items() if g.startswith("numerics_outlier_topk_overlap")]
    assert len(overlaps) == len(sites) and all(v == 1.0 for v in overlaps)


def test_quality_tokens_with_speculation_match_off_and_jax(artifacts):
    jmodel, jqp, spec, art = artifacts["int4"]
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8)
    prompts = PROMPTS[:2] + PROMPTS[3:]

    def port(level):
        return ServingEngine(art.model, art.params, ServeConfig.from_spec(
            art.spec, telemetry=level, speculative=SpeculativeConfig(k=2), **kw),
            batch_slots=2, draft=(art.model, art.params))

    want = port("off").generate(prompts, max_new_tokens=5)
    eng = port(TelemetryConfig(**_quality()))
    jeng = JEngine(jmodel, jqp, JServe.from_spec(
        spec, telemetry=JTelCfg(**_quality()), speculative=jspec.SpeculativeConfig(k=2), **kw),
        batch_slots=2, draft=(jmodel, jqp))
    assert eng.generate(prompts, max_new_tokens=5) == want == jeng.generate(
        prompts, max_new_tokens=5)
    ps, js = eng.snapshot(), jeng.snapshot()
    assert ps["counters"]["serving_spec_rounds"] == js["counters"]["serving_spec_rounds"] > 0
    assert ps["histograms"]["numerics_spec_first_reject_pos"] == \
        js["histograms"]["numerics_spec_first_reject_pos"]


def test_probed_step_leaves_pools_and_logits_bit_equal(artifacts):
    """The probed step's second forward writes this step's KV cells again
    with the same bits: after each of a run's steps, the pools and logits
    equal the unprobed step's on copies of the same pools."""
    _, _, _, art = artifacts["int4"]
    sc = ServeConfig.from_spec(art.spec, cache_len=64, block_size=8, prefill_chunk=4,
                               telemetry="off")
    eng = ServingEngine(art.model, art.params, sc, batch_slots=2)

    def copy(pools):  # fresh pools (with their scratch block) holding the same pages
        out = art.model.init_caches(2, sc.cache_len, sc.cache_dtype, quantized=sc.kv_quant,
                                    layout="paged", block_size=sc.block_size, device="cpu")
        for new, old in zip(out, pools):
            for k in new:
                new[k].copy_(old[k])
        return out

    sched, calls = eng.scheduler, []
    inner = sched._packed_fn
    sched._packed_fn = lambda params, pools, *a: (
        calls.append((copy(pools), [x.clone() for x in a])), inner(params, pools, *a))[1]
    eng.generate(PROMPTS, max_new_tokens=4)
    plain, probed = make_packed_fn(art.model), make_probed_packed_fn(art.model)
    assert len(calls) > 4
    for pools, inputs in calls:
        a, b = copy(pools), copy(pools)
        _, want = plain(art.params, a, *inputs)
        _, got, probes = probed(art.params, b, *inputs)
        assert torch.equal(got, want)
        assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
        assert len({k.rpartition("/")[0] for k in probes}) == 6 * art.model.cfg.n_layers


def test_shadow_probe_self_reference(artifacts):
    """Shadow parameters = serving parameters on a float pool: the shadow
    forward replays the served distribution, so token and top-1 agreement
    are 1.0 and the KL is float32 noise (JAX's bound, < 1e-3)."""
    _, _, _, art = artifacts["float"]
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(
        art.spec, cache_len=32, block_size=8, prefill_chunk=4,
        telemetry=TelemetryConfig(**_quality(1, 1))), batch_slots=2)
    eng.generate([[1, 2, 3, 4, 5]], max_new_tokens=8)
    snap = eng.snapshot()
    assert snap["counters"]["numerics_shadow_probes"] >= 1
    kl = snap["histograms"]["numerics_shadow_logit_kl"]
    assert kl["count"] >= 1 and kl["max"] < 1e-3
    assert snap["gauges"]["numerics_shadow_token_agreement"] == 1.0
    assert snap["gauges"]["numerics_shadow_top1_agreement"] == 1.0


def test_trained_fixture_probes_match_jax():
    """The committed JAX-trained artifact at ``quality`` (every step
    probed): the port's tokens are ``expected.npz``'s and its first probed
    step matches ``expected_probes.json`` (the JAX engine's), histograms
    within ``HIST_MARGIN`` counts per site."""
    ref = json.loads((TRAINED / "expected_probes.json").read_text())
    with np.load(TRAINED / "expected.npz") as z:
        tokens = z["tokens"].tolist()
        prompts = [[int(b) for b in p.encode()] for p in z["prompts"]]
    art = load_quantized(str(TRAINED), device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(
        art.spec, telemetry=TelemetryConfig(**ref["telemetry"]), **ref["serve_config"]),
        batch_slots=ref["batch_slots"])
    got = []
    _capture_ingest(eng.scheduler, got)
    assert eng.generate(prompts, max_new_tokens=len(tokens[0])) == tokens
    want = {k: np.asarray(v, np.float32) for k, v in ref["probes"].items()}
    assert_stats_match(got[ref["step"]], want, hist_margin=HIST_MARGIN)
    assert all(v == 1.0 for k, v in got[0].items() if k.endswith("/out_overlap"))
