"""Quantization-numerics observability (port of ``repro/core/numerics.py``):
quality probes of the K-Means quantization on live traffic, and drift
detection.

* **codebook health** -- index occupancy histograms, dead-centroid counts
  and normalised index entropy of the weight and activation codebooks, and
  the activation saturation rate against the codebook's range;
* **SQNR** of the main branch (before compensation), in dB;
* **Orizuru effectiveness** -- the share of the activation energy in the
  detected top-k channels, and the overlap of the detected channel set with
  the plain detection route (``core/outlier.detect_outliers_topk``, which
  ranks as the kernels rank: ``torch.topk``'s order among ties on CUDA is
  unspecified, and bfloat16 activations tie often);
* **calibration drift** -- live activation statistics scored against the
  calibration statistics an artifact carries (``core/artifact.py``), per
  site, with an alarm counter and a
  :class:`~repro_torch.distributed.fault_tolerance.StepMonitor` per site.

:func:`collect` installs a :class:`ProbeCollector` in a context variable;
``qlinear_apply`` then emits each projection's statistics into it. Outside
:func:`collect` every hook returns at once, so the packed step runs the same
aten ops at every telemetry level below ``quality``. Every statistic is a
device tensor computed by ops a CUDA graph can capture (a scatter-add in
place of ``bincount``, masks as float weights, no boolean indexing, no read
back to the host): the probed packed step is captured whole, and its
statistics come to the host in one copy when the step has run.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch

import repro_torch.core.outlier as ol
import repro_torch.core.quantize as qz
from repro_torch.kernels import ops as kops

__all__ = [
    "ProbeCollector", "collect", "collecting", "announce", "probe_qlinear",
    "index_stats", "saturation_rate", "sqnr_db", "outlier_energy_fraction",
    "topk_overlap", "activation_moments", "activation_stats", "drift_score",
    "QualityMonitor", "site_tap",
]

_EPS = 1e-12

_COLLECT: contextvars.ContextVar["ProbeCollector | None"] = contextvars.ContextVar(
    "repro_torch_numerics_collect", default=None)


# ---------------------------------------------------------------------------
# collection context
# ---------------------------------------------------------------------------

class ProbeCollector:
    """Accumulates per-projection probe statistics during one forward.

    ``mask``: optional token-validity weights broadcastable to each
    activation's leading (token) dims; the packed step passes ``positions
    >= 0`` as float, so padded cells add zero to every statistic. ``out``
    maps ``"<site>/<stat>"`` to device tensors; sites are ``"<NNN>.<tap>"``
    in forward order (``announce`` numbers them), one per layer per
    projection.
    """

    def __init__(self, mask=None):
        self.mask = mask
        self.out: dict[str, torch.Tensor] = {}
        self._site: str | None = None
        self._n = 0

    def announce(self, tap: str) -> None:
        self._site = f"{self._n:03d}.{tap}"
        self._n += 1

    def site(self) -> str:
        if self._site is None:  # a qlinear_apply call without a dense_apply tap
            self._site = f"{self._n:03d}.proj"
            self._n += 1
        return self._site

    def emit(self, stats: dict) -> None:
        site = self.site()
        for k, v in stats.items():
            self.out[f"{site}/{k}"] = v
        self._site = None  # one emit per announce


def collecting() -> bool:
    """True iff a probe collector is active."""
    return _COLLECT.get() is not None


@contextlib.contextmanager
def collect(mask=None):
    """Install a :class:`ProbeCollector` for the enclosed forward; yields it."""
    col = ProbeCollector(mask=mask)
    token = _COLLECT.set(col)
    try:
        yield col
    finally:
        _COLLECT.reset(token)


def announce(tap: str | None) -> None:
    """Name the next probed projection (``dense_apply`` passes its tap name).
    A no-op outside :func:`collect`."""
    col = _COLLECT.get()
    if col is not None and tap is not None:
        col.announce(tap)


# ---------------------------------------------------------------------------
# probe reductions (device tensors)
# ---------------------------------------------------------------------------

def _token_weights(x: torch.Tensor, mask) -> torch.Tensor:
    """(leading token dims,) float32 validity weights for ``x`` (..., K)."""
    if mask is None:
        return torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    return torch.broadcast_to(mask, x.shape[:-1]).float()


def _at_least_eps(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(t, min=_EPS)


def _mean(flags: torch.Tensor, dim=None) -> torch.Tensor:
    """The share of true ``flags``: the count divided by a device tensor
    holding the number of flags, which rounds as ``jnp.mean`` (sum / n). On
    CUDA both ``mean`` and division by a Python number multiply by 1 / n,
    which turns 82 hits of 82 into 0.99999994."""
    f = flags.float()
    count = f.sum() if dim is None else f.sum(dim)
    n = f.numel() if dim is None else f.shape[dim]
    return count / torch.full((), n, dtype=torch.float32, device=f.device)


def index_stats(idx: torch.Tensor, n_bins: int, weights=None) -> dict:
    """Codebook-index health: hist (n_bins,) float32 exact counts, util (the
    share of bins hit), dead (bins never hit) and entropy normalised to
    [0, 1] (1 = uniform use of all centroids, 0 = one centroid).
    ``weights``: optional per-element 0/1 weights."""
    hist = kops.index_histogram(idx, n_bins, weights=weights)
    p = hist / _at_least_eps(hist.sum())
    ent = -torch.sum(p * torch.log(_at_least_eps(p)))
    norm = math.log(n_bins) if n_bins > 1 else 1.0
    return {
        "hist": hist,
        "util": _mean(hist > 0),
        "dead": (hist == 0).sum().float(),
        "entropy": (ent / norm).float(),
    }


def saturation_rate(x: torch.Tensor, codebook: torch.Tensor, scale_mode: str = "rms",
                    mask=None) -> torch.Tensor:
    """Share of (masked) elements whose normalised value ``x / s`` lies
    outside the codebook's centroid range."""
    wm = _token_weights(x, mask)
    xn = x.float() / qz.token_scale(x, scale_mode)
    book = codebook.float()
    sat = ((xn < book[0]) | (xn > book[-1])).float()
    return (sat * wm[..., None]).sum() / _at_least_eps(wm.sum() * x.shape[-1])


def sqnr_db(x: torch.Tensor, qa: qz.QuantizedActivation, mask=None) -> torch.Tensor:
    """Main-branch signal-to-quantization-noise ratio in dB (before outlier
    compensation): ``10 log10(sum x^2 / sum (x - q(x))^2)`` over masked
    tokens."""
    wm = _token_weights(x, mask)[..., None]
    xf = x.float()
    err = xf - qz.dequantize_activation(qa)
    sig = (torch.square(xf) * wm).sum()
    noise = _at_least_eps((torch.square(err) * wm).sum())
    return (10.0 * torch.log10(_at_least_eps(sig) / noise)).float()


def outlier_energy_fraction(x: torch.Tensor, outs: ol.OutlierSet, mask=None) -> torch.Tensor:
    """Share of the activation energy in the detected outlier channels."""
    wm = _token_weights(x, mask)
    total = _at_least_eps((torch.square(x.float()) * wm[..., None]).sum())
    captured = (torch.square(outs.values) * outs.mask * wm[..., None]).sum()
    return (captured / total).float()


def topk_overlap(outs: ol.OutlierSet, x: torch.Tensor, k: int, mask=None) -> torch.Tensor:
    """Mean per-token overlap |detected & exact| / 2k between the routed
    detector's channels and the plain dual top-k (1.0 when the detection
    kernel keeps its contract)."""
    exact = ol.detect_outliers_topk(x.float(), k)
    hit = (outs.channels[..., :, None] == exact.channels[..., None, :]).any(-1)
    wm = _token_weights(x, mask)
    per_tok = _mean(hit, -1)
    return ((per_tok * wm).sum() / _at_least_eps(wm.sum())).float()


def activation_moments(x: torch.Tensor, mask=None) -> dict:
    """Live activation statistics in the vocabulary of
    :func:`activation_stats` (mask-weighted): mean, rms, mean and max of the
    per-token absmax, and the effective token count."""
    wm = _token_weights(x, mask)
    xf = x.float()
    n_el = _at_least_eps(wm.sum() * x.shape[-1])
    am = torch.amax(torch.abs(xf), dim=-1)
    n_tok = _at_least_eps(wm.sum())
    return {
        "act_mean": (xf * wm[..., None]).sum() / n_el,
        "act_rms": torch.sqrt((torch.square(xf) * wm[..., None]).sum() / n_el),
        "act_absmax_mean": (am * wm).sum() / n_tok,
        "act_absmax_max": torch.amax(am * wm),
        "act_tokens": wm.sum(),
    }


# ---------------------------------------------------------------------------
# the qlinear_apply hook (active only under collect())
# ---------------------------------------------------------------------------

def probe_qlinear(p, x: torch.Tensor, *, qa, outs, k_out: int, dynamic: bool,
                  scale_mode: str, tier: str) -> None:
    """Emit one projection's probes into the active collector.

    Called by ``qlinear_apply`` after both branches ran, with what the
    routed path produced: ``qa`` is None on the fused route (the indices
    never left the kernel's tile), and the probe recomputes it with
    ``quantize_activation``; ``outs`` is None when the outlier branch is
    off. The layer's output is never touched."""
    col = _COLLECT.get()
    if col is None:
        return
    mask = col.mask
    if qa is None:
        qa = qz.quantize_activation(x, p.act_codebook, scale_mode)
    wm_el = _token_weights(x, mask)[..., None]
    a = index_stats(qa.idx, p.act_codebook.shape[0],
                    weights=torch.broadcast_to(wm_el, qa.idx.shape))
    w = index_stats(p.qw.indices, p.qw.codebook.shape[0])
    stats = {
        "a_hist": a["hist"], "a_util": a["util"], "a_dead": a["dead"],
        "a_entropy": a["entropy"],
        "a_sat": saturation_rate(x, p.act_codebook, scale_mode, mask),
        "sqnr_db": sqnr_db(x, qa, mask),
        "w_hist": w["hist"], "w_util": w["util"], "w_dead": w["dead"],
        "w_entropy": w["entropy"],
        **activation_moments(x, mask),
    }
    if outs is not None and k_out > 0:
        stats["out_energy"] = outlier_energy_fraction(x, outs, mask)
        if dynamic:
            stats["out_overlap"] = topk_overlap(outs, x, k_out, mask)
    col.emit(stats)


# ---------------------------------------------------------------------------
# calibration-time statistics and drift scoring (host side)
# ---------------------------------------------------------------------------

def activation_stats(acts) -> dict:
    """Summary of a (tokens, K) calibration-activation array or tensor, in
    the JSON vocabulary of the artifact manifest's ``calib_stats``: mean,
    rms and quantiles of the per-token absmax."""
    if isinstance(acts, torch.Tensor):
        acts = acts.detach().float().cpu().numpy()
    x = np.asarray(acts, np.float32)
    x = x.reshape(-1, x.shape[-1])
    am = np.max(np.abs(x), axis=-1)
    return {
        "mean": float(x.mean()),
        "rms": float(np.sqrt(np.mean(np.square(x)))),
        "absmax_mean": float(am.mean()),
        "absmax_q50": float(np.quantile(am, 0.5)),
        "absmax_q99": float(np.quantile(am, 0.99)),
        "absmax_max": float(am.max()),
        "tokens": int(x.shape[0]),
        "dim": int(x.shape[1]),
    }


def drift_score(live: dict, calib: dict) -> float:
    """Scale-free distance between live and calibration statistics: the
    worst of the mean, rms and absmax-mean shifts, each over the calibration
    scale (rms for the central statistics, absmax_mean for the tail)."""
    rms_c = max(abs(float(calib.get("rms", 0.0))), 1e-6)
    am_c = max(abs(float(calib.get("absmax_mean", rms_c))), 1e-6)
    return max(
        abs(float(live.get("mean", 0.0)) - float(calib.get("mean", 0.0))) / rms_c,
        abs(float(live.get("rms", 0.0)) - float(calib.get("rms", 0.0))) / rms_c,
        abs(float(live.get("absmax_mean", 0.0))
            - float(calib.get("absmax_mean", 0.0))) / am_c,
    )


def site_tap(site: str) -> str:
    """``"003.attn.q" -> "attn.q"``: the site without its forward-order
    prefix, to match calibration tap names."""
    head, _, tail = site.partition(".")
    return tail if head.isdigit() and tail else site


# probe statistic -> registry gauge family (per-site gauges are named
# "<family>.<site>"; array statistics never become gauges)
_GAUGE_OF = {
    "a_util": "numerics_a_codebook_util",
    "a_dead": "numerics_a_dead_centroids",
    "a_entropy": "numerics_a_index_entropy",
    "a_sat": "numerics_a_saturation",
    "sqnr_db": "numerics_sqnr_db",
    "w_util": "numerics_w_codebook_util",
    "w_dead": "numerics_w_dead_centroids",
    "w_entropy": "numerics_w_index_entropy",
    "out_energy": "numerics_outlier_energy_captured",
    "out_overlap": "numerics_outlier_topk_overlap",
}


class QualityMonitor:
    """Host-side sink of probed steps: registry gauges and drift alarms.

    ``ingest`` takes one probed step's flat ``{site/stat: value}`` dict on
    the host, publishes per-site gauges, scores per-site drift against the
    calibration statistics (or, without them, against the first sampled
    step's own: a self-baseline) and adds to the alarm counter when a site's
    score exceeds ``drift_threshold`` or spikes against its own running
    median (a :class:`StepMonitor` per site)."""

    def __init__(self, telemetry, calib_stats: dict | None = None,
                 drift_threshold: float = 0.5, window: int = 64,
                 straggler_factor: float = 4.0, min_spike: float = 0.25):
        from repro_torch.distributed.fault_tolerance import StepMonitor

        self.tel = telemetry
        self.calib = dict(calib_stats or {})
        self.baseline: dict[str, dict] = {}
        self.threshold = float(drift_threshold)
        self.min_spike = float(min_spike)
        self._mk_monitor = lambda: StepMonitor(window=window,
                                               straggler_factor=straggler_factor)
        self.monitors: dict[str, StepMonitor] = {}
        t = telemetry
        self.c_steps = t.counter("numerics_probe_steps", "packed steps that ran with probes on")
        self.c_alarms = t.counter("numerics_drift_alarms", "per-site calibration-drift alarms")
        self.g_drift_max = t.gauge("numerics_drift_max", "worst per-site drift score, last probe")
        self.g_sqnr_min = t.gauge("numerics_sqnr_db_min", "worst per-site SQNR (dB), last probe")

    def _calib_for(self, site: str) -> dict | None:
        tap = site_tap(site)
        hit = self.calib.get(tap) or self.calib.get(site)
        if hit is not None:
            return hit
        for name, st in self.calib.items():
            if name.endswith(tap) or tap.endswith(name):
                return st
        return None

    def ingest(self, probes: dict) -> dict:
        """One probed step's host values -> gauges and alarms. Returns the
        per-site statistic dicts, each with its ``drift``."""
        sites: dict[str, dict] = {}
        for key, v in probes.items():
            site, _, stat = key.rpartition("/")
            arr = np.asarray(v)
            if arr.ndim:  # histograms stay probe-only
                continue
            sites.setdefault(site, {})[stat] = float(arr)
        drift_max, sqnr_min = 0.0, math.inf
        for site, st in sorted(sites.items()):
            for stat, fam in _GAUGE_OF.items():
                if stat in st:
                    self.tel.gauge(f"{fam}.{site}").set(st[stat])
            if "sqnr_db" in st:
                sqnr_min = min(sqnr_min, st["sqnr_db"])
            live = {"mean": st.get("act_mean", 0.0), "rms": st.get("act_rms", 0.0),
                    "absmax_mean": st.get("act_absmax_mean", 0.0),
                    "absmax_max": st.get("act_absmax_max", 0.0)}
            calib = self._calib_for(site)
            if calib is None:
                calib = self.baseline.setdefault(site, dict(live))
            d = drift_score(live, calib)
            st["drift"] = d
            self.tel.gauge(f"numerics_drift.{site}").set(d)
            mon = self.monitors.get(site)
            if mon is None:
                mon = self.monitors[site] = self._mk_monitor()
            spiked = mon.is_straggler(d) and d > self.min_spike
            mon.record(d)
            if d > self.threshold or spiked:
                self.c_alarms.add()
            drift_max = max(drift_max, d)
        self.c_steps.add()
        self.g_drift_max.set(drift_max)
        if sqnr_min < math.inf:
            self.g_sqnr_min.set(sqnr_min)
        qc = getattr(self.tel, "quality_counter", None)
        if qc is not None:  # Perfetto counter tracks (quality over time)
            qc("numerics_drift_max", drift_max)
            if sqnr_min < math.inf:
                qc("numerics_sqnr_db_min", sqnr_min)
        return sites
