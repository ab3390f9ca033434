"""PyTorch port vs JAX package: the ported quickstart and the calibration /
artifact pieces it runs (``fit_activation_codebook``, Fisher-weighted
``kmeans_fit``, ``static_thresholds``, ``lut_gemm_counting``,
``quantize_linear``, ``save_quantized``).

K-Means in the two packages sums in other orders, so codebooks agree to a
few float32 ulps, not bit for bit (ROADMAP queue 3); each assert states its
tolerance. Where the point is the arithmetic of one function, both sides get
the same quantized operands.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import artifact as jart  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core import outlier as jol  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.core.lut_gemm import build_lut as j_build_lut  # noqa: E402
from repro.core.lut_gemm import lut_gemm_counting as j_counting  # noqa: E402
from repro.core.qlinear import QLinearConfig as JCfg  # noqa: E402
from repro.core.qlinear import qlinear_apply as j_apply  # noqa: E402
from repro.core.qlinear import quantize_linear as j_quantize_linear  # noqa: E402

from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import lut_gemm as tlg  # noqa: E402
from repro_torch.core import outlier as tol  # noqa: E402
from repro_torch.core import quantize as tqz  # noqa: E402
from repro_torch.core.artifact import save_quantized  # noqa: E402
from repro_torch.core.qlinear import QLinearConfig, qlinear_apply, quantize_linear  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def n(a):
    return np.asarray(a)


def test_quickstart_runs_on_cpu(capsys):
    build.reset_counts()
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for step in range(1, 6):
        assert f"== {step}." in out
    assert out.rstrip().endswith("OK")
    assert sum(build.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_quickstart_steps_match_jax(tmp_path):
    """The port's five steps against the JAX package's on the same inputs."""
    w, x = quickstart.inputs()
    got = quickstart.run(w, x, "cpu", artifact_dir=str(tmp_path), verbose=False)
    wj, xj = jnp.asarray(w), jnp.asarray(x)
    # step 2: the activation codebook, a few ulps apart (summation order)
    book = jqz.fit_activation_codebook(xj, nbits=4)
    np.testing.assert_allclose(got["act_codebook"].numpy(), n(book), rtol=1e-5, atol=1e-6)
    # step 3 on JAX's operands: counting == factorized == kernel (plain) in the port
    qwj = jqz.quantize_weight(wj, nbits=4)
    qaj = jqz.quantize_activation(xj, book)
    qw = tqz.QuantizedWeight(packed=t(n(qwj.packed)), codebook=t(n(qwj.codebook)),
                             scale=t(n(qwj.scale)), shape=qwj.shape, nbits=4)
    qa = tqz.QuantizedActivation(idx=t(n(qaj.idx)), scale=t(n(qaj.scale)),
                                 codebook=t(n(book)), nbits=4)
    want = n(j_counting(qaj, qwj))
    scale = np.abs(want).max()
    np.testing.assert_allclose(tlg.lut_gemm_counting(qa, qw).numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tlg.lut_gemm(qa, qw).numpy(), want, rtol=0, atol=1e-5 * scale)
    assert torch.equal(got["y_kernel"], got["y_factorized"])
    ys = got["y_counting"]
    np.testing.assert_allclose(ys.numpy(), got["y_factorized"].numpy(), rtol=0,
                               atol=1e-5 * ys.abs().max().item())
    # step 4: compensation recovers accuracy on both sides, by a similar amount
    cfg = JCfg(detection="dynamic", outlier_frac=0.01)
    y_ref = xj @ wj
    j_err = float(jnp.linalg.norm(j_apply(j_quantize_linear(wj, xj, cfg), xj, cfg) - y_ref)
                  / jnp.linalg.norm(y_ref))
    assert got["err_oasis"] < got["err_plain"]
    np.testing.assert_allclose(got["err_oasis"], j_err, rtol=0.05)
    # step 5: the port-written artifact loads in JAX and gives the port's logits
    loaded = jart.load_quantized(str(tmp_path))
    batch = {"tokens": jnp.arange(8, dtype=jnp.int32)[None] % loaded.model.cfg.vocab_size}
    j_logits = n(loaded.model.apply(loaded.params, batch).logits)
    np.testing.assert_allclose(got["logits"].numpy(), j_logits, rtol=0,
                               atol=1e-4 * np.abs(j_logits).max())


def test_port_artifact_manifest_mirrors_jax(tmp_path):
    """Same config and spec: the port writes the structure, tensor names,
    dtypes and shapes JAX writes (only the bytes differ: other weights)."""
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.core import QuantSpec as JSpec
    from repro.core import quantize_model as j_quantize_model
    from repro.models.model import build as j_build

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import build, quantize_model

    spec = quickstart.SPEC
    cfg = get_smoke_config("llama3_2_1b")
    model = build(cfg)
    save_quantized(tmp_path / "port", cfg, spec,
                   quantize_model(model, model.init(seed=0, device="cpu"), spec))
    jm = j_build(j_smoke("llama3_2_1b"))
    jspec = JSpec.from_json_dict(spec.to_json_dict())
    jart.save_quantized(tmp_path / "jax", jm.cfg, jspec,
                        j_quantize_model(jm, jm.init(jax.random.PRNGKey(0)), jspec))
    mine = json.loads((tmp_path / "port" / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    for key in ("format_version", "model", "spec", "structure"):
        assert mine[key] == theirs[key], key
    strip = lambda m: {k: (v["dtype"], v["shape"]) for k, v in m["tensors"].items()}
    assert strip(mine) == strip(theirs)
    assert not (tmp_path / "port" / ".manifest.json.tmp").exists()


@pytest.mark.parametrize("scan_layers", [True, False])
def test_port_artifact_round_trip(tmp_path, scan_layers):
    """save -> the port's own loader: every tensor and config back bit for bit."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.artifact import load_quantized, load_tensors
    from repro_torch.models.model import build, quantize_model

    cfg = dataclasses.replace(get_smoke_config("oasis_7b"), scan_layers=scan_layers)
    model = build(cfg)
    qp = quantize_model(model, model.init(seed=2, device="cpu"), quickstart.SPEC)
    save_quantized(tmp_path / "a", cfg, quickstart.SPEC, qp)
    art = load_quantized(str(tmp_path / "a"), device="cpu")
    assert art.model.cfg == cfg and art.spec == quickstart.SPEC
    save_quantized(tmp_path / "b", cfg, art.spec, art.params)  # saving the loaded copy
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text()) for d in "ab"]
    assert manifests[0] == manifests[1]  # names, dtypes, shapes and hashes of every tensor
    ta, tb = (load_tensors(str(tmp_path / d)) for d in "ab")
    assert ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)
    toks = torch.arange(6)[None]
    assert torch.equal(model.apply(qp, {"tokens": toks}).logits,
                       art.model.apply(art.params, {"tokens": toks}).logits)


# ---------------------------------------------------------------------------
# calibration numerics
# ---------------------------------------------------------------------------

def _calib(seed=0, tokens=48, k=64):
    rng = np.random.RandomState(seed)
    x = (rng.randn(tokens, k) * 1.5).astype(np.float32)
    x[:, 5] *= 8
    fisher = (rng.rand(tokens, k) ** 2).astype(np.float32)
    return x, fisher


@pytest.mark.parametrize("method", ["kmeans", "uniform"])
@pytest.mark.parametrize("fisher", [False, True])
@pytest.mark.parametrize("nbits", [3, 4])
def test_fit_activation_codebook_matches_jax(nbits, fisher, method):
    """Centroids within 1e-5 relative (K-Means sums in other orders; the
    uniform grid differs only by the scale's last ulps)."""
    x, f = _calib(nbits)
    fw = f if fisher else None
    want = n(jqz.fit_activation_codebook(jnp.asarray(x), nbits=nbits,
                                         fisher=None if fw is None else jnp.asarray(fw),
                                         method=method))
    got = tqz.fit_activation_codebook(t(x), nbits=nbits, fisher=None if fw is None else t(fw),
                                      method=method)
    assert got.shape == (2**nbits,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kmeans_fit_weighted_matches_jax_and_unweighted_is_unchanged():
    """Fisher-weighted Lloyd against JAX; ``w=None`` keeps the unweighted
    fit, and all-ones weights land on it too."""
    x, f = _calib(7, tokens=64, k=32)
    want = n(jcb.kmeans_fit(jnp.asarray(x), 16, w=jnp.asarray(f)))
    got = tcb.kmeans_fit(t(x), 16, w=t(f))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    plain = tcb.kmeans_fit(t(x), 16)
    np.testing.assert_allclose(plain.numpy(), n(jcb.kmeans_fit(jnp.asarray(x), 16)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcb.kmeans_fit(t(x), 16, w=torch.ones(x.size)).numpy(),
                               plain.numpy(), rtol=1e-5, atol=1e-6)
    wq = n(jcb.quantile_init(jnp.asarray(x), 16, jnp.asarray(f)))
    assert np.array_equal(tcb.quantile_init(t(x), 16, t(f)).numpy(), wq)


@pytest.mark.parametrize("frac", [0.005, 0.05])
def test_static_thresholds_match_jax(frac):
    """Sort + linear interpolation, as ``jnp.quantile``: within one ulp."""
    x, _ = _calib(3, tokens=200, k=96)
    lo, hi = tol.static_thresholds(t(x), frac)
    jlo, jhi = jol.static_thresholds(jnp.asarray(x), frac)
    assert lo.dim() == hi.dim() == 0
    np.testing.assert_allclose([lo.item(), hi.item()], [float(jlo), float(jhi)], rtol=2.5e-7)


@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (8, 4), (4, 3)])
def test_lut_gemm_counting_matches_jax(w_bits, a_bits):
    rng = np.random.RandomState(w_bits + a_bits)
    wj = jqz.quantize_weight(jnp.asarray(rng.randn(40, 24).astype(np.float32)), nbits=w_bits)
    book = jnp.sort(jnp.asarray(rng.randn(2**a_bits).astype(np.float32)))
    qaj = jqz.quantize_activation(jnp.asarray(rng.randn(3, 40).astype(np.float32)), book)
    want = n(j_counting(qaj, wj))
    qw = tqz.QuantizedWeight(packed=t(n(wj.packed)), codebook=t(n(wj.codebook)),
                             scale=t(n(wj.scale)), shape=wj.shape, nbits=w_bits)
    qa = tqz.QuantizedActivation(idx=t(n(qaj.idx)), scale=t(n(qaj.scale)),
                                 codebook=t(n(book)), nbits=a_bits)
    assert torch.equal(qw.indices, t(n(wj.indices)).int())
    np.testing.assert_allclose(tlg.build_lut(qa.codebook, qw.codebook).numpy(),
                               n(j_build_lut(book, wj.codebook)), rtol=0, atol=0)
    got = tlg.lut_gemm_counting(qa, qw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("detection", ["dynamic", "static", "static_dense"])
def test_quantize_linear_matches_jax(detection):
    """Same weight and calibration set: the port's PTQ gives codebooks and
    thresholds within a few ulps of JAX's, and the layer's outputs agree."""
    rng = np.random.RandomState(len(detection))
    w = rng.randn(64, 32).astype(np.float32)
    calib = (rng.randn(80, 64) * 1.5).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    jcfg = JCfg(detection=detection, outlier_frac=0.02, kernel="jnp", detect_kernel="jnp")
    jp = j_quantize_linear(jnp.asarray(w), jnp.asarray(calib), jcfg, bias=jnp.asarray(bias))
    cfg = QLinearConfig(detection=detection, outlier_frac=0.02, kernel="jnp",
                        detect_kernel="jnp")
    p = quantize_linear(t(w), t(calib), cfg, bias=t(bias))
    np.testing.assert_allclose(p.act_codebook.numpy(), n(jp.act_codebook), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.qw.codebook.numpy(), n(jp.qw.codebook), rtol=1e-5, atol=1e-6)
    if detection == "dynamic":
        assert p.thr_lo is None and jp.thr_lo is None
    else:
        np.testing.assert_allclose([p.thr_lo.item(), p.thr_hi.item()],
                                   [float(jp.thr_lo), float(jp.thr_hi)], rtol=2.5e-7)
    x = (rng.randn(5, 64) * 2).astype(np.float32)
    want = n(j_apply(jp, jnp.asarray(x)))
    np.testing.assert_allclose(qlinear_apply(p, t(x)).numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_kernel_and_detect_route_swaps_share_tensors():
    """with_kernel_route / with_detect_route: a copy with the routes swapped
    and nothing re-quantized (tensors shared), on one layer and on a model."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.qlinear import QLinear, with_detect_route, with_kernel_route
    from repro_torch.models.model import build, quantize_model

    x, _ = _calib(1)
    p = quantize_linear(t(x[:, :32].T.copy()), t(x[:, :48]), QLinearConfig(detection="dynamic"))
    q = with_kernel_route(with_detect_route(p, "pallas"), "jnp")
    assert (q.cfg.kernel, q.cfg.detect_kernel) == ("jnp", "pallas")
    assert p.cfg.kernel == "auto" and q.qw is p.qw
    model = build(get_smoke_config("llama3_2_1b"))
    qp = quantize_model(model, model.init(seed=0, device="cpu"), quickstart.SPEC)
    swapped = with_kernel_route(qp, "jnp")
    mods = [(a, b) for a, b in zip(qp.modules(), swapped.modules()) if isinstance(a, QLinear)]
    assert mods and all(b.cfg.kernel == "jnp" and a.cfg.kernel == "auto" for a, b in mods)
    assert all(a.packed is b.packed for a, b in mods)
    toks = {"tokens": torch.arange(5)[None]}
    assert torch.equal(model.apply(qp, toks).logits, model.apply(swapped, toks).logits)
