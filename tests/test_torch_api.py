"""PyTorch port vs JAX package: the public API and the two examples.

``repro_torch.core`` and ``repro_torch.serving`` export JAX's names; the
cost counters, ``codebook.assign`` and the kernel-routing snapshot equal
JAX's on a grid of arguments; the ported ``serve_quantized`` and
``train_and_quantize`` run end to end on the CPU; the entry points raise
without a card unless the caller names the CPU.
"""

import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core import kernel_routing as jkr  # noqa: E402
from repro.core import outlier as jol  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import kernel_routing as tkr  # noqa: E402
from repro_torch.core import lut_gemm as tlg  # noqa: E402
from repro_torch.core import outlier as tol  # noqa: E402
from repro_torch.data.pipeline import ByteCorpus, DataConfig, TokenPipeline  # noqa: E402
from repro_torch.examples import serve_quantized, train_and_quantize  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

# the modules: ``repro.core.lut_gemm`` is the function the package binds over its module
jlg = importlib.import_module("repro.core.lut_gemm")


@pytest.mark.parametrize("jmod,tmod", [(jcore, tcore), (jserving, tserving)])
def test_public_names_equal_jax(jmod, tmod):
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name
    from repro_torch.models.model import quantize_model
    assert tcore.quantize_model is quantize_model  # PEP 562, as JAX's
    # JAX binds the function over its module of that name; the port keeps the module
    assert tcore.lut_gemm.lut_gemm is tlg.lut_gemm and callable(jcore.lut_gemm)


def test_counters_equal_jax():
    for n in (2, 7, 64, 2048, 8192, 11008):
        for k in (1, 3, 10, 41):
            assert tol.orizuru_comparisons(n, k) == jol.orizuru_comparisons(n, k)
        assert tol.naive_topk_comparisons(n) == jol.naive_topk_comparisons(n)
    for mu in (1, 2, 4, 8):
        for k in (64, 4096, 11008):
            for eb in (1, 2, 4):
                assert tlg.woq_lut_size(mu, k, eb) == jlg.woq_lut_size(mu, k, eb)
    for na in (2, 3, 4, 8):
        for nw in (3, 4, 8):
            assert tlg.waq_lut_size(na, nw) == jlg.waq_lut_size(na, nw)
            assert tlg.waq_lut_size(na, nw, 4) == jlg.waq_lut_size(na, nw, 4)
            for n_out in (1, 512, 16384):
                assert (tlg.reduction_flops_counting(na, nw, n_out)
                        == jlg.reduction_flops_counting(na, nw, n_out))


@pytest.mark.parametrize("n_centroids", [3, 8, 16])
def test_assign_equals_jax(n_centroids):
    """Nearest centroid of unsorted centroids, ties (equidistant values)
    to the first, as ``argmin``: equal indices."""
    rng = np.random.RandomState(n_centroids)
    cents = rng.randn(n_centroids).astype(np.float32)
    x = np.concatenate([rng.randn(5, 37).astype(np.float32).ravel(), cents,
                        ((cents[:-1] + cents[1:]) / 2).astype(np.float32)])
    got = tcb.assign(torch.tensor(x), torch.tensor(cents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcb.assign(jnp.asarray(x),
                                                                     jnp.asarray(cents))))


def test_routing_snapshot_equals_jax():
    """The same recorded events give the same snapshot (keys and counts);
    reset clears it to JAX's empty snapshot."""
    events = [("record_dispatch", ("nibble", "pallas")), ("record_dispatch", ("byte", "jnp")),
              ("record_dispatch", ("nibble", "pallas")),
              ("record_detect_dispatch", ("nibble", "pallas")),
              ("record_detect_dispatch", ("byte", "jnp")), ("record_comp_route", ("gather",)),
              ("record_comp_route", ("scatter",))]
    for mod in (jkr, tkr):
        mod.reset()
    for fn, args in events:
        getattr(jkr, fn)(*args)
        getattr(tkr, fn)(*args)
    with pytest.warns(RuntimeWarning):
        tkr.record_fallback("byte", "test reason for the snapshot")
    with pytest.warns(RuntimeWarning):
        jkr.record_fallback("byte", "test reason for the snapshot")
    assert tkr.snapshot() == jkr.snapshot()
    assert tkr.dispatch_counts() == jkr.dispatch_counts()
    assert tkr.detect_dispatch_counts() == jkr.detect_dispatch_counts()
    for mod in (jkr, tkr):
        mod.reset()
    assert tkr.snapshot() == jkr.snapshot()


def test_entry_points_need_a_device_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    model = build(get_smoke_config("llama3_2_1b"))
    pipe = TokenPipeline(np.arange(1000, dtype=np.int32) % 256, DataConfig(8, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, TrainConfig(), pipe)
    for main, argv in ((serve_quantized.main, ["--smoke"]),
                       (train_and_quantize.main, ["--steps", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert Trainer(model, TrainConfig(), pipe, device="cpu").device.type == "cpu"


def test_serve_quantized_runs_on_cpu(capsys, tmp_path):
    """``--smoke --speculative --telemetry quality --metrics-json`` on the
    CPU: exit 0, the OK line, no kernel launched."""
    kbuild.reset_counts()
    out_json = tmp_path / "metrics.json"
    rc = serve_quantized.main(["--smoke", "--speculative", "--telemetry", "quality",
                               "--metrics-json", str(out_json), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "speculative serving: token-identical" in out and "quality:" in out
    assert out.rstrip().splitlines()[-1].startswith("OK (QuantSpec-quantized artifact saved")
    assert out_json.exists() and "expfmt" in out_json.read_text()
    for text in serve_quantized.PROMPTS:
        assert f"   {text!r} -> " in out
    assert sum(kbuild.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_train_and_quantize_runs_on_cpu(capsys):
    """A short run: checkpoint, resume at the last step, the CE table's five
    rows with finite values."""
    train_and_quantize.main(["--steps", "12", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "auto-resume check: restored at step 12" in out
    rows = re.findall(r"^(\S+)\s+(\d+\.\d+)\s+(\d+\.\d+)\s+([+-]\d+\.\d+)$", out, re.M)
    assert [r[0] for r in rows] == ["fp32"] + [n for n, _ in train_and_quantize.SPECS]
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert len(ByteCorpus().tokens) > 1 << 16
