"""PyTorch port vs JAX package: artifacts, parameter trees and model logits.

A JAX ``save_quantized`` artifact loads into the port byte for byte, and the
port's logits match JAX ``Model.apply`` on the oasis_7b and llama3_2_1b smoke
configs, from float parameters and from quantized artifacts. Logit
tolerance: float32 summation order and last-ulp scale differences give
~1e-7 relative; 1e-5 of the logit range is asserted. On the quantized
models a last-ulp scale difference could flip an A4 index on a codebook
boundary (see ``test_torch_qlinear.py``); none does on these seeds, and one
would fail this assert.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402

from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.artifact import load_quantized, load_tensors  # noqa: E402
from repro_torch.core.qlinear import QLinear  # noqa: E402
from repro_torch.core.quantspec import QuantSpec  # noqa: E402
from repro_torch.models.model import build, params_from_numpy, quantize_model  # noqa: E402

MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")


def _tokens(cfg, seed=0, shape=(2, 11)):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape).astype(np.int32)


def _jax_params(arch, seed=0, **overrides):
    cfg = dataclasses.replace(j_smoke(arch), **overrides)
    model = j_build(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


def _logits_close(got: torch.Tensor, want):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_smoke_configs_are_copies():
    for arch in ("llama3_2_1b", "oasis_7b"):
        assert dataclasses.asdict(t_smoke(arch)) == dataclasses.asdict(j_smoke(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_loads_byte_equal(tmp_path, dtype):
    cfg, jm, params = _jax_params("llama3_2_1b", param_dtype=dtype)
    qp = j_quantize_model(jm, params, MAIN_SPEC)
    save_quantized(tmp_path, cfg, MAIN_SPEC, qp)
    art = load_quantized(str(tmp_path), device="cpu")
    assert dataclasses.asdict(art.model.cfg) == dataclasses.asdict(cfg)
    assert art.spec.to_json_dict() == MAIN_SPEC.to_json_dict()

    def same(a: torch.Tensor, b):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype))
        assert a.contiguous().view(torch.uint8).numpy().tobytes() == b.tobytes()

    same(art.params.embed, params["embed"]["table"])
    same(art.params.norm_f, params["norm_f"]["scale"])
    jb = qp["blocks"]
    for i, blk in enumerate(art.params.blocks):
        same(blk.norm1, jb["norm1"]["scale"][i])
        same(blk.norm2, jb["norm2"]["scale"][i])
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wd"))):
            for name in names:
                mod = getattr(getattr(blk, grp), name)
                jp = jb[grp][name]
                assert isinstance(mod, QLinear)
                assert mod.qw_shape == tuple(jp.qw.shape) and mod.qw_nbits == jp.qw.nbits
                same(mod.packed, jp.qw.packed[i])
                same(mod.codebook, jp.qw.codebook[i])
                same(mod.scale, jp.qw.scale[i])
                same(mod.act_codebook, jp.act_codebook[i])
                assert mod.cfg.w_bits == jp.cfg.w_bits
    assert blk.mlp.wd.qw_nbits == 8 and blk.attn.wq.qw_nbits == 4

    names = json.loads((tmp_path / "manifest.json").read_text())["tensors"]
    assert set(load_tensors(str(tmp_path))) == set(names)


def test_artifact_corruption_and_version_refused(tmp_path):
    cfg, jm, params = _jax_params("oasis_7b")
    save_quantized(tmp_path, cfg, MAIN_SPEC, j_quantize_model(jm, params, MAIN_SPEC))
    mf = tmp_path / "manifest.json"
    manifest = json.loads(mf.read_text())
    name = next(iter(manifest["tensors"]))
    manifest["tensors"][name]["sha256"] = "0" * 16
    mf.write_text(json.dumps(manifest))
    with pytest.raises(IOError, match="corruption"):
        load_quantized(str(tmp_path), device="cpu")
    manifest["format_version"] = 99
    mf.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="format"):
        load_quantized(str(tmp_path), device="cpu")
    mf.unlink()
    with pytest.raises(FileNotFoundError):
        load_quantized(str(tmp_path), device="cpu")


@pytest.mark.parametrize("arch", ["oasis_7b", "llama3_2_1b"])
def test_float_logits_match_jax(arch):
    cfg, jm, params = _jax_params(arch, seed=1)
    tok = _tokens(cfg)
    want = jm.apply(params, {"tokens": jnp.asarray(tok)}).logits
    tree = jax.tree.map(np.asarray, params)
    port = params_from_numpy(tree, t_smoke(arch), device="cpu")
    with torch.inference_mode():
        got = build(t_smoke(arch)).apply(port, {"tokens": torch.from_numpy(tok)}).logits
    assert got.shape == want.shape
    _logits_close(got, want)


@pytest.mark.parametrize("arch", ["oasis_7b", "llama3_2_1b"])
def test_quantized_artifact_logits_match_jax(tmp_path, arch):
    cfg, jm, params = _jax_params(arch, seed=2)
    qp = j_quantize_model(jm, params, MAIN_SPEC)
    save_quantized(tmp_path, cfg, MAIN_SPEC, qp)
    art = load_quantized(str(tmp_path), device="cpu")
    tok = _tokens(cfg, seed=3, shape=(3, 9))
    want = jm.apply(qp, {"tokens": jnp.asarray(tok)}).logits
    with torch.inference_mode():
        got = art.model.apply(art.params, {"tokens": torch.from_numpy(tok)}).logits
    _logits_close(got, want)
    last = art.model.apply(art.params, {"tokens": torch.from_numpy(tok)}, last_only=True)
    assert last.logits.shape == (3, 1, cfg.vocab_padded)


def test_port_quantize_model_resolves_like_jax():
    """The port's PTQ: same per-projection configs, scales and activation
    codebooks as JAX's; weight codebooks within the tolerance stated below."""
    cfg, jm, params = _jax_params("llama3_2_1b", seed=4)
    jq = j_quantize_model(jm, params, MAIN_SPEC)
    port = params_from_numpy(jax.tree.map(np.asarray, params), t_smoke("llama3_2_1b"),
                             device="cpu")
    spec = QuantSpec.from_json_dict(MAIN_SPEC.to_json_dict())
    tq = quantize_model(build(t_smoke("llama3_2_1b")), port, spec)
    assert isinstance(port.blocks[0].attn.wq, torch.nn.Module)
    assert not isinstance(port.blocks[0].attn.wq, QLinear)  # the input is untouched
    for i, blk in enumerate(tq.blocks):
        for grp, name in (("attn", "wq"), ("attn", "wv"), ("mlp", "wi"), ("mlp", "wd")):
            mod = getattr(getattr(blk, grp), name)
            jp = jq["blocks"][grp][name]
            assert mod.qw_nbits == jp.qw.nbits and mod.cfg.w_bits == jp.cfg.w_bits
            np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(jp.qw.scale[i]))
            # W8: 256 clusters of a few dozen points each; a last-ulp boundary
            # difference moves a point to its neighbour cluster and that
            # cluster's mean by up to ~1e-3
            atol = 1e-6 if mod.qw_nbits <= 4 else 1e-3
            np.testing.assert_allclose(mod.codebook.numpy(), np.asarray(jp.qw.codebook[i]),
                                       rtol=0, atol=atol)
            np.testing.assert_array_equal(mod.act_codebook.numpy(),
                                          np.asarray(jp.act_codebook[i]))


def test_entry_points_need_a_device_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    model = build(t_smoke("llama3_2_1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_quantized("/nonexistent")
    params = model.init(0, device="cpu")
    assert next(params.parameters()).device.type == "cpu"
