"""Model API and post-training quantization (port of ``repro/models/model.py``).

    model  = build(cfg)
    params = model.init(seed)                         # a TransformerLM module
    out    = model.apply(params, {"tokens": t}, positions=..., caches=...)
    qparams = quantize_model(model, params, spec)     # Dense -> QLinear modules

``params`` is the model's ``nn.Module``; ``model.apply`` calls it and wraps
the result in :class:`ModelOutput`. Quantization without calibration data
uses the structural Gaussian activation codebook, carried bit-equal to the
JAX one (``gaussian_codebooks.py``). Calibration is not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import QLinear, QLinearConfig, QLinearParams
from repro_torch.core.quantize import QuantizedWeight, quantize_weight
from repro_torch.core.quantspec import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.gaussian_codebooks import GAUSSIAN_CENTROIDS

__all__ = ["Model", "ModelOutput", "build", "head_matrix", "quantize_model",
           "quantize_params", "params_from_numpy", "params_from_tree", "tree_from_params"]

_QUANT_KEYS = {"wq", "wk", "wv", "wo", "wi", "wd"}


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor  # (B, S, vocab_padded) float32
    caches: Any = None


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None) -> transformer.TransformerLM:
        """Seeded random parameters on ``device`` (default: the card)."""
        return transformer.init(self.cfg, seed, resolve_device(device))

    def init_caches(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                    quantized: bool = False, block_size: int = 16, n_blocks: int = 0,
                    device=None) -> list[dict]:
        return transformer.init_caches(self.cfg, batch, cache_len, dtype, quantized,
                                       block_size, n_blocks, resolve_device(device))

    def cache_policies(self):
        return transformer.cache_policies(self.cfg)

    def apply(self, params: transformer.TransformerLM, batch: dict, *, positions=None,
              caches=None, last_only: bool = False) -> ModelOutput:
        logits, caches = transformer.apply(params, self.cfg, batch["tokens"],
                                           positions=positions, caches=caches,
                                           last_only=last_only)
        return ModelOutput(logits, caches)


def build(cfg: ModelConfig) -> Model:
    transformer.check_ported(cfg)
    return Model(cfg)


def head_matrix(model: Model, params: transformer.TransformerLM) -> torch.Tensor:
    """(d, vocab_padded) unembedding matrix (the transposed table when tied)."""
    if model.cfg.tie_embeddings:
        return params.embed.T
    return params.head.w


def _default_codebook(nbits: int, method: str = "kmeans", device="cpu") -> torch.Tensor:
    """Structural activation codebook: float32 Gaussian quantile centroids,
    bit-equal to the JAX package's ``norm.ppf`` values."""
    if method == "uniform":
        return torch.linspace(-2.5, 2.5, 2**nbits, device=device)
    return torch.tensor(GAUSSIAN_CENTROIDS[nbits], dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# PTQ
# ---------------------------------------------------------------------------

def quantize_model(model: Model, params: transformer.TransformerLM, spec: QuantSpec,
                   calib: dict | None = None) -> transformer.TransformerLM:
    """A copy of ``params`` whose projections the spec selects are ``QLinear``
    modules (float tensors are shared with ``params``, not copied)."""
    if calib is not None:
        raise NotImplementedError("calibrated PTQ is not ported yet")
    if not isinstance(params, transformer.TransformerLM) or params.cfg != model.cfg:
        raise ValueError(f"params are not a parameter tree of {model.cfg.arch_id}")
    return quantize_params(params, spec, scan_layers=model.cfg.scan_layers)


def quantize_params(params: nn.Module, spec: QuantSpec, scan_layers: bool = True) -> nn.Module:
    """Replace every spec-selected :class:`Dense` projection by a :class:`QLinear`.

    Paths follow the JAX parameter tree: with ``scan_layers`` the stacked
    layers share one path per projection (``blocks/attn/wq``), otherwise
    each layer has its own (``blocks/3/attn/wq``)."""
    out = copy.deepcopy(params, memo={id(t): t for t in params.parameters()})

    def walk(mod: nn.Module, path: str):
        for name, child in list(mod.named_children()):
            if isinstance(mod, nn.ModuleList):
                sub = path if scan_layers else f"{path}/{name}"
            else:
                sub = f"{path}/{name}" if path else name
            if name in _QUANT_KEYS and isinstance(child, L.Dense):
                cfg = spec.resolve(sub)
                if cfg is not None:
                    setattr(mod, name, QLinear(_quantize_one(child, cfg)))
            else:
                walk(child, sub)

    walk(out, "")
    return out


def _quantize_one(p: L.Dense, cfg: QLinearConfig) -> QLinearParams:
    """Quantize one projection under its resolved config (no calibration:
    structural codebook, static thresholds at +-3)."""
    w = p.w
    qw = quantize_weight(w.float(), nbits=cfg.w_bits, method=cfg.method)
    book = _default_codebook(cfg.a_bits, cfg.method, device=w.device)
    thr_lo = thr_hi = None
    if cfg.detection in ("static", "static_dense"):
        thr_lo = torch.tensor(-3.0, device=w.device)
        thr_hi = torch.tensor(3.0, device=w.device)
    return QLinearParams(qw=qw, act_codebook=book, bias=None if p.b is None else p.b.data,
                         thr_lo=thr_lo, thr_hi=thr_hi, cfg=cfg)


# ---------------------------------------------------------------------------
# parameter trees from the JAX package
# ---------------------------------------------------------------------------

def _layer(leaf, i: int):
    """Layer ``i`` of a scan-stacked subtree (leading layer axis)."""
    if isinstance(leaf, QLinearParams):
        qw = leaf.qw
        pick = lambda t: None if t is None else t[i]
        return QLinearParams(
            qw=QuantizedWeight(packed=qw.packed[i], codebook=qw.codebook[i],
                               scale=qw.scale[i], shape=qw.shape, nbits=qw.nbits),
            act_codebook=leaf.act_codebook[i], bias=pick(leaf.bias),
            thr_lo=pick(leaf.thr_lo), thr_hi=pick(leaf.thr_hi), cfg=leaf.cfg)
    if isinstance(leaf, dict):
        return {k: _layer(v, i) for k, v in leaf.items()}
    return leaf[i]


def _proj(p) -> nn.Module:
    if isinstance(p, QLinearParams):
        return QLinear(p)
    return L.Dense(p["w"], p.get("b"))


def params_from_tree(tree: dict, cfg: ModelConfig) -> transformer.TransformerLM:
    """Build the port's model from a JAX-layout tree of torch tensors and
    ``QLinearParams`` (``blocks`` scan-stacked with a leading layer axis, or
    a list of per-layer dicts)."""
    blocks_in = tree["blocks"]
    stacked = isinstance(blocks_in, dict)
    blocks = []
    for i in range(cfg.n_layers):
        bp = _layer(blocks_in, i) if stacked else blocks_in[i]
        a, m = bp["attn"], bp["mlp"]
        attn = L.Attention(_proj(a["wq"]), _proj(a["wk"]), _proj(a["wv"]), _proj(a["wo"]))
        mlp = L.MLP(_proj(m["wi"]), _proj(m["wd"]))
        blocks.append(transformer.Block(bp["norm1"]["scale"], attn, mlp,
                                        bp["norm2"]["scale"]))
    head = _proj(tree["head"]) if "head" in tree else None
    return transformer.TransformerLM(cfg, tree["embed"]["table"], blocks,
                                     tree["norm_f"]["scale"], head)


def _proj_tree(p: nn.Module):
    if isinstance(p, QLinear):
        return p.params
    return {"w": p.w.data} if p.b is None else {"w": p.w.data, "b": p.b.data}


def _stack(trees: list):
    """Per-layer trees -> one tree with a leading layer axis (JAX's scan layout)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, QLinearParams):
        opt = lambda f: None if getattr(first, f) is None else torch.stack(
            [getattr(t, f) for t in trees])
        qw = QuantizedWeight(packed=torch.stack([t.qw.packed for t in trees]),
                             codebook=torch.stack([t.qw.codebook for t in trees]),
                             scale=torch.stack([t.qw.scale for t in trees]),
                             shape=first.qw.shape, nbits=first.qw.nbits)
        return QLinearParams(qw=qw, act_codebook=torch.stack([t.act_codebook for t in trees]),
                             bias=opt("bias"), thr_lo=opt("thr_lo"), thr_hi=opt("thr_hi"),
                             cfg=first.cfg)
    return torch.stack(trees)


def tree_from_params(params: transformer.TransformerLM) -> dict:
    """The inverse of :func:`params_from_tree`: the JAX-layout tree of the
    port's model, with the layers stacked when its config scans them."""
    blocks = [{"attn": {k: _proj_tree(getattr(b.attn, k)) for k in ("wq", "wk", "wv", "wo")},
               "mlp": {k: _proj_tree(getattr(b.mlp, k)) for k in ("wi", "wd")},
               "norm1": {"scale": b.norm1.data}, "norm2": {"scale": b.norm2.data}}
              for b in params.blocks]
    tree = {"embed": {"table": params.embed.data},
            "blocks": _stack(blocks) if params.cfg.scan_layers else blocks,
            "norm_f": {"scale": params.norm_f.data}}
    if params.head is not None:
        tree["head"] = _proj_tree(params.head)
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> transformer.TransformerLM:
    """A float JAX parameter tree given as numpy arrays -> the port's model."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":  # no numpy bfloat16 in torch: go through bits
            return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(x.copy()).to(dev)

    return params_from_tree(conv(tree), cfg)
