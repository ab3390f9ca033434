"""Model API and post-training quantization (port of ``repro/models/model.py``).

    model  = build(cfg)
    params = model.init(seed)                         # a TransformerLM or VisionLM module
    out    = model.apply(params, {"tokens": t}, positions=..., caches=...)
    qparams = quantize_model(model, params, spec, calib)  # Dense -> QLinear modules

``params`` is the model's ``nn.Module``; ``model.apply`` calls the family's
module (``transformer`` for dense and audio, ``moe`` for moe, ``mamba`` for
ssm, ``rglru`` for hybrid, ``multimodal`` for vlm, whose batch also carries
``image_embeds``) and wraps the result in :class:`ModelOutput`, with the
MoE aux loss, or the final-norm hidden states with ``return_hidden_only``
(the trainer's chunked cross-entropy).
Quantization with calibration activations (``core.calibration.capture``)
fits each projection's activation codebook and OASIS-S thresholds on them;
without, it uses the structural Gaussian activation codebook, carried
bit-equal to the JAX one (``gaussian_codebooks.py``).
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
from repro_torch.core.outlier import static_thresholds
from repro_torch.core.quantize import QuantizedWeight, fit_activation_codebook, quantize_weight
from repro_torch.core.quantspec import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba, moe, multimodal, rglru, transformer
from repro_torch.models.gaussian_codebooks import GAUSSIAN_CENTROIDS

__all__ = ["Model", "ModelOutput", "build", "head_matrix", "quantize_model",
           "quantize_params", "unstack_for_capture", "params_from_numpy", "params_from_tree",
           "tree_from_params"]

# the paper-quantizable projections; the router, the shared experts' gate,
# the head and the embedding stay float whatever the spec says (as in JAX),
# and so do the raw MoE expert arrays, which are not projections
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "wi", "wd", "in_proj", "x_proj", "dt_proj", "out_proj",
               "lin_y", "lin_x", "lin_out", "w_a", "w_x"}
_SKIP_KEYS = {"router", "head", "embed", "shared_gate"}

# param leaf key -> the calibration tap name(s) it feeds (``dense_apply``'s
# ``tap_name`` in models/*.py); vlm's cross-attention projections tap as
# "cross.*" (``_tap_candidates``)
_TAP_OF = {
    "wq": ("attn.q",), "wk": ("attn.k",), "wv": ("attn.v",), "wo": ("attn.o",),
    "wi": ("mlp.wi",), "wd": ("mlp.wd",),
    "in_proj": ("mamba.in_proj",), "x_proj": ("mamba.x_proj",),
    "dt_proj": ("mamba.dt_proj",), "out_proj": ("mamba.out_proj",),
    "lin_y": ("rec.lin_y",), "lin_x": ("rec.lin_x",), "lin_out": ("rec.lin_out",),
    "w_a": ("rglru.wa",), "w_x": ("rglru.wx",),
}

_FAMILY_MODULES = {"dense": transformer, "audio": transformer, "moe": moe, "ssm": mamba,
                   "hybrid": rglru, "vlm": multimodal}

LanguageModel = transformer.TransformerLM | multimodal.VisionLM


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor | None  # (B, S, vocab_padded) float32 (None if hidden-only)
    caches: Any = None
    aux_loss: torch.Tensor | None = None  # moe: the layers' mean Switch loss
    hidden: torch.Tensor | None = None  # final-norm hidden states (B, S, d)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    def init(self, seed: int = 0, device=None) -> LanguageModel:
        """Seeded random parameters on ``device`` (default: the card)."""
        return self._mod.init(self.cfg, seed, resolve_device(device))

    def init_caches(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                    quantized: bool = False, layout: str = "ring", block_size: int = 16,
                    n_blocks: int = 0, device=None) -> list[dict]:
        if layout == "paged" and self.cache_policies() is None:
            raise ValueError(f"family {self.cfg.family} exports no cache policies "
                             "(no paged serving layout)")
        return self._mod.init_caches(self.cfg, batch, cache_len, dtype, quantized, layout,
                                     block_size, n_blocks, resolve_device(device))

    def cache_policies(self):
        """Per-layer cache policies for the scheduler, or None (vlm): the
        engine then serves on the fixed-slot ring."""
        return self._mod.cache_policies(self.cfg)

    def apply(self, params: LanguageModel, batch: dict, *, positions=None,
              caches=None, last_only: bool = False,
              return_hidden_only: bool = False) -> ModelOutput:
        kw = dict(positions=positions, caches=caches, last_only=last_only,
                  return_hidden_only=return_hidden_only)
        if self.cfg.family == "vlm":
            kw["image_embeds"] = batch["image_embeds"]
        out = self._mod.apply(params, self.cfg, batch["tokens"], **kw)
        if return_hidden_only:
            return ModelOutput(None, *out[1:], hidden=out[0])
        return ModelOutput(*out)


def build(cfg: ModelConfig) -> Model:
    transformer.check_ported(cfg)
    return Model(cfg)


def head_matrix(model: Model, params: LanguageModel) -> torch.Tensor:
    """(d, vocab_padded) unembedding matrix (the transposed table when tied)."""
    if model.cfg.tie_embeddings:
        return params.embed.T
    return params.head.w


def unstack_for_capture(model: Model, params: LanguageModel):
    """JAX's (model, scan-stacked params) -> (unscanned model, per-layer
    params), which its calibration taps need. The port's layers are never
    scanned, so its taps fire in every forward: an identity, kept for the
    API."""
    return model, params


def _default_codebook(nbits: int, method: str = "kmeans", device="cpu") -> torch.Tensor:
    """Structural activation codebook: float32 Gaussian quantile centroids,
    bit-equal to the JAX package's ``norm.ppf`` values."""
    if method == "uniform":
        return torch.linspace(-2.5, 2.5, 2**nbits, device=device)
    return torch.tensor(GAUSSIAN_CENTROIDS[nbits], dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# PTQ
# ---------------------------------------------------------------------------

def quantize_model(model: Model, params: LanguageModel, spec: QuantSpec,
                   calib: dict | None = None, shapes_only: bool = False) -> LanguageModel:
    """A copy of ``params`` whose projections the spec selects are ``QLinear``
    modules (float tensors are shared with ``params``, not copied).

    ``calib``: optional ``{tap_name: (tokens, K) activations}`` from
    ``core.calibration.captured``; with it each projection's activation
    codebook (and the OASIS-S static thresholds) is fit on the activations
    that feed it, else the structural Gaussian codebook is used.
    ``shapes_only``: see :func:`quantize_params`."""
    if not isinstance(params, LanguageModel) or params.cfg != model.cfg:
        raise ValueError(f"params are not a parameter tree of {model.cfg.arch_id}")
    # JAX stacks the vlm's blocks whatever scan_layers says
    return quantize_params(params, spec, calib,
                           scan_layers=model.cfg.scan_layers or model.cfg.family == "vlm",
                           shapes_only=shapes_only)


@torch.no_grad()
def quantize_params(params: nn.Module, spec: QuantSpec, calib: dict | None = None,
                    scan_layers: bool = True, shapes_only: bool = False) -> nn.Module:
    """Replace every spec-selected :class:`Dense` projection by a :class:`QLinear`.

    Paths follow the JAX parameter tree: with ``scan_layers`` the stacked
    layers share one path per projection (``blocks/attn/wq``), otherwise
    each layer has its own (``blocks/3/attn/wq``). Layers that share a path
    share its calibrated codebook and thresholds, fit once (JAX fits them
    once per layer under ``vmap``, on the same pooled activations).

    ``shapes_only``: every quantized tensor is ``torch.empty`` of the shape
    and dtype quantization gives it, nothing fit (``jax.eval_shape`` of
    quantization: under ``FakeTensorMode`` nothing is allocated, where the
    K-Means' ``bincount`` cannot run)."""
    out = copy.deepcopy(params, memo={id(t): t for t in params.parameters()})
    fitted: dict = {}

    def walk(mod: nn.Module, path: str):
        for name, child in list(mod.named_children()):
            if isinstance(mod, nn.ModuleList):
                sub = path if scan_layers else f"{path}/{name}"
            else:
                sub = f"{path}/{name}" if path else name
            if name in _SKIP_KEYS:
                continue
            if name in _QUANT_KEYS and isinstance(child, L.Dense):
                cfg = spec.resolve(sub)
                if cfg is not None:
                    q = (_quantized_shapes(child, cfg) if shapes_only
                         else _quantize_one(child, cfg, calib, sub, fitted))
                    setattr(mod, name, QLinear(q))
            else:
                walk(child, sub)

    walk(out, "")
    return out


def _quantize_one(p: L.Dense, cfg: QLinearConfig, calib: dict | None, path: str,
                  fitted: dict) -> QLinearParams:
    """Quantize one projection under its resolved config. ``fitted`` holds
    the calibrated codebooks and thresholds already fit in this call, by
    path. Without calibration activations: the structural codebook and
    static thresholds at +-3."""
    w = p.w
    qw = quantize_weight(w.float(), nbits=cfg.w_bits, method=cfg.method)
    key = (path, cfg.a_bits, cfg.scale_mode, cfg.method)
    if key not in fitted:
        fitted[key] = _codebook_for(path, cfg, calib)
    book = fitted[key].to(w.device).clone()
    thr_lo = thr_hi = None
    if cfg.detection in ("static", "static_dense"):
        key = (path, cfg.outlier_frac)
        if key not in fitted:
            acts = _calib_for(path, calib)
            fitted[key] = ((torch.tensor(-3.0), torch.tensor(3.0)) if acts is None
                           else static_thresholds(acts, cfg.outlier_frac))
        thr_lo, thr_hi = (t.to(w.device).clone() for t in fitted[key])
    return QLinearParams(qw=qw, act_codebook=book, bias=None if p.b is None else p.b.data,
                         thr_lo=thr_lo, thr_hi=thr_hi, cfg=cfg)


def _quantized_shapes(p: L.Dense, cfg: QLinearConfig) -> QLinearParams:
    """:func:`_quantize_one`'s result as empty tensors of its shapes and
    dtypes: nibble-packed (K, N / 2) or byte (K, N) uint8 indices, float32
    codebooks (2^w_bits,) and (2^a_bits,), channel scales (N,), scalar
    thresholds under static detection."""
    k, n = p.w.shape
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype,
                                                             device=p.w.device)
    if cfg.w_bits <= 4 and n % 2:
        raise ValueError("N must be even to nibble-pack along output channels")
    packed = empty(k, n // 2 if cfg.w_bits <= 4 else n, dtype=torch.uint8)
    qw = QuantizedWeight(packed=packed, codebook=empty(2**cfg.w_bits), scale=empty(n),
                         shape=(k, n), nbits=cfg.w_bits)
    static = cfg.detection in ("static", "static_dense")
    return QLinearParams(qw=qw, act_codebook=empty(2**cfg.a_bits),
                         bias=None if p.b is None else p.b.data,
                         thr_lo=empty() if static else None, thr_hi=empty() if static else None,
                         cfg=cfg)


def _tap_candidates(path: str) -> tuple[str, ...]:
    """Calibration tap names that feed the projection at ``path``."""
    leaf = path.rsplit("/", 1)[-1]
    taps = _TAP_OF.get(leaf, (leaf,))
    if "cross" in path:  # vlm cross-attention blocks tap under "cross"
        taps = tuple(t.replace("attn.", "cross.") for t in taps) + taps
    return taps


def _calib_for(path: str, calib: dict | None):
    """Captured activations for the projection at ``path``, or None. Tap
    names are projection-scoped (``attn.q``, ``mlp.wd``, ...), pooled over
    layers: exact tap-name match first, then suffix match."""
    if not calib:
        return None
    for tap in _tap_candidates(path):
        if tap in calib:
            return calib[tap]
    for tap in _tap_candidates(path):
        for name, acts in calib.items():
            if name.endswith(tap):
                return acts
    return None


def _codebook_for(path: str, cfg: QLinearConfig, calib: dict | None) -> torch.Tensor:
    acts = _calib_for(path, calib)
    if acts is not None:
        return fit_activation_codebook(acts, nbits=cfg.a_bits, scale_mode=cfg.scale_mode,
                                       method=cfg.method)
    return _default_codebook(cfg.a_bits, cfg.method)


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


def _norm(p: dict) -> tuple:
    return p["scale"], p.get("bias")


def _ffn(bp: dict) -> dict:
    """A block's FFN as ``Block`` keyword arguments: ``mlp`` or ``moe``."""
    if "moe" not in bp:
        m = bp["mlp"]
        return {"mlp": L.MLP(_proj(m["wi"]), _proj(m["wd"]))}
    m = bp["moe"]
    shared = gate = None
    if "shared" in m:
        shared = L.MLP(_proj(m["shared"]["wi"]), _proj(m["shared"]["wd"]))
        gate = _proj(m["shared_gate"])
    return {"moe": moe.MoE(_proj(m["router"]), m["wi"], m["wd"], shared, gate)}


def _mamba_block(bp: dict) -> mamba.MambaBlock:
    n, nb = _norm(bp["norm"])
    return mamba.MambaBlock(n, _proj(bp["in_proj"]), bp["conv_w"], bp["conv_b"],
                            _proj(bp["x_proj"]), _proj(bp["dt_proj"]), bp["dt_bias"],
                            bp["A_log"], bp["D"], _proj(bp["out_proj"]), nb)


def _rec_block(bp: dict) -> rglru.RecBlock:
    (n1, b1), (n2, b2) = _norm(bp["norm1"]), _norm(bp["norm2"])
    return rglru.RecBlock(n1, _proj(bp["lin_y"]), _proj(bp["lin_x"]), bp["conv_w"],
                          bp["conv_b"], _proj(bp["w_a"]), _proj(bp["w_x"]), bp["lambda"],
                          _proj(bp["lin_out"]), n2, _ffn(bp)["mlp"], b1, b2)


def _attn_block(bp: dict) -> transformer.Block:
    a = bp["attn"]
    attn = L.Attention(_proj(a["wq"]), _proj(a["wk"]), _proj(a["wv"]), _proj(a["wo"]))
    n1, b1 = _norm(bp["norm1"])
    n2, b2 = _norm(bp["norm2"]) if "norm2" in bp else (None, None)
    ffn = _ffn(bp)
    return transformer.Block(n1, attn, ffn.get("mlp"), n2, norm1_bias=b1, norm2_bias=b2,
                             moe=ffn.get("moe"))


def _cross_block(bp: dict) -> multimodal.CrossBlock:
    a = bp["attn"]
    attn = L.Attention(_proj(a["wq"]), _proj(a["wk"]), _proj(a["wv"]), _proj(a["wo"]),
                       a["gate"])
    (n1, b1), (n2, b2) = _norm(bp["norm1"]), _norm(bp["norm2"])
    return multimodal.CrossBlock(n1, attn, n2, _ffn(bp)["mlp"], bp["mlp_gate"], b1, b2)


def _vision_lm(tree: dict, cfg: ModelConfig) -> multimodal.VisionLM:
    """JAX's vlm tree: ``self_blocks`` leaves stacked (G, n_self, ...),
    ``cross_blocks`` leaves (G, ...), the gates (G,)."""
    n_groups, n_self = multimodal.groups(cfg)
    self_blocks = [_attn_block(_layer(_layer(tree["self_blocks"], g), j))
                   for g in range(n_groups) for j in range(n_self)]
    cross_blocks = [_cross_block(_layer(tree["cross_blocks"], g)) for g in range(n_groups)]
    head = _proj(tree["head"]) if "head" in tree else None
    nf, bf = _norm(tree["norm_f"])
    return multimodal.VisionLM(cfg, tree["embed"]["table"], self_blocks, cross_blocks, nf,
                               head, bf)


def params_from_tree(tree: dict, cfg: ModelConfig) -> LanguageModel:
    """Build the port's model from a JAX-layout tree of torch tensors and
    ``QLinearParams`` (``blocks`` scan-stacked with a leading layer axis, or
    a list of per-layer dicts): LayerNorm ``bias`` leaves, parallel blocks
    without ``norm2``, the moe subtree (``router``, the raw expert arrays
    ``wi`` / ``wd``, ``shared``, ``shared_gate``), Mamba blocks (``A_log``,
    ``D``, ``dt_bias``, the conv), the hybrid's RG-LRU blocks (``lambda``,
    the conv, the gates) and the vlm's two stacks (``self_blocks``,
    ``cross_blocks`` with ``attn/gate`` and ``mlp_gate``) as JAX stores
    them."""
    if cfg.family == "vlm":
        return _vision_lm(tree, cfg)
    blocks_in = tree["blocks"]
    stacked = isinstance(blocks_in, dict)
    blocks = []
    for i in range(cfg.n_layers):
        bp = _layer(blocks_in, i) if stacked else blocks_in[i]
        if cfg.family == "ssm":
            blocks.append(_mamba_block(bp))
            continue
        if "lin_y" in bp:
            blocks.append(_rec_block(bp))
            continue
        blocks.append(_attn_block(bp))
    head = _proj(tree["head"]) if "head" in tree else None
    nf, bf = _norm(tree["norm_f"])
    return transformer.TransformerLM(cfg, tree["embed"]["table"], blocks, nf, head, bf)


def _data(t: torch.Tensor) -> torch.Tensor:
    return t.data


def _proj_tree(p: nn.Module, leaf=_data):
    if isinstance(p, QLinear):
        q = p.params
        opt = lambda t: None if t is None else leaf(t)
        qw = QuantizedWeight(packed=leaf(q.qw.packed), codebook=leaf(q.qw.codebook),
                             scale=leaf(q.qw.scale), shape=q.qw.shape, nbits=q.qw.nbits)
        return QLinearParams(qw=qw, act_codebook=leaf(q.act_codebook), bias=opt(q.bias),
                             thr_lo=opt(q.thr_lo), thr_hi=opt(q.thr_hi), cfg=q.cfg)
    return {"w": leaf(p.w)} if p.b is None else {"w": leaf(p.w), "b": leaf(p.b)}


def _norm_tree(scale: nn.Parameter, bias: nn.Parameter | None, leaf=_data) -> dict:
    return {"scale": leaf(scale)} if bias is None else {"scale": leaf(scale), "bias": leaf(bias)}


def _block_tree(b: nn.Module, leaf=_data) -> dict:
    proj = lambda mod, keys: {k: _proj_tree(getattr(mod, k), leaf) for k in keys}
    if isinstance(b, mamba.MambaBlock):
        return {"norm": _norm_tree(b.norm, b.norm_bias, leaf),
                **proj(b, ("in_proj", "x_proj", "dt_proj", "out_proj")),
                **{k: leaf(getattr(b, k)) for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D")}}
    if isinstance(b, rglru.RecBlock):
        return {"norm1": _norm_tree(b.norm1, b.norm1_bias, leaf),
                "norm2": _norm_tree(b.norm2, b.norm2_bias, leaf),
                **proj(b, ("lin_y", "lin_x", "w_a", "w_x", "lin_out")),
                "conv_w": leaf(b.conv_w), "conv_b": leaf(b.conv_b), "lambda": leaf(b.lam),
                "mlp": proj(b.mlp, ("wi", "wd"))}
    out = {"norm1": _norm_tree(b.norm1, b.norm1_bias, leaf),
           "attn": proj(b.attn, ("wq", "wk", "wv", "wo"))}
    if isinstance(b, multimodal.CrossBlock):
        return {**out, "norm2": _norm_tree(b.norm2, b.norm2_bias, leaf),
                "attn": {**out["attn"], "gate": leaf(b.attn.gate)},
                "mlp": proj(b.mlp, ("wi", "wd")), "mlp_gate": leaf(b.mlp_gate)}
    if b.moe is not None:
        m = b.moe
        sub = {"router": _proj_tree(m.router, leaf), "wi": leaf(m.wi), "wd": leaf(m.wd)}
        if m.shared is not None:
            sub["shared"] = proj(m.shared, ("wi", "wd"))
            sub["shared_gate"] = _proj_tree(m.shared_gate, leaf)
        out["moe"] = sub
    else:
        out["mlp"] = proj(b.mlp, ("wi", "wd"))
    if b.norm2 is not None:
        out["norm2"] = _norm_tree(b.norm2, b.norm2_bias, leaf)
    return out


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


def tree_from_params(params: LanguageModel, leaf=_data) -> dict:
    """The inverse of :func:`params_from_tree`: the JAX-layout tree of the
    port's model, with the layers stacked when its config scans them (the
    vlm's always: self blocks (G, n_self, ...), cross blocks (G, ...)).
    ``leaf(parameter)`` gives each float leaf (default: the parameter's
    tensor; the trainer maps parameters to their AdamW moments)."""
    tree = {"embed": {"table": leaf(params.embed)}}
    if isinstance(params, multimodal.VisionLM):
        n_groups, n_self = multimodal.groups(params.cfg)
        sb = [_block_tree(b, leaf) for b in params.self_blocks]
        tree["self_blocks"] = _stack([_stack(sb[g * n_self : (g + 1) * n_self])
                                      for g in range(n_groups)])
        tree["cross_blocks"] = _stack([_block_tree(b, leaf) for b in params.cross_blocks])
    else:
        blocks = [_block_tree(b, leaf) for b in params.blocks]
        tree["blocks"] = _stack(blocks) if params.cfg.scan_layers else blocks
    tree["norm_f"] = _norm_tree(params.norm_f, params.norm_f_bias, leaf)
    if params.head is not None:
        tree["head"] = _proj_tree(params.head, leaf)
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> LanguageModel:
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
