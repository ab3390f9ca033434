"""Mixture-of-Experts decoder LM (port of ``repro/models/moe.py``:
granite-moe, qwen2-moe).

Token-choice top-k routing with JAX's sort-based, group-local dispatch:
the step's tokens split into ``g`` contiguous groups, each sorted by expert
into per-group capacity slots (``moe_capacity``); an assignment past its
expert's capacity is clamped into the expert's last slot with a zeroed
value. The expert products are plain batched matmuls over float expert
weights (``wi`` (E, d, mult * d_ff), ``wd`` (E, d_ff, d)), as JAX computes
them outside any Pallas kernel; PTQ leaves them in float, as JAX does.
Qwen2's shared experts are one wide MLP under a sigmoid gate (probe sites
``shared_mlp.wi`` / ``shared_mlp.wd``). The Switch load-balancing loss is
returned as the model's ``aux_loss``.

Everything here is deterministic on the card and reads nothing on the host,
so the packed serving step stays one CUDA graph: the router's top-k is a
stable sort (ties to the lowest expert, ``lax.top_k``'s order), and each
token sums its k expert outputs in ascending expert order, the order in
which JAX's scatter-add applies them, not in atomic order. Padded rows of
a packed step are routed and take capacity exactly as in JAX.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import active_rules
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.telemetry import region

__all__ = ["MoE", "moe_capacity", "dispatch_groups", "route", "moe_apply", "init", "apply",
           "init_caches", "cache_policies"]

init_caches = transformer.init_caches
cache_policies = transformer.cache_policies  # the same attention stack


class MoE(nn.Module):
    """One block's FFN: the float32 ``router`` (a Dense d -> E), the raw
    expert arrays ``wi`` / ``wd``, and optionally the ``shared`` MLP with
    its ``shared_gate`` (a Dense d -> 1)."""

    def __init__(self, router: L.Dense, wi: torch.Tensor, wd: torch.Tensor,
                 shared: L.MLP | None = None, shared_gate: nn.Module | None = None):
        super().__init__()
        self.router = router
        self.wi = nn.Parameter(wi, requires_grad=False)
        self.wd = nn.Parameter(wd, requires_grad=False)
        self.shared, self.shared_gate = shared, shared_gate

    def forward(self, x: torch.Tensor, cfg: ModelConfig):
        """-> (out, Switch aux loss): :func:`moe_apply`."""
        return moe_apply(self, x, cfg)


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity of one dispatch group, rounded up to 8 (at least 8)."""
    c = n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts
    return max(8, int(math.ceil(c / 8.0)) * 8)


def dispatch_groups(t: int, cfg: ModelConfig) -> int:
    """``min(moe_dispatch_groups, t)``, lowered until it divides t (JAX's
    rule: the capacity depends on it)."""
    g = max(1, min(cfg.moe_dispatch_groups, t))
    while t % g:
        g -= 1
    return g


def route(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """x (..., d) -> (gates (..., E) float32 softmax, top-k weights (..., k)
    renormalized, top-k experts (..., k) int64). Ties go to the lowest
    expert index, as ``lax.top_k`` breaks them: a stable descending sort."""
    gates = torch.softmax(x.float() @ router_w.float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., :k], idx[..., :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return gates, topw, topi


def _dispatch(xg, topi, topw, e: int, cap: int):
    """Sort-based dispatch for every group at once. xg (G, Tg, d); topi /
    topw (G, Tg, k). Returns expert_in (G, E, cap, d) and, per assignment in
    each group's sorted (expert-major, stable) order: slot (G, F), token
    (G, F), keep (G, F), weight (G, F), and the sort's permutation (G, F)."""
    g, tg, k = topi.shape
    f = tg * k
    e_flat = topi.reshape(g, f)
    w_flat = topw.reshape(g, f)
    se, order = torch.sort(e_flat, dim=-1, stable=True)
    st = torch.div(order, k, rounding_mode="floor")
    sw = torch.gather(w_flat, 1, order)
    experts = torch.arange(e, device=xg.device)
    start = torch.searchsorted(se, experts.expand(g, e).contiguous())  # first of each expert
    pos_in_e = torch.arange(f, device=xg.device) - torch.gather(start, 1, se)
    keep = pos_in_e < cap
    # overflow: into the expert's last slot with a zeroed value (adding exact
    # zeros gives the same sum in any order)
    slot = torch.where(keep, se * cap + pos_in_e, se * cap + cap - 1)
    d = xg.shape[-1]
    values = torch.gather(xg, 1, st[..., None].expand(g, f, d)) * keep[..., None].to(xg.dtype)
    flat_slot = (slot + torch.arange(g, device=xg.device)[:, None] * (e * cap)).reshape(-1)
    expert_in = torch.zeros((g * e * cap, d), dtype=xg.dtype, device=xg.device)
    expert_in.index_add_(0, flat_slot, values.reshape(-1, d))
    return expert_in.reshape(g, e, cap, d), slot, st, keep, sw, order


def _combine(eo, slot, keep, sw, order, topi, dtype):
    """eo (G, E * cap, d) -> (G, Tg, d): each token's k weighted expert
    outputs summed into zeros in ascending expert order (JAX's scatter-add
    order), one add at a time, so the bits do not depend on the device."""
    g, tg, k = topi.shape
    d = eo.shape[-1]
    gathered = torch.gather(eo, 1, torch.where(keep, slot, 0)[..., None].expand(-1, -1, d))
    gathered = gathered * (sw * keep).to(dtype)[..., None]
    # sorted order -> token-major (token, choice), then each token's choices
    # by ascending expert
    inv = torch.argsort(order, dim=-1)
    per_tok = torch.gather(gathered, 1, inv[..., None].expand(-1, -1, d)).reshape(g, tg, k, d)
    by_expert = torch.argsort(topi, dim=-1)
    per_tok = torch.gather(per_tok, 2, by_expert[..., None].expand(-1, -1, -1, d))
    out = torch.zeros((g, tg, d), dtype=dtype, device=eo.device)
    for j in range(k):
        out = out + per_tok[:, :, j]
    return out


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), Switch aux loss () float32)."""
    if isinstance(x, DTensor):
        out, counts, gate_sums = _routed_group_local(x, p.router.w, p.wi, p.wd, cfg)
    else:
        out, counts, gate_sums = _routed(x, p.router.w, p.wi, p.wd, cfg,
                                         dispatch_groups(x.shape[0] * x.shape[1], cfg))
    # Switch load balancing: E * <fraction of assignments to e> . <mean gate of e> / k
    t = x.shape[0] * x.shape[1]
    aux = cfg.n_experts * torch.sum(counts / t * gate_sums / t) / cfg.experts_per_token
    if p.shared is not None:
        sg = torch.sigmoid(L.dense_apply(p.shared_gate, x).float())
        out = out + sg.to(x.dtype) * L.mlp_apply(p.shared, x, cfg.act_fn, "shared_mlp")
    return out, aux


def _routed_group_local(x, router_w, wi, wd, cfg: ModelConfig):
    """:func:`_routed` on DTensors, group-local as JAX's GSPMD shards it:
    each rank routes, dispatches and combines its own dispatch groups, its
    rows of x sharded on the ``"dispatch_groups"`` rule's mesh axes (the
    batch's) and gathered on the others, the router and expert weights
    gathered whole, as JAX gathers them at use. Their gradients come back
    as partial sums over those axes, and so do the aux loss's expert counts
    and gate sums. Where the groups do not split evenly over those axes,
    every rank runs all of them. DTensor has no sharding rules for the
    dispatch's index ops (``searchsorted``, ``index_add_``, gathers at
    computed indices): this is one local site."""
    mesh = x.device_mesh
    axes = (active_rules() or {}).get("dispatch_groups")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    dims = [i for i, n in enumerate(mesh.mesh_dim_names) if n in axes and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in dims)
    g = dispatch_groups(x.shape[0] * x.shape[1], cfg)
    if g % n or x.shape[0] % n:
        dims, n = [], 1
    rows = [Shard(0) if i in dims else Replicate() for i in range(mesh.ndim)]
    partial = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
    whole = [Replicate()] * mesh.ndim
    weights = [w.redistribute(mesh, whole).to_local(grad_placements=partial)
               for w in (router_w, wi, wd)]
    out, counts, gate_sums = _routed(x.redistribute(mesh, rows).to_local(), *weights, cfg,
                                     g // n)
    out = DTensor.from_local(out, mesh, rows, run_check=False, shape=x.shape,
                             stride=x.stride())
    counts, gate_sums = (DTensor.from_local(t, mesh, partial, run_check=False)
                         .redistribute(mesh, whole) for t in (counts, gate_sums))
    return out, counts, gate_sums


def _routed(x, router_w, wi, wd, cfg: ModelConfig, g: int):
    """Routing, dispatch, the expert products and the combine of x's tokens
    in ``g`` contiguous dispatch groups: (out, each expert's assignment
    count (E,), each expert's summed gate (E,)). Regions
    (``serving.telemetry.region``): ``moe.route`` (the router and the
    assignment counts), ``moe.dispatch``, ``moe.experts`` (both products and
    the activation), ``moe.combine``."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.n_experts
    tg = t // g
    cap = moe_capacity(tg, cfg)
    xg = x.reshape(g, tg, d)
    region("moe.route")
    gates, topw, topi = route(xg, router_w, k)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, topi.reshape(-1), torch.ones((topi.numel(),), device=x.device))

    region("moe.dispatch")
    expert_in, slot, _st, keep, sw, order = _dispatch(xg, topi, topw, e, cap)
    # expert products: (E, G * cap, d) @ (E, d, mult * f), then down
    region("moe.experts")
    h = torch.bmm(expert_in.transpose(0, 1).reshape(e, g * cap, d), wi.to(x.dtype))
    h = L.act_apply(h, cfg.act_fn)
    eo = torch.bmm(h, wd.to(x.dtype)).reshape(e, g, cap, d).transpose(0, 1)
    region("moe.combine")
    out = _combine(eo.reshape(g, e * cap, d), slot, keep, sw, order, topi, x.dtype)
    region("other")
    return out.reshape(b, s, d), counts, gates.sum(dim=(0, 1))


def _ffn_init(cfg: ModelConfig, device):
    """One block's MoE FFN at JAX's scales (float32 router)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    mult = 2 if cfg.act_fn in L.GATED_ACTS else 1

    def make(gen: torch.Generator, dtype) -> MoE:
        router = L.dense_init(gen, d, e, torch.float32, device)
        wi = (torch.randn((e, d, mult * f), generator=gen, device=device)
              / math.sqrt(d)).to(dtype)
        wd = (torch.randn((e, f, d), generator=gen, device=device) / math.sqrt(f)).to(dtype)
        shared = gate = None
        if cfg.n_shared_experts:
            shared = L.mlp_init(gen, d, cfg.n_shared_experts * cfg.shared_expert_d_ff,
                                cfg.act_fn, dtype, device)
            gate = L.dense_init(gen, d, 1, dtype, device)
        return MoE(router, wi, wd, shared, gate)

    return make


def init(cfg: ModelConfig, seed: int, device) -> TransformerLM:
    """Seeded random init: the transformer stack with a MoE FFN per block."""
    return transformer.init(cfg, seed, device, ffn=_ffn_init(cfg, device))


def apply(params: TransformerLM, cfg: ModelConfig, tokens, *, positions=None, caches=None,
          last_only: bool = False, return_hidden_only: bool = False):
    """-> (logits, or the hidden states with ``return_hidden_only``, caches,
    aux loss: the layers' mean)."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    out, caches, aux = params(tokens, positions=positions, caches=caches, last_only=last_only,
                              hidden_only=return_hidden_only)
    return out, caches, aux / cfg.n_layers
