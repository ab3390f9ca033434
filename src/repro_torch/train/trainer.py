"""Training substrate (port of ``repro/train/trainer.py``).

``make_train_step(model, tc)`` builds the step:

  * next-token cross-entropy from the final-norm hidden states in token
    chunks (float32 logits, z-loss), plus the MoE aux loss;
  * gradient accumulation over ``tc.microbatches`` (float32 sums);
  * with ``tc.grad_compression``, blockwise int8 compression of the
    gradients with error feedback (``distributed.collectives``);
  * AdamW with clipping and the cosine schedule at ``step + 1``.

The state is ``{"params": the model's module, "opt": {"m", "v", "step"}}``,
plus ``"compress_err"`` with compression, moments and errors keyed by the
module's parameter names. Parameters are built with ``requires_grad=False``
(serving never differentiates); a train step switches gradients on for the
float parameters it updates and off again when it returns. Weight decay
follows JAX's rule on the rank of the leaf in JAX's tree
(:func:`decay_mask`).

``Trainer`` adds the operational shell: the data pipeline, auto-resume from
the latest committed checkpoint (params, moments, error state, step,
pipeline state, in JAX's tree layout), a checkpoint every
``checkpoint_every`` steps and at the end of a run, and the straggler
monitor over step times, each step timed to the card's completion as JAX's
``block_until_ready`` times it.

The same step runs sharded: :func:`shard_train_state` makes the parameters,
moments and error state DTensors with the placements of
``distributed.param_sharding``, :func:`shard_batch` shards the tokens on the
data axes, and the step runs under ``distributed.sharding.use_rules(rules,
mesh)``. Gradients come back in their parameters' placements.
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import compress_decompress_tree, init_error_state
from repro_torch.distributed.fault_tolerance import StepMonitor
from repro_torch.distributed.param_sharding import (build_param_specs, distribute_params,
                                                    leaf_parameters, param_shapes,
                                                    parameter_specs)
from repro_torch.distributed.sharding import (P, distribute_replicated, gather_dim,
                                              placements_for)
from repro_torch.models.model import Model, head_matrix, params_from_tree, tree_from_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = ["TrainConfig", "make_train_step", "make_eval_step", "loss_fn", "init_train_state",
           "decay_mask", "train_state_tree", "shard_train_state", "shard_batch", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    z_loss: float = 1e-4
    aux_weight: float = 0.01  # MoE load-balance loss weight
    warmup_steps: int = 100
    total_steps: int = 10_000
    checkpoint_every: int = 500
    grad_compression: bool = False


_CE_CHUNK = 4096  # tokens per CE chunk (the memory knob)


def _ce_chunk(hc, yc, vc, head_w):
    # DTensor's gather over vocab-sharded logits has no working rule (its
    # masked partial indexes a 1-D target as 2-D): gather the vocab first
    logits = gather_dim(hc.float() @ head_w.float(), -1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yc.long()[:, None])[:, 0]
    return torch.sum((lse - ll) * vc), torch.sum(torch.square(lse) * vc)


def _chunked_ce(hidden, head_w, labels, z_loss: float):
    """Cross-entropy from hidden states in token chunks, never holding the
    whole (tokens, vocab) logits: each chunk's logits are recomputed in the
    backward pass (``torch.utils.checkpoint``), JAX's ``jax.checkpoint``
    scan body. The last chunk is padded and its padding masked.
    Returns (ce, ce + z_loss * mean(lse^2)).

    On DTensors (a sharded step) the chunks are each rank's: its own rows
    of the batch (the other shards of hidden gathered), cut into chunks of
    ``_CE_CHUNK`` tokens of the whole step's, so each rank's share of a
    chunk is JAX's; each chunk is one DTensor over those rows. A slice of
    a DTensor's sharded token dim would be gathered whole on every rank."""
    d = hidden.shape[-1]
    t = hidden.shape[0] * hidden.shape[1]
    wrap = lambda x: x
    h, y, chunk = hidden.reshape(-1, d), labels.reshape(-1), min(_CE_CHUNK, t)
    if isinstance(hidden, DTensor):
        mesh = hidden.device_mesh
        rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                for pl in hidden.placements]
        n = math.prod(mesh.size(i) for i, pl in enumerate(rows) if isinstance(pl, Shard))
        h = hidden.redistribute(mesh, rows).to_local().reshape(-1, d)
        y = labels.redistribute(mesh, rows).to_local().reshape(-1)
        chunk = max(1, chunk // n)
        wrap = lambda x: DTensor.from_local(x, mesh, rows, run_check=False)
        # the head whole but for its vocab shards, gathered once for all
        # chunks (FSDP shards its d_model dim: contracting a sharded d would
        # leave each chunk's logits partial sums over the batch axes)
        head_w = gather_dim(head_w, 0)
    pad = (-h.shape[0]) % chunk
    valid = torch.nn.functional.pad(
        torch.ones((h.shape[0],), dtype=torch.float32, device=h.device), (0, pad))
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], chunk):
        args = (*(wrap(x[i : i + chunk]) for x in (h, y, valid)), head_w)
        if torch.is_grad_enabled():
            # the recompute runs in the forward's context (the sharding
            # rules), also on the thread that runs the backward
            c, z = checkpoint(contextvars.copy_context().run, _ce_chunk, *args,
                              use_reentrant=False)
        else:
            c, z = _ce_chunk(*args)
        ce_sum, z_sum = ce_sum + c, z_sum + z
    ce = ce_sum / t
    return ce, ce + z_loss * (z_sum / t)


def loss_fn(model: Model, params, batch: dict, tc: TrainConfig):
    """batch["tokens"]: (B, S + 1) on the params' device. Returns (loss, metrics)."""
    tokens = batch["tokens"]
    inp = {**batch, "tokens": tokens[:, :-1]}
    labels = tokens[:, 1:]
    out = model.apply(params, inp, return_hidden_only=True)
    ce, loss = _chunked_ce(out.hidden, head_matrix(model, params), labels, tc.z_loss)
    if out.aux_loss is not None:
        loss = loss + tc.aux_weight * out.aux_loss
    return loss, {"ce": ce, "aux": out.aux_loss if out.aux_loss is not None else 0.0}


def decay_mask(params) -> dict[str, bool]:
    """{parameter name: decayed}: JAX decays a leaf of rank >= 2 in its tree,
    where a scanned config stacks each per-layer tensor on a layer axis (so
    its norms, biases, ``D`` and ``dt_bias`` decay, and the final norm does
    not). The vlm's tree always stacks: self blocks on two axes (groups,
    blocks), cross blocks on one, so their gates (G,) do not decay and their
    norms (G, d) do."""
    lead = {"self_blocks.": 2, "cross_blocks.": 1}
    if params.cfg.scan_layers:
        lead["blocks."] = 1
    return {n: p.ndim + next((a for k, a in lead.items() if n.startswith(k)), 0) >= 2
            for n, p in params.named_parameters()}


def make_train_step(model: Model, tc: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), updating the
    state in place. ``batch["tokens"]`` (B, S + 1) lies on the params'
    device, B divisible by ``tc.microbatches``."""
    lr_fn = cosine_schedule(tc.optimizer.lr, tc.warmup_steps, tc.total_steps)
    leaves = None  # JAX's leaves of the parameters, for the compression's blocks

    def grads_of(named: dict, params, batch):
        loss, _ = loss_fn(model, params, batch, tc)
        return loss, torch.autograd.grad(loss, list(named.values()))

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                n = tc.microbatches
                if n > 1:
                    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in named.values()]
                    lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                    for i in range(n):
                        mb = {k: _microbatch(v, n, i) for k, v in batch.items()}
                        l, g = grads_of(named, params, mb)
                        gsum = [a + b for a, b in zip(gsum, g)]
                        lsum = lsum + l.detach()
                    grads = [g / n for g in gsum]
                    loss = lsum / n
                else:
                    loss, grads = grads_of(named, params, batch)
                    loss = loss.detach()
        finally:
            for p in named.values():
                p.requires_grad_(False)
        grads = {k: _placed_as(g, p) for (k, p), g in zip(named.items(), grads)}
        if tc.grad_compression and "compress_err" in state:
            nonlocal leaves
            leaves = leaves or [n for _, n in leaf_parameters(params).values()]
            grads, state["compress_err"] = _compress(grads, state["compress_err"], leaves, named)
        lr = lr_fn(state["opt"]["step"] + 1)  # +1: step 0 would warm up to lr = 0
        _, _, om = adamw_update(grads, state["opt"], named, tc.optimizer, lr,
                                decay=decay_mask(params))
        return state, {"loss": loss, "lr": lr, **om}

    return train_step


def make_eval_step(model: Model, tc: TrainConfig) -> Callable:
    @torch.inference_mode()
    def eval_step(params, batch):
        loss, metrics = loss_fn(model, params, batch, tc)
        return {"loss": loss, **metrics}

    return eval_step


def _microbatch(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n``: rows ``[i * B / n, (i + 1) * B / n)``, JAX's
    ``reshape(n, B / n, ...)[i]``. A DTensor batch (sharded on the batch
    axes) is gathered whole first, then the microbatch's rows are sharded as
    the batch was: a contiguous block of rows lies on few ranks, and
    DTensor cannot split a sharded dim that the mesh does not divide."""
    m = v.shape[0] // n
    if not isinstance(v, DTensor):
        return v[i * m : (i + 1) * m]
    whole = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim).to_local()
    return distribute_replicated(whole[i * m : (i + 1) * m], v.device_mesh, v.placements)


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A sharded parameter's gradient in the parameter's placements (a
    partial sum over the data axes is reduced), as JAX's step returns its
    gradients in the parameters' shardings."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _gathered(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) in ``like``'s
    placements: a local slice, no communication."""
    if not isinstance(like, DTensor):
        return t
    return distribute_replicated(t, like.device_mesh, like.placements)


def _compress(grads: dict, err: dict, leaves: list[list[str]], named: dict):
    """``compress_decompress_tree`` over JAX's leaves, whose blocks of 256
    run over the whole flattened leaf: the layers of a stacked leaf are
    concatenated in stack order (the row-major flattening of the stack) and
    a sharded gradient is gathered, so the blocks are JAX's and the
    single-process ones. Returns (gradients, error state) by parameter name,
    each in its parameter's placements."""
    cat = lambda d, names: torch.cat([_gathered(d[n]).reshape(-1) for n in names])
    sent, new_err = compress_decompress_tree({i: cat(grads, ns) for i, ns in enumerate(leaves)},
                                             {i: cat(err, ns) for i, ns in enumerate(leaves)})
    out_g, out_e = {}, {}
    for i, names in enumerate(leaves):
        sizes = [named[n].numel() for n in names]
        for n, g, e in zip(names, sent[i].split(sizes), new_err[i].split(sizes)):
            out_g[n] = _placed_like(g.reshape(named[n].shape), named[n])
            out_e[n] = _placed_like(e.reshape(named[n].shape), err[n])
    return out_g, out_e


def init_train_state(model: Model, seed: int, tc: TrainConfig, device=None) -> dict:
    params = model.init(seed, device=device)
    named = dict(params.named_parameters())
    state = {"params": params, "opt": adamw_init(named)}
    if tc.grad_compression:
        state["compress_err"] = init_error_state(named)
    return state


def train_state_tree(state: dict) -> dict:
    """The train state in JAX's tree layout (stacked layers where the config
    scans them): ``params``, ``opt`` (``m``, ``v``, ``step``) and, with
    compression, ``compress_err``. Sharded leaves stay DTensors; the
    checkpointer gathers them."""
    params, opt = state["params"], state["opt"]
    names = {id(p): n for n, p in params.named_parameters()}
    by_name = lambda d: lambda p: d[names[id(p)]]
    tree = {"params": tree_from_params(params),
            "opt": {"m": tree_from_params(params, by_name(opt["m"])),
                    "v": tree_from_params(params, by_name(opt["v"])),
                    "step": np.asarray(opt["step"], np.int32)}}
    if "compress_err" in state:
        tree["compress_err"] = tree_from_params(params, by_name(state["compress_err"]))
    return tree


def shard_train_state(state: dict, mesh, model_size: int, fsdp_axes=None) -> dict:
    """Distribute the train state on ``mesh``, in place: the parameters, the
    moments and the error state by ``build_param_specs`` (TP over "model",
    with ``fsdp_axes`` also ZeRO-3 over those axes); ``step`` stays a host
    integer. Every rank must hold the same state (the seeded init): each
    keeps its own slices. Returns ``state``."""
    params = state["params"]
    shards = 1
    if fsdp_axes is not None:
        axes = (fsdp_axes,) if isinstance(fsdp_axes, str) else fsdp_axes
        shards = math.prod(mesh[a].size() for a in axes)
    specs = build_param_specs(param_shapes(params), model_size, fsdp_axes, shards)
    placements = {k: placements_for(s, mesh) for k, s in parameter_specs(params, specs).items()}
    distribute_params(params, specs, mesh)
    place = lambda d: {k: distribute_replicated(t, mesh, placements[k]) for k, t in d.items()}
    state["opt"] = {**state["opt"], "m": place(state["opt"]["m"]), "v": place(state["opt"]["v"])}
    if "compress_err" in state:
        state["compress_err"] = place(state["compress_err"])
    return state


def shard_batch(batch: dict, mesh, batch_axes) -> dict:
    """Each batch tensor (the whole batch, the same on every rank) as a
    DTensor sharded on its leading (batch) dim over ``batch_axes`` (None:
    replicated)."""
    return {k: distribute_replicated(v, mesh, placements_for(
                P(batch_axes, *[None] * (v.ndim - 1)), mesh))
            for k, v in batch.items()}


class Trainer:
    """Operational training shell with fault tolerance.

    - auto-resume: restores (params, moments, error state, pipeline state,
      step) from the latest committed checkpoint in ``ckpt_dir``;
    - a checkpoint every ``tc.checkpoint_every`` steps and one when a run ends;
    - straggler monitor: flags steps slower than ``straggler_factor`` x the
      running median.
    """

    def __init__(self, model: Model, tc: TrainConfig, pipeline, ckpt_dir: str | None = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model, self.tc, self.pipeline = model, tc, pipeline
        self.train_step = make_train_step(model, tc)
        self.state = init_train_state(model, seed, tc, device=self.device)
        self.step = 0
        self.monitor = StepMonitor()
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(self.checkpoint_tree())
            if restored is not None:
                self._load(restored)

    def checkpoint_tree(self) -> dict:
        """The checkpointed state in JAX's tree layout (stacked layers where
        the config scans them), the error state included."""
        return {"state": train_state_tree(self.state), "data": self.pipeline.state(),
                "step": self.step}

    def _load(self, restored: dict) -> None:
        cfg = self.model.cfg
        st = restored["state"]
        with torch.no_grad():
            for n, t in params_from_tree(st["params"], cfg).named_parameters():
                self.state["params"].get_parameter(n).copy_(t)
            moments = [(self.state["opt"][k], st["opt"][k]) for k in ("m", "v")]
            if "compress_err" in self.state:
                moments.append((self.state["compress_err"], st["compress_err"]))
            for dest, tree in moments:
                for n, t in params_from_tree(tree, cfg).named_parameters():
                    dest[n].copy_(t)
        self.state["opt"]["step"] = int(st["opt"]["step"])
        self.pipeline.restore({k: int(v) for k, v in restored["data"].items()})
        self.step = int(restored["step"])

    def run(self, num_steps: int, log_every: int = 10, log: Callable[[str], Any] = print):
        target = self.step + num_steps
        while self.step < target:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipeline.next_batch().items()}
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.monitor.record(dt)
            self.step += 1
            if self.step % log_every == 0:
                log(f"step {self.step} loss {float(metrics['loss']):.4f} "
                    f"lr {float(metrics['lr']):.2e} dt {dt*1e3:.0f}ms"
                    + (" [STRAGGLER]" if self.monitor.is_straggler(dt) else ""))
            if self.ckpt is not None and self.step % self.tc.checkpoint_every == 0:
                self._save()
        if self.ckpt is not None:
            self._save()
        return self.state

    def _save(self):
        self.ckpt.save(self.checkpoint_tree(), step=self.step)
