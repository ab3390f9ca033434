"""Training substrate (port of ``repro/train/trainer.py``).

``make_train_step(model, tc)`` builds the step:

  * next-token cross-entropy from the final-norm hidden states in token
    chunks (float32 logits, z-loss), plus the MoE aux loss;
  * gradient accumulation over ``tc.microbatches`` (float32 sums);
  * AdamW with clipping and the cosine schedule at ``step + 1``.

The state is ``{"params": the model's module, "opt": {"m", "v", "step"}}``,
moments keyed by the module's parameter names. Parameters are built with
``requires_grad=False`` (serving never differentiates); a train step
switches gradients on for the float parameters it updates and off again
when it returns. Weight decay follows JAX's rule on the rank of the leaf in
JAX's tree (:func:`decay_mask`).

``Trainer`` adds the operational shell: the data pipeline, auto-resume from
the latest committed checkpoint (params, moments, step, pipeline state, in
JAX's tree layout), a checkpoint every ``checkpoint_every`` steps and at the
end of a run, and the straggler monitor over step times, each step timed to
the card's completion as JAX's ``block_until_ready`` times it.
Gradient compression (``grad_compression``) needs ``distributed/collectives``,
which is not ported: it raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StepMonitor
from repro_torch.models.model import Model, head_matrix, params_from_tree, tree_from_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = ["TrainConfig", "make_train_step", "make_eval_step", "loss_fn", "init_train_state",
           "decay_mask", "Trainer"]


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


def _check_compression(tc: TrainConfig) -> None:
    if tc.grad_compression:
        raise NotImplementedError("grad_compression needs distributed/collectives.py, "
                                  "which is not ported yet")


def _ce_chunk(hc, yc, vc, head_w):
    logits = hc.float() @ head_w.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yc.long()[:, None])[:, 0]
    return torch.sum((lse - ll) * vc), torch.sum(torch.square(lse) * vc)


def _chunked_ce(hidden, head_w, labels, z_loss: float):
    """Cross-entropy from hidden states in token chunks, never holding the
    whole (tokens, vocab) logits: each chunk's logits are recomputed in the
    backward pass (``torch.utils.checkpoint``), JAX's ``jax.checkpoint``
    scan body. The last chunk is padded and its padding masked.
    Returns (ce, ce + z_loss * mean(lse^2))."""
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    y = labels.reshape(-1)
    t = h.shape[0]
    chunk = min(_CE_CHUNK, t)
    pad = (-t) % chunk
    valid = torch.nn.functional.pad(torch.ones((t,), dtype=torch.float32, device=h.device),
                                    (0, pad))
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], chunk):
        args = (h[i : i + chunk], y[i : i + chunk], valid[i : i + chunk], head_w)
        if torch.is_grad_enabled():
            c, z = checkpoint(_ce_chunk, *args, use_reentrant=False)
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
    _check_compression(tc)
    lr_fn = cosine_schedule(tc.optimizer.lr, tc.warmup_steps, tc.total_steps)

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
                    micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                             for k, v in batch.items()}
                    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                            for p in named.values()]
                    lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                    for i in range(n):
                        l, g = grads_of(named, params, {k: v[i] for k, v in micro.items()})
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
        lr = lr_fn(state["opt"]["step"] + 1)  # +1: step 0 would warm up to lr = 0
        _, _, om = adamw_update(dict(zip(named, grads)), state["opt"], named, tc.optimizer,
                                lr, decay=decay_mask(params))
        return state, {"loss": loss, "lr": lr, **om}

    return train_step


def make_eval_step(model: Model, tc: TrainConfig) -> Callable:
    @torch.inference_mode()
    def eval_step(params, batch):
        loss, metrics = loss_fn(model, params, batch, tc)
        return {"loss": loss, **metrics}

    return eval_step


def init_train_state(model: Model, seed: int, tc: TrainConfig, device=None) -> dict:
    _check_compression(tc)
    params = model.init(seed, device=device)
    return {"params": params, "opt": adamw_init(dict(params.named_parameters()))}


class Trainer:
    """Operational training shell with fault tolerance.

    - auto-resume: restores (params, moments, pipeline state, step) from the
      latest committed checkpoint in ``ckpt_dir``;
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
        the config scans them)."""
        params, opt = self.state["params"], self.state["opt"]
        names = {p: n for n, p in params.named_parameters()}
        return {"state": {"params": tree_from_params(params),
                          "opt": {"m": tree_from_params(params, lambda p: opt["m"][names[p]]),
                                  "v": tree_from_params(params, lambda p: opt["v"][names[p]]),
                                  "step": np.asarray(opt["step"], np.int32)}},
                "data": self.pipeline.state(), "step": self.step}

    def _load(self, restored: dict) -> None:
        cfg = self.model.cfg
        st = restored["state"]
        with torch.no_grad():
            for n, t in params_from_tree(st["params"], cfg).named_parameters():
                self.state["params"].get_parameter(n).copy_(t)
            for key in ("m", "v"):
                for n, t in params_from_tree(st["opt"][key], cfg).named_parameters():
                    self.state["opt"][key][n].copy_(t)
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
