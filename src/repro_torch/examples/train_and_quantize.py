"""End-to-end example (port of ``examples/train_and_quantize.py``): train a
small LM for a few hundred steps on real text (this repository's sources),
checkpoint and resume, then post-training-quantize it with the paper's
recipe (codebooks calibrated on captured activations) and compare held-out
cross-entropy.

Runs on the card: ``PYTHONPATH=src python -m repro_torch.examples.train_and_quantize
[--steps 400] [--arch llama3_2_1b]``; on the CPU (the kernels' plain
versions) with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import tempfile

import torch

from repro_torch.configs.base import get_smoke_config, list_archs
from repro_torch.core import calibration
from repro_torch.core.qlinear import QLinearConfig
from repro_torch.core.quantspec import QuantSpec
from repro_torch.data.pipeline import ByteCorpus, DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import build, quantize_model, unstack_for_capture
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer, make_eval_step

__all__ = ["SPECS", "ce_table", "main"]

SPECS = [
    ("rtn_w4a4", QuantSpec(base=QLinearConfig(method="uniform", detection="none"))),
    ("kmeans_w4a4_no_outlier", QuantSpec(base=QLinearConfig(detection="none"))),
    ("oasis_w4a4", QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.005))),
    ("oasis_w4a4_w8_down", QuantSpec(
        base=QLinearConfig(detection="dynamic", outlier_frac=0.005),
        rules=[("mlp/wd", {"w_bits": 8})])),
]


def capture_calibration(model, params, corpus: ByteCorpus, device, n_batches: int = 4,
                        batch: int = 4, seq_len: int = 64) -> dict[str, torch.Tensor]:
    """{tap name: (tokens, K) activations} of ``n_batches`` forwards over
    seed-9 batches of the corpus, every layer pooled under one name."""
    model_u, params_u = unstack_for_capture(model, params)
    pipe = TokenPipeline(corpus.tokens, DataConfig(seq_len=seq_len, global_batch=batch, seed=9))
    with torch.no_grad(), calibration.capture() as store:
        for _ in range(n_batches):
            b = pipe.next_batch()
            model_u.apply(params_u, {"tokens": torch.as_tensor(b["tokens"][:, :-1],
                                                               device=device)})
    return calibration.captured(store)


def ce_table(model, params, tc: TrainConfig, corpus: ByteCorpus, acts: dict,
             device) -> list[tuple[str, float]]:
    """Held-out CE (seed-777 batch) of the float model and of each spec
    quantized with the calibrated codebooks."""
    eval_step = make_eval_step(model, tc)
    hold = TokenPipeline(corpus.tokens, DataConfig(seq_len=64, global_batch=16, seed=777))
    batch = {k: torch.as_tensor(v, device=device) for k, v in hold.next_batch().items()}
    rows = [("fp32", float(eval_step(params, batch)["ce"]))]
    for name, spec in SPECS:
        qp = quantize_model(model, params, spec, calib=acts)
        # apply-time behaviour rides inside each QLinearParams (spec-resolved)
        rows.append((name, float(eval_step(qp, batch)["ce"])))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--arch", default="llama3_2_1b",
                    choices=[a for a in list_archs()
                             if get_smoke_config(a).input_mode == "tokens"],
                    help="smoke config family (text-only: the byte corpus has no images)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    model = build(cfg)
    corpus = ByteCorpus()
    pipe = TokenPipeline(corpus.tokens, DataConfig(seq_len=64, global_batch=16, seed=0))
    tc = TrainConfig(optimizer=AdamWConfig(lr=2e-3), warmup_steps=25,
                     total_steps=args.steps, checkpoint_every=100)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        print(f"== training {args.arch} smoke config for {args.steps} steps "
              f"(checkpoints in {ckpt_dir})")
        trainer = Trainer(model, tc, pipe, ckpt_dir=ckpt_dir, device=device)
        trainer.run(args.steps, log_every=50)

        # simulate preemption + auto-resume
        resumed = Trainer(model, tc, TokenPipeline(corpus.tokens, DataConfig(64, 16, 0)),
                          ckpt_dir=ckpt_dir, device=device)
        print(f"== auto-resume check: restored at step {resumed.step}")
        params = trainer.state["params"]

    print("== calibration: capture activations, fit codebooks")
    acts = capture_calibration(model, params, corpus, device)
    print(f"   captured {len(acts)} tapped projections, "
          f"{next(iter(acts.values())).shape[0]} tokens each")

    rows = ce_table(model, params, tc, corpus, acts, device)
    ce_fp = rows[0][1]
    print("\nmethod                     CE      PPL     dCE")
    for name, ce in rows:
        print(f"{name:26s} {ce:.4f}  {math.exp(ce):7.2f}  {ce-ce_fp:+.4f}")


if __name__ == "__main__":
    main()
