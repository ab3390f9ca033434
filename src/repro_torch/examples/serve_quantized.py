"""Serving example (port of ``examples/serve_quantized.py``): batched requests
against a K-Means-quantized model, served from a saved quantized artifact.

Trains a tiny LM briefly (so generations are not pure noise), quantizes it
under a declarative per-layer QuantSpec (W4A4 + dynamic outliers
everywhere, W8 down-projections, int4 K-Means KV cache), saves the
quantized model with ``save_quantized``, then, as a serving process would,
loads the artifact and serves a batch of prompts through the paged
continuous-batching engine. No calibration or K-Means code runs on the
load path.

``--speculative`` also quantizes the same model under the default W3/A4
draft policy (``serving.speculative.DEFAULT_DRAFT_SPEC``), saves it as a
second artifact and serves the prompts again with draft-propose /
target-verify speculative decoding: the same tokens, several committed per
target step (the acceptance rate is printed).

``--telemetry quality`` also runs the quantization-numerics probes
(codebook utilization, SQNR and outlier-energy gauges, calibration drift,
the shadow probe's logit KL); ``--metrics-json PATH`` writes the final
metric snapshot as JSON, with its Prometheus text under ``"expfmt"``.

Runs on the card: ``PYTHONPATH=src python -m repro_torch.examples.serve_quantized
[--steps 200] [--smoke] [--speculative] [--telemetry quality]
[--metrics-json out.json] [--config oasis_7b]``; on the CPU (the kernels'
plain versions) with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from repro_torch.configs.base import get_smoke_config, list_archs
from repro_torch.core.artifact import load_calib_stats, load_quantized, save_quantized
from repro_torch.core.qlinear import QLinearConfig
from repro_torch.core.quantspec import QuantSpec
from repro_torch.data.pipeline import ByteCorpus, DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import build, quantize_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["PROMPTS", "SPEC", "main"]

PROMPTS = ["def quantize(", "import jax", "class Model", "# The paper", "return x @ w"]
SPEC = QuantSpec(
    base=QLinearConfig(detection="dynamic", outlier_frac=0.005),
    rules=[("mlp/wd", {"w_bits": 8})],  # precision where accuracy lives
    kv_bits=4, kv_dtype="float32",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200, help="warmup train steps")
    ap.add_argument("--smoke", action="store_true", help="CI: minimal training")
    ap.add_argument("--speculative", action="store_true",
                    help="also serve with a W3 draft artifact + verification")
    ap.add_argument("--config", default="oasis_7b",
                    choices=[a for a in list_archs()
                             if get_smoke_config(a).input_mode == "tokens"],
                    help="smoke config to serve (every ported text-only config: the "
                         "byte corpus has no images)")
    ap.add_argument("--telemetry", default="metrics",
                    choices=["off", "metrics", "trace", "quality"],
                    help="telemetry level ('quality' adds numerics probes)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final telemetry snapshot (JSON) + "
                         "Prometheus text rendering to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = 30 if args.smoke else args.steps
    telemetry = args.telemetry
    if telemetry == "quality":
        # the default cadences (16/32) suit long-running servers; this
        # example serves ~30 packed steps, so sample tighter to populate
        # every gauge and land at least one shadow probe
        from repro_torch.serving.telemetry import TelemetryConfig
        telemetry = TelemetryConfig(level="quality", quality_sample_every=4,
                                    quality_shadow_every=8)

    cfg = get_smoke_config(args.config)
    model = build(cfg)
    corpus = ByteCorpus()
    print(f"== warm up the model on repo text ({steps} steps) so decode is non-trivial")
    trainer = Trainer(
        model,
        TrainConfig(optimizer=AdamWConfig(lr=2e-3), warmup_steps=min(20, steps),
                    total_steps=steps),
        TokenPipeline(corpus.tokens, DataConfig(seq_len=64, global_batch=16, seed=0)),
        device=device,
    )
    trainer.run(steps, log_every=100)
    params = trainer.state["params"]

    print("== quantize under a per-layer QuantSpec "
          "(W4A4 + outliers; W8 down-proj; int4 KV)")
    qparams = quantize_model(model, params, SPEC)

    with tempfile.TemporaryDirectory() as artifact_dir:
        print(f"== save_quantized -> {artifact_dir} (packed npz + JSON manifest)")
        save_quantized(artifact_dir, cfg, SPEC, qparams)

        print("== load_quantized (fresh objects; zero calibration on this path)")
        served_model, served_params, served_spec = load_quantized(artifact_dir, device=device)

        engine = ServingEngine(
            served_model,
            served_params,
            ServeConfig.from_spec(served_spec, cache_len=128, block_size=16,
                                  prefill_chunk=16, telemetry=telemetry),
            batch_slots=4,
            calib_stats=load_calib_stats(artifact_dir),
        )
        prompts = [list(t.encode()) for t in PROMPTS]
        print(f"== serving {len(prompts)} byte-level prompts through {engine.slots} "
              f"slots (paged={engine.paged}: int4 block pool + continuous batching)")
        outs = engine.generate(prompts, max_new_tokens=24)
        for text, toks in zip(PROMPTS, outs):
            cont = bytes(t for t in toks if t < 256).decode(errors="replace")
            print(f"   {text!r} -> {cont!r}")
        if engine.paged:
            st = engine.scheduler.stats
            print(f"   scheduler: {st['packed_steps']} packed steps "
                  f"({st['mixed_steps']} mixed prefill+decode), "
                  f"{st['prefill_tokens']} prefill tokens in {st['prefill_chunks']} segments, "
                  f"peak pool occupancy {st['peak_occupancy']:.0%}, "
                  f"{st['preemptions']} preemptions")
            snap = engine.snapshot()
            ttft, itl = snap["requests"]["ttft_s"], snap["requests"]["itl_s"]
            steps_st = snap["steps"]
            print(f"   telemetry: TTFT p50 {ttft['p50'] * 1e3:.1f} ms / "
                  f"p95 {ttft['p95'] * 1e3:.1f} ms, "
                  f"ITL p50 {itl['p50'] * 1e3:.2f} ms over {itl['count']} tokens, "
                  f"step split host {steps_st['host_s']['mean'] * 1e3:.1f} ms / "
                  f"device {steps_st['device_s']['mean'] * 1e3:.1f} ms, "
                  f"mean budget util {steps_st['util']['mean']:.0%}")
            if args.telemetry == "quality":
                g = snap.get("gauges", {})
                utils = [v for k, v in g.items() if k.startswith("numerics_a_codebook_util.")]
                sqnrs = [v for k, v in g.items() if k.startswith("numerics_sqnr_db.")]
                print(f"   quality: {len(utils)} probed sites, "
                      f"mean codebook util {sum(utils) / max(len(utils), 1):.0%}, "
                      f"mean SQNR {sum(sqnrs) / max(len(sqnrs), 1):.1f} dB, "
                      f"drift alarms "
                      f"{snap.get('counters', {}).get('numerics_drift_alarms', 0)}")

        if args.speculative:
            from repro_torch.serving.speculative import DEFAULT_DRAFT_SPEC, SpeculativeConfig

            with tempfile.TemporaryDirectory() as draft_dir:
                print("== quantize the SAME model under the default W3 draft "
                      "policy and save the draft artifact")
                save_quantized(draft_dir, cfg, DEFAULT_DRAFT_SPEC,
                               quantize_model(model, params, DEFAULT_DRAFT_SPEC))
                spec_engine = ServingEngine(
                    served_model, served_params,
                    ServeConfig.from_spec(
                        served_spec, cache_len=128, block_size=16, prefill_chunk=16,
                        speculative=SpeculativeConfig(k=2, draft_artifact=draft_dir)),
                    batch_slots=4,
                )
            spec_outs = spec_engine.generate(prompts, max_new_tokens=24)
            if spec_outs != outs:
                raise AssertionError("speculative greedy must be token-identical")
            st = spec_engine.stats
            print(f"== speculative serving: token-identical in "
                  f"{st['packed_steps']} target steps "
                  f"(non-speculative took {engine.scheduler.stats['packed_steps']}), "
                  f"acceptance {st['acceptance_rate']:.0%} "
                  f"({st['accepted_tokens']}/{st['drafted_tokens']} drafts, "
                  f"{st['rolled_back_tokens']} rolled back, "
                  f"{st['draft_steps']} draft dispatches)")

        if args.metrics_json:
            dump = engine.snapshot()
            dump["expfmt"] = engine.telemetry.expfmt()
            with open(args.metrics_json, "w") as f:
                json.dump(dump, f, indent=1, default=float)
            print(f"== metrics snapshot -> {args.metrics_json} "
                  f"(JSON + Prometheus text under 'expfmt')")
    print("OK (QuantSpec-quantized artifact saved, reloaded, and served: "
          "W4/W8 weights + A4 activations + int4 paged KV, continuous batching"
          + (", speculative decoding verified" if args.speculative else "") + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
