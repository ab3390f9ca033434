"""The check at a tiny size on the CPU: the reference follows the program,
the float8 control and the program's faults come out as not correct.

The cells run here with their own files and limits, at tiny widths and
lengths (``TINY``), for a one-second window on the plain routes."""

import pytest
import torch

from kbench import harness, judge, reference, weights

torch.set_num_threads(1)

DENSE = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
         "vocab_size": 256, "sliding_window": 24}
MOE = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
       "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 256}
SHORT = {"ramp_s": 0.3, "prompt": {"law": "lognormal", "median": 12, "sigma": 0.6, "min": 4,
                                   "max": 40},
         "output": {"law": "lognormal", "median": 6, "sigma": 0.6, "min": 2, "max": 12}}
TINY = {
    "danube-chat": {"config": DENSE, "traffic": SHORT,
                    "cell": {"slots": 4, "prefill_chunk": 8, "cache_len": 64, "rate_per_s": 20.0}},
    "granite-batch": {"config": MOE, "traffic": SHORT,
                      "cell": {"slots": 4, "prefill_chunk": 8, "cache_len": 64}},
}


def tiny_run(name: str, seed: int, control: bool = False) -> dict:
    return harness.run(name, seed, 1.0, False, device="cpu", overrides=TINY[name],
                       control=control)


def test_reference_follows_the_program_forward():
    """At the configuration's precision the reference gives the program's
    own logits at two layers (the plain routes on the CPU)."""
    from repro_torch.models.model import build, params_from_tree, quantize_model

    cfg = dict(harness.cells.load("danube-chat")[1], **DENSE)
    quant = dict(harness.cells.load("danube-chat")[0]["quant"], kv_bits=None)
    model = build(harness.model_config(cfg))
    tree = weights.make(cfg, 5, "cpu")
    qp = quantize_model(model, params_from_tree(tree, model.cfg), harness.quant_spec(quant))
    toks = torch.randint(0, 256, (1, 40), generator=torch.Generator().manual_seed(1))
    got = model.apply(qp, {"tokens": toks}).logits[0, :, :256].float()
    want = reference.forward(tree, cfg, quant, [toks[0]], [torch.arange(40)],
                             rnd=judge.stored(cfg), wrnd=judge.stored(cfg))[0]
    assert torch.equal(got, want)
    # the plain float32 reference, unrounded, is far off: A4 indices turn
    # bfloat16 rounding into errors of the quantization's own size
    f32 = reference.forward(tree, cfg, quant, [toks[0]], [torch.arange(40)])[0]
    assert float(judge._errs(f32, want).max()) > 0.05


@pytest.mark.parametrize("name", ["danube-chat", "granite-batch"])
def test_a_sound_run_is_correct_and_the_control_reads_far_higher(name):
    """The cells' limits were set on the card at the cells' sizes; here the
    control (the reference in float8) has to read three times what the
    program reads, on every number the cell compares. (That the control
    comes out as not correct under the cell's limits is a reading at the
    cell's own size: ``calibrate.py`` fails when it does not. At two
    layers of width 64 the control's errors are smaller than at the
    cell's depth, under those limits.)"""
    out = tiny_run(name, 2**31 + 11, control=True)
    assert out["correct"], out["checks"]
    assert out["compared"]["served_tokens"] >= 20 and out["compared"]["last_step_cells"] >= 1
    for k in out["run"].cell["limits"]:
        assert out["control"][k] >= 3 * out["numbers"][k], (k, out["numbers"], out["control"])
        assert out["control"][k] > 0.05, (k, out["control"])


def _alter_tokens(monkeypatch):
    from repro_torch.serving.scheduler import Scheduler

    sample = Scheduler._sample
    monkeypatch.setattr(Scheduler, "_sample",
                        lambda self, logits, cells: [(t + 1) % 256 for t in
                                                     sample(self, logits, cells)])


def _state_unchanged(monkeypatch):
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "_paged_write", lambda cache, k, v, positions, ctx: cache)


def _half_the_batch(monkeypatch):
    from repro_torch.serving.scheduler import Scheduler

    run_step = Scheduler._run_step

    def half(self, probe=False):
        # every other row of the step is left out: its logits are zeros
        logits, extras, flat = run_step(self, probe)
        logits = logits.clone()
        logits[::2] = 0.0
        self.last_logits = logits
        return logits, extras, flat

    monkeypatch.setattr(Scheduler, "_run_step", half)


@pytest.mark.parametrize("name", ["danube-chat", "granite-batch"])
@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged, _half_the_batch])
def test_the_program_s_faults_are_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    out = tiny_run(name, 7)
    assert not out["correct"], out["checks"]
