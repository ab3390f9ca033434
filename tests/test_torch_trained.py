"""PyTorch port vs JAX package on trained weights: a committed artifact.

``tests/fixtures/trained_oasis_smoke/`` holds what
``examples/serve_quantized.py`` makes before it serves: the byte-LM
``oasis_7b`` smoke config (2 layers, d=64, vocab 256) trained 200 steps on
the repository's own text, quantized under the main-path spec (W4A4 K-Means,
dynamic Orizuru outliers at 0.5 %, W8 ``mlp/wd``, int4 K-Means KV) and saved
by the JAX ``save_quantized``. ``expected.npz`` beside it holds the JAX
engine's greedy tokens for the example's five byte prompts (24 new tokens,
4 slots), the inputs and logits of the engine's first packed step, and the
``ServeConfig`` fields both packages share.

* The JAX engine on the artifact must still give those tokens (drift of the
  JAX package or of the fixture).
* The port on ``device="cpu"`` must give them exactly, and the first
  packed step's logits within 1e-5 of their largest magnitude, the
  tolerance of ``tests/test_torch_model.py``: the per-token RMS scale may
  differ in its last ulps between XLA and PyTorch; an A4 index flip would
  exceed it.

``chip_smoke.py`` (phase ``trained_parity``) holds the port on the card
against the same file. Regenerate the fixture -- it trains, so it is never
run by the tests -- with::

    PYTHONPATH=src python tests/test_torch_trained.py --regenerate
"""

import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.artifact import load_quantized as j_load  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.speculative import make_packed_fn as j_packed_fn  # noqa: E402

from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.speculative import make_packed_fn  # noqa: E402

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "trained_oasis_smoke"
PROMPTS = ["def quantize(", "import jax", "class Model", "# The paper", "return x @ w"]
STEP_KEYS = ("bt", "slot_ids", "pos", "ctx", "tok")  # the packed step's inputs, in order


def expected() -> dict:
    with np.load(FIXTURE / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def serve_kwargs(exp: dict) -> tuple[dict, int]:
    """(ServeConfig fields, batch_slots) recorded with the tokens."""
    sc = json.loads(str(exp["serve_config"]))
    return sc, int(exp["batch_slots"])


def prompt_tokens(exp: dict) -> list[list[int]]:
    return [[int(t) for t in p.encode()] for p in exp["prompts"]]


@pytest.fixture(scope="module")
def exp():
    return expected()


def test_fixture_is_small_and_complete(exp):
    files = sorted(p.name for p in FIXTURE.iterdir())
    assert files == ["expected.npz", "manifest.json", "tensors.npz"]
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) < 1_000_000
    assert list(exp["prompts"]) == PROMPTS
    assert exp["tokens"].shape == (len(PROMPTS), 24)
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert manifest["model"]["arch_id"] == "oasis_7b"


def test_jax_engine_gives_the_recorded_tokens(exp):
    sc, slots = serve_kwargs(exp)
    model, params, spec = j_load(str(FIXTURE))
    eng = JEngine(model, params, JServe.from_spec(spec, **sc), batch_slots=slots)
    got = eng.generate(prompt_tokens(exp), max_new_tokens=exp["tokens"].shape[1])
    assert got == exp["tokens"].tolist()


def test_port_gives_jax_tokens_on_the_cpu(exp):
    sc, slots = serve_kwargs(exp)
    art = load_quantized(str(FIXTURE), device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **sc),
                        batch_slots=slots)
    got = eng.generate(prompt_tokens(exp), max_new_tokens=exp["tokens"].shape[1])
    assert got == exp["tokens"].tolist()


def test_port_first_step_logits_match_jax(exp):
    kw, slots = serve_kwargs(exp)
    art = load_quantized(str(FIXTURE), device="cpu")
    sc = ServeConfig.from_spec(art.spec, **kw)
    pools = art.model.init_caches(slots, sc.cache_len, sc.cache_dtype, quantized=sc.kv_quant,
                                  block_size=sc.block_size, device="cpu")
    _, logits = make_packed_fn(art.model)(art.params, pools,
                                          *(torch.from_numpy(exp[k]) for k in STEP_KEYS))
    want = exp["first_step_logits"]
    valid = exp["pos"] >= 0
    np.testing.assert_allclose(logits.float().numpy()[valid], want[valid], rtol=0,
                               atol=1e-5 * np.abs(want[valid]).max())


def regenerate(out: pathlib.Path = FIXTURE, steps: int = 200) -> None:
    """What ``examples/serve_quantized.py`` does up to ``save_quantized``
    (same config, spec, seed and steps), then the JAX engine's tokens and
    first packed step on the reloaded artifact, into ``out``."""
    from repro.configs.base import get_smoke_config
    from repro.core import QLinearConfig, QuantSpec, quantize_model, save_quantized
    from repro.data.pipeline import ByteCorpus, DataConfig, TokenPipeline
    from repro.models.model import build
    from repro.optim.adamw import AdamWConfig
    from repro.train.trainer import TrainConfig, Trainer

    cfg = get_smoke_config("oasis_7b")
    model = build(cfg)
    trainer = Trainer(
        model,
        TrainConfig(optimizer=AdamWConfig(lr=2e-3), warmup_steps=min(20, steps),
                    total_steps=steps),
        TokenPipeline(ByteCorpus().tokens, DataConfig(seq_len=64, global_batch=16, seed=0)),
    )
    trainer.run(steps, log_every=100)
    spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.005),
                     rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
    qparams = quantize_model(model, trainer.state["params"], spec)
    out.mkdir(parents=True, exist_ok=True)
    save_quantized(str(out), cfg, spec, qparams)

    kw, slots, new_tokens = dict(cache_len=128, block_size=16, prefill_chunk=16), 4, 24
    served_model, served_params, served_spec = j_load(str(out))
    sc = JServe.from_spec(served_spec, **kw)
    eng = JEngine(served_model, served_params, sc, batch_slots=slots)
    first = {}
    step = eng.scheduler._packed_fn

    def record(*args):
        res = step(*args)
        if not first:
            first.update({k: np.asarray(a) for k, a in zip(STEP_KEYS, args[2:])})
            first["first_step_logits"] = np.asarray(res[1], np.float32)
        return res

    eng.scheduler._packed_fn = record
    prompts = [[b for b in p.encode()] for p in PROMPTS]
    tokens = eng.generate(prompts, max_new_tokens=new_tokens)
    # the first step again, on fresh pools: what the tests feed both packages
    pools = served_model.init_caches(slots, sc.cache_len, jnp.dtype(sc.cache_dtype),
                                     quantized=sc.kv_quant, layout="paged",
                                     block_size=sc.block_size)
    _, logits, _ = jax.jit(j_packed_fn(served_model))(
        served_params, pools, *(jnp.asarray(first[k]) for k in STEP_KEYS))
    assert np.array_equal(np.asarray(logits, np.float32), first["first_step_logits"])
    np.savez(out / "expected.npz", tokens=np.asarray(tokens, np.int32),
             prompts=np.asarray(PROMPTS), serve_config=json.dumps(kw),
             batch_slots=np.int32(slots), **first)
    for p, t in zip(PROMPTS, tokens):
        print(f"{p!r} -> {bytes(b for b in t if b < 256).decode(errors='replace')!r}")
    print(f"wrote {out}: {sum(p.stat().st_size for p in out.iterdir())} bytes")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regenerate"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_trained.py --regenerate")
    regenerate()
