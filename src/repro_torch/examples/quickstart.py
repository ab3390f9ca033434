"""Quickstart: the paper's technique end to end on one linear layer, in the port.

The port of ``examples/quickstart.py``, step for step and at its sizes:

  1. K-Means-quantize a weight matrix (W4, per-out-channel scales)
  2. learn an offline activation codebook (A4) on calibration data
  3. run the Cartesian-product LUT-GEMM three ways (counting oracle,
     factorized plain PyTorch, the index LUT-GEMM kernel); the kernel must
     lie within float32 rounding of the factorized form, and the
     Clustering-Unit (bucketize) kernel's indices must equal
     ``quantize_activation``'s
  4. add dynamic outlier detection + look-ahead error compensation and see
     the accuracy recovered
  5. scale it to a whole model with the declarative QuantSpec API:
     quantize -> save_quantized -> load_quantized -> bit-identical logits

Runs on the card: ``PYTHONPATH=src python -m repro_torch.examples.quickstart``;
on the CPU (the kernels' plain versions) with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.artifact import load_quantized, save_quantized
from repro_torch.core.lut_gemm import lut_gemm, lut_gemm_counting
from repro_torch.core.outlier import detect_outliers_topk, num_outliers
from repro_torch.core.qlinear import QLinearConfig, qlinear_apply, quantize_linear
from repro_torch.core.quantize import (fit_activation_codebook, quantize_activation,
                                       quantize_weight)
from repro_torch.core.quantspec import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.model import build, quantize_model

__all__ = ["inputs", "run", "main"]

K_DIM, N_DIM, M = 512, 256, 32
SPEC = QuantSpec(
    base=QLinearConfig(detection="dynamic", outlier_frac=0.005),
    rules=[("mlp/wd", {"w_bits": 8}),   # per-layer precision: W8 down-proj
           ("attn/wk", "skip")],        # ...and leave wk dense entirely
    kv_bits=4,
)


def inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The weight (K, N) and the heavy-tailed activations (M, K) of steps 1-4."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(K_DIM, N_DIM) * 0.4).astype(np.float32)
    x = rng.randn(M, K_DIM).astype(np.float32)
    x[0, 7], x[5, 100] = 12.0, -9.0  # the outliers LLMs exhibit
    return w, x


def run(w: np.ndarray, x: np.ndarray, device, artifact_dir: str | None = None,
        verbose: bool = True) -> dict:
    """Steps 1-5 on ``device``; returns what each step computed (on the CPU)."""
    say = print if verbose else (lambda *a: None)
    w = torch.from_numpy(w).to(device)
    x = torch.from_numpy(x).to(device)

    say("== 1. quantize weights (W4 K-Means, per-out-channel scale)")
    qw = quantize_weight(w, nbits=4)
    say(f"   packed {tuple(qw.packed.shape)} uint8 + 16-entry codebook -> "
        f"{qw.hbm_bytes() / w.numel() / 4:.2%} of fp32 bytes")

    say("== 2. offline activation codebook (A4 K-Means on calibration set)")
    book = fit_activation_codebook(x, nbits=4)
    qa = quantize_activation(x, book)

    say("== 3. LUT-GEMM three ways")
    y_ref = x @ w
    y_counting = lut_gemm_counting(qa, qw)  # paper Fig. 6 histogram form
    y_factorized = lut_gemm(qa, qw)  # factorized plain PyTorch
    y_kernel = ops.lut_gemm(qa, qw)  # the index LUT-GEMM kernel (plain version on the CPU)
    idx_cu = ops.bucketize(x / qa.scale, book)  # the Clustering-Unit kernel
    assert torch.equal(idx_cu, qa.idx), "Clustering Unit must equal quantize_activation"
    # both sum the same K products in other orders, then scale alike: float32
    # rounding over K terms stays within 2 sqrt(K) u max(|a| @ |w|) max|sA sW|
    mag = qa.codebook[qa.idx.long()].abs() @ qw.centroids().abs()
    scale = (qa.scale * qw.scale).abs().max()
    tol_kernel = (2 * K_DIM**0.5 * 2.0**-24 * mag.max() * scale).item()
    err_kernel = (y_factorized - y_kernel).abs().max().item()
    say(f"   counting vs factorized : {(y_counting - y_factorized).abs().max().item():.2e}")
    say(f"   factorized vs kernel   : {err_kernel:.2e} (bound {tol_kernel:.2e})")
    assert err_kernel <= tol_kernel, "the index LUT-GEMM kernel must match the factorized form"

    say("== 4. outlier look-ahead + error compensation")
    rel = lambda y: (torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)).item()
    err_plain = rel(y_factorized)
    cfg = QLinearConfig(detection="dynamic", outlier_frac=0.01)
    p = quantize_linear(w, x, cfg)
    y_oasis = qlinear_apply(p, x, cfg)
    err_oasis = rel(y_oasis)
    k = num_outliers(K_DIM, cfg.outlier_frac)
    outs = detect_outliers_topk(x, k)
    say(f"   detected {outs.channels.shape[-1]} outliers/token "
        f"(top-{k} + bottom-{k}), rel.err {err_plain:.4f} -> {err_oasis:.4f}")
    assert err_oasis < err_plain

    say("== 5. whole model: QuantSpec -> quantize_model -> save -> load")
    mcfg = get_smoke_config("llama3_2_1b")
    model = build(mcfg)
    qparams = quantize_model(model, model.init(seed=0, device=device), SPEC)
    batch = {"tokens": (torch.arange(8, dtype=torch.int32, device=device)[None]
                        % mcfg.vocab_size)}
    logits = model.apply(qparams, batch).logits
    with tempfile.TemporaryDirectory() as tmp:
        d = artifact_dir or tmp
        save_quantized(d, mcfg, SPEC, qparams)
        loaded = load_quantized(d, device=device)  # fresh process stand-in: no calibration
        logits2 = loaded.model.apply(loaded.params, batch).logits
    assert torch.equal(logits, logits2), "artifact must be bit-exact"
    say(f"   per-layer spec applied ({SPEC.rules[0].pattern} -> W8, "
        f"{SPEC.rules[1].pattern} dense), artifact round-trip bit-exact")
    say("OK")
    cpu = lambda t: t.detach().cpu()
    return {"qw_packed": cpu(qw.packed), "qw_codebook": cpu(qw.codebook),
            "qw_scale": cpu(qw.scale), "act_codebook": cpu(book), "a_idx": cpu(qa.idx),
            "a_scale": cpu(qa.scale), "y_counting": cpu(y_counting),
            "y_factorized": cpu(y_factorized), "y_kernel": cpu(y_kernel),
            "err_kernel": err_kernel, "tol_kernel": tol_kernel, "y_oasis": cpu(y_oasis),
            "err_plain": err_plain, "err_oasis": err_oasis, "logits": cpu(logits)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    run(*inputs(), resolve_device(args.device))


if __name__ == "__main__":
    main()
