"""The yardstick's counts against shapes worked by hand (PERF.md's kernel
table: llama3_2_1b's 72-row serving step)."""

import pytest

from kbench import counts
from kbench.metrics import attn_roofline, lut_gemm_roofline

PEAK, BW = 989e12, 3.35e12


def test_lut_gemm_wq_72x2048x2048_w4_is_bound_by_its_bytes():
    # 2MNK = 2 * 72 * 2048 * 2048
    flops = 603_979_776
    # packed W4 weight 2048 * 2048 / 2, codebooks (16 + 16) * 4, channel
    # scales 2048 * 4, bf16 activations 72 * 2048 * 2, token scales 72 * 4,
    # bf16 output 72 * 2048 * 2
    nbytes = 2_097_152 + 128 + 8_192 + 294_912 + 288 + 294_912
    assert counts.lut_gemm_bytes(72, 2048, 2048, 4) == nbytes
    assert counts.lut_gemm_least_s(72, 2048, 2048, 4) == pytest.approx(nbytes / BW)
    assert nbytes / BW > flops / PEAK


def test_lut_gemm_wd_w8_and_a_prefill_wi():
    # wd W8: 72 x 8192 -> 2048, one byte an index, 256 + 16 centroids
    nbytes = 8192 * 2048 + (256 + 16) * 4 + 2048 * 4 + 72 * 8192 * 2 + 72 * 4 + 72 * 2048 * 2
    assert counts.lut_gemm_least_s(72, 8192, 2048, 8) == pytest.approx(nbytes / BW)
    # wi at 1024 prefill rows: 2 * 1024 * 2048 * 16384 FLOPs bound it
    assert counts.lut_gemm_least_s(1024, 2048, 16384, 4) == pytest.approx(
        2 * 1024 * 2048 * 16384 / PEAK)


def test_attention_of_a_decode_step():
    # 72 decode rows, one request each at context 1024; KV 8, 32 heads, hd 64
    ctx = [1024] * 72
    kv_bytes = 72 * 1024 * 8 * 2 * (64 // 2 + 4)  # int4 K and V and a scale each
    qo = 2 * 72 * 32 * 64 * 2
    assert counts.attention_bytes(72, 72 * 1024, 32, 8, 64) == kv_bytes + qo
    flops = 4 * 32 * 64 * 1024 * 72
    assert counts.attention_least_s(ctx, 72 * 1024, 32, 8, 64) == pytest.approx(
        max(flops / PEAK, (kv_bytes + qo) / BW))


def test_attention_counts_shared_keys_once_and_the_window():
    import numpy as np

    cfg = {"num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 80,
           "sliding_window": 4096}
    # one prefill chunk of 4 cells at 5000..5003 and one decode cell at 9
    slots = np.array([0, 0, 0, 0, 1, 3])
    pos = np.array([[5000], [5001], [5002], [5003], [9], [-1]])
    contexts = [4096] * 4 + [10]
    cells = (5003 - (5000 - 4095) + 1) + 10
    assert attn_roofline.step_least_s(cfg, slots, pos) == pytest.approx(
        counts.attention_least_s(contexts, cells, 32, 8, 80))


def test_projection_shapes_and_active_parameters():
    danube = {"hidden_size": 2560, "num_attention_heads": 32, "num_key_value_heads": 8,
              "head_dim": 80, "intermediate_size": 6912, "num_hidden_layers": 24,
              "vocab_size": 32000}
    quant = {"w_bits": 4, "rules": [["mlp/wd", {"w_bits": 8}]]}
    assert lut_gemm_roofline.projections(danube, quant) == [
        (2560, 2560, 4), (2560, 640, 4), (2560, 640, 4), (2560, 2560, 4), (2560, 13824, 4),
        (6912, 2560, 8)]
    assert counts.active_params(danube) == 24 * (2 * 2560 * 2560 + 2 * 2560 * 640
                                                  + 3 * 2560 * 6912)
    granite = dict(danube, hidden_size=1536, num_attention_heads=24, head_dim=64,
                   intermediate_size=512, num_local_experts=40, num_experts_per_tok=8,
                   num_hidden_layers=32)
    assert len(lut_gemm_roofline.projections(granite, quant)) == 4  # the experts stay float
    assert counts.active_params(granite) == 32 * (2 * 1536 * 1536 + 2 * 1536 * 512
                                                   + 8 * 3 * 1536 * 512 + 1536 * 40)
    assert counts.token_flops(danube, 100) == 2 * counts.active_params(danube) + 24 * 4 * 32 * 80 * 100
