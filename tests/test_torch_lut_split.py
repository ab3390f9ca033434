"""The LUT-GEMM kernels' 3xTF32 arithmetic, held in plain numpy on the CPU.

On the card both LUT-GEMM kernels (``csrc/lut_gemm_tile.cuh``) split every
codebook entry c into hi = tf32_rna(c) and lo = tf32_rna(c - hi) and add
lo*hi + hi*lo + hi*hi on the TF32 tensor cores. These tests emulate that
split with a bit-pattern rounding to TF32 and sum the three products in
float64, which bounds what the split alone costs: the tensor cores add the
same products in float32, whose rounding the existing GEMM tolerance
2 sqrt(K) u max(|a| @ |w|) already covers. On ``exact_sum_inputs`` the split
is exact (lo = 0) and the product must equal the plain version bit for bit.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

from repro_torch.core.quantize import bucketize_mul_form  # noqa: E402
from repro_torch.kernels.bucketize import rank  # noqa: E402
from repro_torch.kernels.lut_gemm import exact_sum_inputs, fused_lut_gemm_plain  # noqa: E402
from repro_torch.models.model import _default_codebook  # noqa: E402

U32 = 2.0**-24


def tf32_rna(x) -> np.ndarray:
    """float32 -> TF32 (10 mantissa bits) to nearest, ties away from zero, on
    the bit pattern: PTX ``cvt.rna.tf32.f32``."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split3(c) -> tuple[np.ndarray, np.ndarray]:
    c = np.asarray(c, np.float32)
    hi = tf32_rna(c)
    return hi, tf32_rna(c - hi)  # c - hi is exact in float32


def product_3xtf32(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """lo*hi + hi*lo + hi*hi of float32 matrices, summed in float64."""
    (ah, al), (wh, wl) = split3(a), split3(w)
    mm = lambda p, q: p.astype(np.float64) @ q.astype(np.float64)
    return mm(al, wh) + mm(ah, wl) + mm(ah, wh)


def gaussian_books(seed: int, n_w: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a_book = _default_codebook(4).numpy()
    return a_book, np.sort(rng.standard_normal(n_w).astype(np.float32))


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32 spacing at 1
    cases = {1 + 2.0**-12: 1.0, 1 + 2.0**-11: 1 + 2.0**-10, 1 + 3 * 2.0**-11: 1 + 2 * 2.0**-10,
             -(1 + 2.0**-11): -(1 + 2.0**-10), 3.0: 3.0, 0.0: 0.0}
    got = tf32_rna(np.array(list(cases), np.float32))
    np.testing.assert_array_equal(got, np.array(list(cases.values()), np.float32))
    assert (tf32_rna(np.float32(one + ulp)) == one + ulp).all()


@pytest.mark.parametrize("n_w", [16, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_gaussian_codebooks(seed, n_w):
    """hi and lo are TF32 values and hi + lo is within 2^-22 |c| of c."""
    for book in gaussian_books(seed, n_w):
        hi, lo = split3(book)
        for part in (hi, lo):
            assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
        c = book.astype(np.float64)
        assert (np.abs(c - hi.astype(np.float64) - lo.astype(np.float64))
                <= 2.0**-22 * np.abs(c)).all()


@pytest.mark.parametrize("byte", [False, True])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_split_is_exact_on_exact_sum_codebooks(x_dtype, byte):
    *_, a_book, w_book = exact_sum_inputs(8, 64, 32, x_dtype, byte, seed=3)
    for book in (a_book.numpy(), w_book.numpy()):
        hi, lo = split3(book)
        np.testing.assert_array_equal(hi, book)
        assert not lo.any()


@pytest.mark.parametrize("k", [512, 1000, 2048, 8192, 11008])
def test_3xtf32_product_within_gemm_tolerance(k):
    """Gaussian codebooks as served: the emulated 3xTF32 product lies within
    the kernels' tolerance 2 sqrt(K) u max(|a| @ |w|) of the float32 product."""
    m, n, n_w = 6, 48, 256
    rng = np.random.default_rng(k)
    a_book, w_book = gaussian_books(k, n_w)
    a = a_book[rng.integers(0, 16, (m, k))]
    w = w_book[rng.integers(0, n_w, (k, n))]
    want = (torch.from_numpy(a) @ torch.from_numpy(w)).numpy()  # float32
    got = product_3xtf32(a, w).astype(np.float32)
    tol = 2 * math.sqrt(k) * U32 * (np.abs(a) @ np.abs(w)).max()
    assert np.abs(got - want).max() <= tol
    # what the split alone costs: far under the tolerance
    exact = a.astype(np.float64) @ w.astype(np.float64)
    split_err = np.abs(product_3xtf32(a, w) - exact).max()
    assert split_err <= 4 * 2.0**-22 * (np.abs(a) @ np.abs(w)).max()


@pytest.mark.parametrize("m,k,n,byte,x_dtype", [
    (7, 512, 32, False, torch.bfloat16),
    (5, 2048, 64, True, torch.float32),
    (3, 8192, 16, True, torch.bfloat16),
    (2, 11008, 8, False, torch.float32),
])
def test_3xtf32_product_bit_exact_on_exact_sum_inputs(m, k, n, byte, x_dtype):
    x, s, w_packed, bounds, a_book, w_book = exact_sum_inputs(m, k, n, x_dtype, byte, seed=k)
    mul_form = x_dtype == torch.bfloat16
    a_idx = (bucketize_mul_form(x, s, bounds, dtype=torch.int32) if mul_form
             else rank(x.float() / s, bounds))
    w_idx = (w_packed.long() if byte
             else torch.stack([w_packed & 0xF, w_packed >> 4], -1).reshape(k, -1).long())
    a = a_book[a_idx.long()].numpy()
    w = w_book[w_idx].numpy()
    got = product_3xtf32(a, w).astype(np.float32)
    want = fused_lut_gemm_plain(x, s, w_packed, bounds, a_book, w_book, byte_packed=byte,
                                mul_form=mul_form).numpy()
    np.testing.assert_array_equal(got, want)
