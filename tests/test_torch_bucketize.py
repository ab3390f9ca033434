"""The Clustering Unit (``idx = sum_i [x >= b_i]``): the port's plain version
against the JAX kernel and oracle, and the CUDA kernel's two bodies
(``csrc/bucketize.cu``) modelled in numpy.

The CUDA kernel runs only on a card (``tests/test_torch_gpu.py``); this file
holds its algorithm on the CPU. Up to 15 boundaries it sums compares against
the boundaries padded to 15 with +inf; from 16 to 255 it descends a search
tree of the boundaries padded to 255 with +inf, laid out breadth-first, in 8
branch-free steps. Both clamp the count to ``n_bounds``: the padding would
otherwise count for x = +inf. A scalar head up to a 128-byte line and a
scalar tail frame the 16-byte vector body.

The known NaN split: the JAX Pallas kernel's compare sum, the port's plain
version and its kernel give a NaN index 0; ``searchsorted``, and with it
``ref.bucketize_ref``, ranks NaN last (``len(b)``). And a split on
subnormals: XLA on the CPU flushes them to zero, so the JAX kernel and
oracle rank the neighbours of a 0 boundary as 0 itself; PyTorch and the CUDA
kernel (built without ``-ftz``) compare them as the numbers they are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.bucketize import bucketize_kernel_call  # noqa: E402

from repro_torch.kernels.bucketize import bucketize_call, bucketize_plain, rank  # noqa: E402

N_BOUNDS = [1, 3, 15, 16, 31, 200, 255]
REG_BOUNDS, TREE = 15, 255  # csrc/bucketize.cu


def boundaries(nb: int, seed: int) -> np.ndarray:
    """Sorted float32 boundaries with a duplicate pair and, from 3 on, a 0."""
    rng = np.random.RandomState(seed)
    b = np.sort(rng.randn(nb).astype(np.float32) * 2)
    if nb >= 3:
        b[nb // 3] = 0.0
        b[nb // 2 + 1] = b[nb // 2]
    return np.sort(b)


def inputs(nb: int, seed: int, m: int = 6, k: int = 300) -> np.ndarray:
    """Gaussian values, every boundary itself, the neighbours of each, +-0,
    +-inf and NaN of both signs."""
    rng = np.random.RandomState(seed + 1)
    b = boundaries(nb, seed)
    x = (rng.randn(m * k) * 2.5).astype(np.float32)
    planted = np.concatenate([
        b, np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf)),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32),
        np.array([0xFFC00001], np.uint32).view(np.float32),
    ]).astype(np.float32)
    pos = rng.choice(m * k, planted.size, replace=False)
    x[pos] = planted
    return x.reshape(m, k)


@pytest.mark.parametrize("nb", N_BOUNDS)
def test_plain_matches_jax_kernel_and_oracle(nb):
    x, b = inputs(nb, nb), boundaries(nb, nb)
    got = bucketize_plain(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    kern = np.asarray(bucketize_kernel_call(jnp.asarray(x), jnp.asarray(b), interpret=True))
    oracle = np.asarray(ref.bucketize_ref(jnp.asarray(x), jnp.asarray(b)))
    nan = np.isnan(x)
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    assert np.array_equal(got[~sub], kern[~sub])  # NaN included: both give 0
    assert np.array_equal(got[~nan & ~sub], oracle[~nan & ~sub])
    assert (got[nan] == 0).all() and (oracle[nan] == nb).all()  # the known NaN split
    # subnormals: JAX ranks them as zero, the port by their value
    zero = rank(torch.zeros(1), torch.from_numpy(b)).item()
    assert (kern[sub] == zero).all() and (oracle[sub] == zero).all()
    assert np.array_equal(got[sub], np.searchsorted(b, x[sub], side="right"))
    assert got.dtype == np.int32
    # on a boundary x >= b counts it; a duplicate boundary counts twice
    for i, v in enumerate(b):
        assert rank(torch.tensor([v]), torch.from_numpy(b)).item() == np.sum(b <= v) >= i + 1


def compare_sum_model(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``CompareSum``: 15 registers padded with +inf, an unrolled sum, the clamp."""
    reg = np.full(REG_BOUNDS, np.inf, np.float32)
    reg[:b.size] = b
    c = np.zeros(x.shape, np.int32)
    for v in reg:
        c += (x >= v).astype(np.int32)
    return np.minimum(c, b.size)


def tree_layout(b: np.ndarray) -> np.ndarray:
    """``TreeSearch::init``: node i (1-based, level l = floor(log2 i)) holds
    sorted position (2 (i - 2^l) + 1) 2^(7 - l) - 1; +inf past the last."""
    t = np.zeros(TREE + 1, np.float32)
    for node in range(1, TREE + 1):
        level = node.bit_length() - 1
        pos = ((2 * (node - (1 << level)) + 1) << (7 - level)) - 1
        t[node] = b[pos] if pos < b.size else np.inf
    return t


def tree_model(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``TreeSearch::rank``: 8 steps ``i = 2 i + [x >= t[i]]``, leaf i - 256, clamp."""
    t = tree_layout(b)
    i = np.ones(x.shape, np.int64)
    for _ in range(8):
        i = 2 * i + (x >= t[i]).astype(np.int64)
    return np.minimum(i - 256, b.size).astype(np.int32)


@pytest.mark.parametrize("nb", N_BOUNDS)
def test_kernel_bodies_model_equals_rank(nb):
    x, b = inputs(nb, 100 + nb), boundaries(nb, 100 + nb)
    want = rank(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    body = compare_sum_model if nb <= REG_BOUNDS else tree_model
    assert np.array_equal(body(x, b), want)
    # the tree serves every count, and without the clamp +inf counts the padding
    assert np.array_equal(tree_model(x, b), want)
    t = tree_layout(b)
    i = np.ones(1, np.int64)
    for _ in range(8):
        i = 2 * i + (np.float32(np.inf) >= t[i]).astype(np.int64)
    assert i[0] - 256 == TREE and tree_model(np.array([np.inf], np.float32), b)[0] == nb


def test_tree_layout_is_in_order_and_levels_are_contiguous():
    """The in-order walk of the tree is the sorted array (so the descent is a
    binary search), and a level's nodes are contiguous: levels 0-5 read 1-32
    distinct consecutive words (distinct banks)."""
    b = np.arange(TREE, dtype=np.float32)
    t = tree_layout(b)

    def in_order(i):
        return [] if i > TREE else in_order(2 * i) + [t[i]] + in_order(2 * i + 1)

    assert np.array_equal(np.array(in_order(1)), b)
    for level in range(6):
        nodes = np.arange(1 << level, 2 << level)
        assert len(set(nodes % 32)) == nodes.size


@pytest.mark.parametrize("offset", [0, 1, 3, 4, 17, 31])
def test_head_vector_tail_partition(offset):
    """The kernel's split of n values at x's offset (in floats) from a
    128-byte line: a scalar head to the line, whole float4 vectors, a scalar
    tail; every value once, every vector 16-byte aligned, the head at most 31
    values and the tail at most 3."""
    for n in list(range(0, 41)) + [1000, 1001, 1002, 1003]:
        head = min(n, (128 - 4 * offset) % 128 // 4)
        n4 = (n - head) // 4
        assert head <= 31 and n - head - 4 * n4 <= 3
        covered = list(range(head)) + list(range(head + 4 * n4, n))
        for q in range(n4):
            start = head + 4 * q
            assert (4 * offset + 4 * start) % 16 == 0
            covered += range(start, start + 4)
        assert sorted(covered) == list(range(n))


def test_wrapper_runs_plain_on_cpu_and_checks():
    x, b = torch.from_numpy(inputs(15, 7)), torch.from_numpy(boundaries(15, 7))
    assert torch.equal(bucketize_call(x, b), rank(x, b))
    with pytest.raises(ValueError, match="1 to 255"):
        bucketize_call(x, torch.zeros(256))
    with pytest.raises(ValueError, match="contiguous"):
        bucketize_call(x.T, b)
