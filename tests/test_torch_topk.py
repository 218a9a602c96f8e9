"""Port parity: block Top-K sparsification (``repro_torch.kernels.topk``)
against the reference's Pallas kernel ``block_topk_2d``, interpreted on
the CPU as the reference's own tests run it, its oracle
``block_topk_ref`` (exact k-th magnitude) and its wrapper
``block_topk``.

On the CPU the port's wrapper runs its plain version, the bisection the
TPU kernel computes (``block_topk_bisect_ref``): held BITWISE against
the interpreted kernel, including heavy tails, exact ties across the
threshold, a NaN, infinities, subnormals and a padded last block.  The
CUDA kernel is held bitwise against the same plain version on the card
by ``chip_smoke.py``.  Comparisons are of bit patterns (any NaN equals
any NaN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk.kernel import block_topk_2d as jax_kernel
from repro.kernels.topk.ops import block_topk as jax_wrapper
from repro.kernels.topk.ref import block_topk_ref as jax_oracle
from repro_torch.kernels.topk.kernel import MAX_BLOCK_ROWS, block_topk_2d
from repro_torch.kernels.topk.ops import block_topk, topk_layout
from repro_torch.kernels.topk.ref import block_topk_ref

F32 = np.float32


def _same(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


def _data(kind, rows, rng):
    x = rng.standard_normal((rows, 128)).astype(F32)
    if kind == "heavy":            # Student-t with 1.5 degrees of freedom
        x = rng.standard_t(1.5, (rows, 128)).astype(F32)
    elif kind == "ties":           # few distinct magnitudes: ties at kth
        x = np.round(x * 2.0).astype(F32)
    elif kind == "nan":            # one NaN in the first block
        x[0, 5] = np.nan
    elif kind == "special":        # inf, subnormals, tiny and huge blocks
        x[0, :3] = [np.inf, -np.inf, 1e-39]
        x[1:, :] *= F32(1e-30)
        x[-1, :] = x[-1, :] * F32(1e30) * F32(1e37)
    return x


def _both(x, k, block, dtype="float32"):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jax_kernel(jnp.asarray(x).astype(jd), k=k,
                                block_rows=block).astype(jnp.float32))
    got = block_topk_2d(torch.from_numpy(x).to(getattr(torch, dtype)), k=k,
                        block_rows=block)
    assert got.dtype == getattr(torch, dtype)
    return got.float().numpy(), ref


@pytest.mark.parametrize("rows,block,k", [(64, 64, 128), (128, 64, 64),
                                          (256, 64, 819), (64, 64, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bitwise_vs_reference_kernel(rows, block, k, dtype):
    """The reference tests' parametrisation (tests/test_kernels.py)."""
    x = _data("normal", rows, np.random.default_rng(rows + k))
    got, ref = _both(x, k, block, dtype)
    assert _same(got, ref).all()


@pytest.mark.parametrize("kind", ["heavy", "ties", "nan", "special"])
@pytest.mark.parametrize("block,k", [(64, 819), (8, 102), (28, 1),
                                     (64, 8192), (1, 13)])
def test_plain_bitwise_vs_reference_kernel_edges(kind, block, k):
    x = _data(kind, 2 * block, np.random.default_rng(block * 7 + k))
    got, ref = _both(x, k, block)
    assert _same(got, ref).all()


def test_nan_block_keeps_every_finite_entry():
    """One NaN in a 64 x 128 block: max|x| is NaN, the bisection never
    raises lo above 0, so the block keeps all 8,191 finite entries and
    writes 0 at the NaN (the reference's behaviour); the next block is
    sparsified as usual."""
    x = _data("nan", 128, np.random.default_rng(0))
    got, ref = _both(x, 819, 64)
    assert _same(got, ref).all()
    assert (got[:64] != 0).sum() == 8191 and got[0, 5] == 0
    assert (got[64:] != 0).sum() == 819


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,block,k", [(256, 64, 819), (64, 64, 1),
                                          (128, 64, 64), (56, 28, 358)])
def test_exact_form_vs_reference_oracle(rows, block, k, dtype):
    """``block_topk_ref`` (exact k-th magnitude) against the reference's
    oracle, bitwise; on tie-free data the bisection keeps the same set."""
    x = _data("normal", rows, np.random.default_rng(k))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    ref = np.asarray(jax_oracle(jnp.asarray(x).astype(jd), k=k,
                                block=block).astype(jnp.float32))
    got = block_topk_ref(torch.from_numpy(x).to(td), k=k, block=block)
    assert got.dtype == td
    assert _same(got.float().numpy(), ref).all()
    bis = block_topk_2d(torch.from_numpy(x).to(td), k=k, block_rows=block)
    assert torch.equal(bis, got)


@pytest.mark.parametrize("q", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("shape", [(100_000,), (1024,), (33, 7),
                                   (5, 4, 3, 2)])
def test_wrapper_matches_reference_wrapper(shape, q):
    """``block_topk`` against the reference's wrapper (zero padding of the
    last block, the clamped block, half-to-even k): bitwise; on the
    large input also the keep fraction, as the reference's test."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), shape,
                                     jnp.float32)).copy()
    ref = np.asarray(jax_wrapper(jnp.asarray(x), q=q))
    got = block_topk(torch.from_numpy(x), q=q)
    assert tuple(got.shape) == shape
    assert _same(got.numpy(), ref).all()
    if x.size >= 100_000:
        frac = (got.numpy() != 0).mean()
        assert abs(frac - q) < 0.02, (frac, q)
    kept = got.numpy() != 0
    np.testing.assert_array_equal(got.numpy()[kept], x[kept])


def test_wrapper_contraction():
    """E||C(x) - x||^2 <= (1 - q) ||x||^2 per block (the reference's test)."""
    for seed in range(5):
        x = torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), (8192,), jnp.float32)).copy())
        err = ((block_topk(x, q=0.2) - x) ** 2).sum().item()
        assert err <= (1 - 0.2) * (x ** 2).sum().item() + 1e-4


def test_layout_and_checks():
    # k rounds half to even, as Python's round in the reference
    assert topk_layout(128, 0.5 / 128 * 5)[2] == 2     # round(2.5) == 2
    assert topk_layout(151936 * 1024) == (64, 1215488, 819)
    assert topk_layout(1024) == (8, 8, 102)
    assert topk_layout(3584) == (28, 28, 358)
    x = torch.zeros((2 * MAX_BLOCK_ROWS + 2, 128))
    with pytest.raises(ValueError, match="registers"):
        block_topk_2d(x, k=10, block_rows=2 * MAX_BLOCK_ROWS + 2)
    with pytest.raises(ValueError):
        block_topk_2d(x, k=10, block_rows=4)
    with pytest.raises(TypeError):
        block_topk_2d(x.double(), k=10, block_rows=2)
