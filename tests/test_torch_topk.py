"""Port parity: block Top-K sparsification (``repro_torch.kernels.topk``)
against the reference's Pallas kernel ``block_topk_2d``, interpreted on
the CPU as the reference's own tests run it, its oracle
``block_topk_ref`` (exact k-th magnitude) and its wrapper
``block_topk``.

On the CPU the port's wrapper runs its plain version, the bisection the
TPU kernel computes (``block_topk_bisect_ref``): held BITWISE against
the interpreted kernel, including heavy tails, exact ties across the
threshold, a NaN, infinities, subnormals and a padded last block.  The
CUDA kernel's own algorithm -- the k-th magnitude, then the bisection
replayed on two scalars (``block_topk_kth_ref``) -- is held bitwise
against that plain version.  The
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
from repro_torch.kernels.topk.ref import (block_topk_bisect_ref,
                                          block_topk_kth_ref, block_topk_ref)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _kth_case(kind, block, rng):
    """Two row blocks (the second a padded last block for ``padded``)."""
    x = rng.standard_normal((2 * block, 128)).astype(F32)
    if kind == "ties":
        x = np.round(x * 2.0).astype(F32)
    elif kind == "nan":
        x[0, 5] = np.nan
    elif kind == "inf":
        x[0, :2] = [np.inf, -np.inf]
        x[-1, 3] = np.inf
    elif kind == "subnormal":      # flushed magnitudes, some at the k-th
        x[:block] *= F32(1e-39)
        x[block:, ::2] *= F32(1e-40)
    elif kind == "scales":         # one scale a row, 1e-40 to 1e37
        x *= np.logspace(-40, 37, 2 * block).astype(F32)[:, None]
    elif kind == "padded":         # the wrapper's zero padding
        x[block + block // 2:] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "ties", "nan", "inf", "subnormal",
                                  "scales", "padded"])
@pytest.mark.parametrize("k", [0, 1, 13, 102, 128, 358, 819, 8192])
@pytest.mark.parametrize("block", [1, 8, 28, 64])
def test_kth_form_bitwise_vs_bisection(block, k, kind, dtype):
    """For mid >= 0, count(a >= mid) >= k exactly when kth >= mid: the
    bisection replayed on (kth, max a) gives the same lo, so the same
    bits, with ties, NaN, infinities, flushed magnitudes, extreme scales,
    k = 0, k above the block's size and padding."""
    x = torch.from_numpy(_kth_case(kind, block,
                                   np.random.default_rng(block * 31 + k)))
    x = x.to(getattr(torch, dtype))
    got = block_topk_kth_ref(x, k=k, block=block)
    ref = block_topk_bisect_ref(x, k=k, block=block)
    assert got.dtype == x.dtype
    assert _same(got.float().numpy(), ref.float().numpy()).all()


def test_cpu_tensor_runs_the_bisection(monkeypatch):
    """The wrapper dispatches on the tensor's device alone: a CPU tensor
    goes through ``block_topk_bisect_ref`` (never the kernel's library)."""
    from repro_torch.kernels.topk import kernel as K

    calls = []

    def spy(x, *, k, block):
        calls.append((tuple(x.shape), k, block))
        return block_topk_bisect_ref(x, k=k, block=block)

    monkeypatch.setattr(K, "block_topk_bisect_ref", spy)
    monkeypatch.setattr(K, "_lib", lambda source=None: pytest.fail("built"))
    x = torch.from_numpy(_kth_case("normal", 8, np.random.default_rng(0)))
    out = K.block_topk_2d(x, k=102, block_rows=8)
    assert calls == [((16, 128), 102, 8)]
    assert torch.equal(out, block_topk_bisect_ref(x, k=102, block=8))


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("others", [["old.cu"], ["old.cu", "other.cu"]])
def test_chip_smoke_topk_against_needs_a_card(others, monkeypatch, capsys):
    """The old-against-new timing mode fails without CUDA rather than
    timing anything on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        _chip_smoke().main(["--topk-against", *others])
    assert exit_.value.code == 1
    assert "needs a GPU" in capsys.readouterr().err


def test_chip_smoke_ptxas_report_names_the_topk_kernels():
    """The ptxas report (as nvcc -Xptxas=-v prints it for topk.cu) is
    parsed into one line per instantiation of the kernel."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__6bf183df"
        "_9_topk_cu_d3706a4717block_topk_kernelINS_5F32x4EEEvPKNT_3RawEPS3_"
        "iii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 2176 bytes smem",
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__6bf183df"
        "_9_topk_cu_d3706a4717block_topk_kernelINS_6BF16x4EEEvPKNT_3RawEPS3_"
        "iii' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 2176 bytes smem",
    ])
    assert _chip_smoke().ptxas_report(log) == [
        ("block_topk_kernel<f32>", 80, 0, 0, 2176),
        ("block_topk_kernel<bf16>", 64, 8, 4, 2176)]
