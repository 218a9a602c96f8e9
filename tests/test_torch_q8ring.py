"""Port parity: the blockwise int8 codec (``repro_torch.kernels.q8ring``)
against the reference's Pallas kernels, run in interpret mode on the
CPU as the reference's own tests run them.

On the CPU the port's wrappers run their plain PyTorch versions, which
are held BITWISE against the reference: q, scales and dequantized values
compare as integers / bit patterns.  The CUDA kernels are held bitwise
against these same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels.q8ring import kernel as JK
from repro.kernels.q8ring import ops as JO
from repro.models import model as JM
from repro_torch.core.compressors import ShapeDtype
from repro_torch.kernels.q8ring import kernel as TK
from repro_torch.kernels.q8ring import ops as TO


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    """f32 array -> its int32 bit patterns (bitwise comparison)."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _x(kind, rows, block, rng):
    x = (rng.standard_normal((rows, 128)) * 3.0).astype(np.float32)
    if kind == "zero_tile":        # scale floor: max|x| = 0 in the first tile
        x[:block] = 0.0
    elif kind == "lattice":        # values exactly on a quarter-step lattice
        x = np.round(x * 4.0) / 4.0
    elif kind == "negative":
        x = -np.abs(x)
    elif kind == "wide":           # tiles of very different magnitudes
        x *= np.logspace(-20, 20, rows, dtype=np.float32)[:, None]
    return x.astype(np.float32)


SWEEP = [(1, 1), (5, 5), (8, 8), (64, 8), (64, 64), (96, 32), (128, 64),
         (130, 2)]
KINDS = ["normal", "zero_tile", "lattice", "negative", "wide"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,block", SWEEP)
def test_quantize_bitwise_vs_reference_kernel(rows, block, kind):
    rng = np.random.default_rng(rows * 1000 + block)
    x = _x(kind, rows, block, rng)
    u = rng.random((rows, 128), dtype=np.float32)
    qj, sj = JK.q8_quantize_2d(jnp.asarray(x), jnp.asarray(u),
                               block_rows=block)
    qt, st = TK.q8_quantize_2d(torch.from_numpy(x), torch.from_numpy(u),
                               block_rows=block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(st.shape) == (rows // block, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


@pytest.mark.parametrize("with_acc", [True, False])
@pytest.mark.parametrize("rows,block", SWEEP)
def test_dequant_add_bitwise_vs_reference_kernel(rows, block, with_acc):
    """acc + q * scale rounds once (fma) on both sides; without an
    accumulator the port skips the read and the reference adds zeros."""
    rng = np.random.default_rng(7 + rows * 1000 + block)
    q = rng.integers(-128, 128, (rows, 128)).astype(np.int8)
    s = (rng.random((rows // block, 1)) * 10.0 ** rng.integers(
        -8, 8, (rows // block, 1))).astype(np.float32)
    acc = (rng.standard_normal((rows, 128)) * 5.0).astype(np.float32)
    if not with_acc:
        acc[:] = 0.0
    out_j = JK.q8_dequant_add_2d(jnp.asarray(q), jnp.asarray(s),
                                 jnp.asarray(acc), block_rows=block)
    out_t = TK.q8_dequant_add_2d(torch.from_numpy(q), torch.from_numpy(s),
                                 torch.from_numpy(acc) if with_acc else None,
                                 block_rows=block)
    np.testing.assert_array_equal(_bits(out_t.numpy()), _bits(out_j))


def test_dequant_add_is_a_single_rounding():
    """A case where the two-rounding acc + RN(q*s) differs from the fma:
    the plain version must give the fma, as the reference does."""
    q = np.full((1, 128), 1, np.int8)
    s = np.array([[2.0 ** -24 + 2.0 ** -47]], np.float32)
    acc = np.full((1, 128), 1.0, np.float32)
    out = TK.q8_dequant_add_2d(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(acc), block_rows=1).numpy()
    exact = np.float32(np.float64(1.0) + np.float64(s[0, 0]))
    assert out[0, 0] == exact == np.nextafter(np.float32(1), np.float32(2))
    ref = JK.q8_dequant_add_2d(jnp.asarray(q), jnp.asarray(s),
                               jnp.asarray(acc), block_rows=1)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("block_rows", [1, 8, 64, 256])
def test_layout_matches_reference(block_rows):
    for d in [1, 2, 127, 128, 129, 1000, 8191, 8192, 8193, 65536, 100_003,
              1024 * 151936]:
        assert TO.q8_layout(d, block_rows) == JO.q8_layout(d, block_rows)
        rows = max(1, -(-d // 128))
        assert TO._tile_rows(rows, block_rows) == JO._tile_rows(
            rows, block_rows)


def _smoke_leaves():
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return [tuple(a.shape) for a in jax.tree_util.tree_leaves(shapes)]


@pytest.mark.parametrize("shape", sorted(set(_smoke_leaves())))
def test_fused_q8_codec_matches_reference(shape):
    """Same leaf, same uniforms: payload (q, scale) bitwise, decode
    bitwise, wire_bits equal."""
    rng = np.random.default_rng(abs(hash(shape)) % 2**32)
    x = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jcodec, tcodec = JO.FusedQ8(), TO.FusedQ8()
    pj, _ = jcodec.encode(key, jnp.asarray(x))
    dj = jcodec.decode(pj, {}, jax.ShapeDtypeStruct(shape, jnp.float32))

    _, _, rows_pad = TO.q8_layout(x.size)
    u = np.asarray(jax.random.uniform(key, (rows_pad, 128)))

    def rand(sh):
        assert tuple(sh) == u.shape
        return torch.from_numpy(u.copy())

    xt = torch.from_numpy(x)
    pt, meta = tcodec.encode(rand, xt)
    dt = tcodec.decode(pt, meta, ShapeDtype.of(xt))
    np.testing.assert_array_equal(pt["q"].numpy(), np.asarray(pj["q"]))
    np.testing.assert_array_equal(_bits(pt["scale"].numpy()),
                                  _bits(pj["scale"]))
    assert tuple(dt.shape) == shape
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))
    assert tcodec.wire_bits(pt) == jcodec.wire_bits(pj)
    assert tcodec.omega(x.size) == jcodec.omega(x.size)


def test_wrappers_check_their_inputs():
    x = torch.zeros((64, 128))
    u = torch.zeros((64, 128))
    with pytest.raises(ValueError):
        TK.q8_quantize_2d(x, u, block_rows=48)          # 64 % 48 != 0
    with pytest.raises(TypeError):
        TK.q8_quantize_2d(x.double(), u, block_rows=64)
    with pytest.raises(ValueError):
        TK.q8_quantize_2d(x, u[:32], block_rows=32)
    with pytest.raises(ValueError):
        TK.q8_quantize_2d(torch.zeros((128, 64)).t(), u, block_rows=64)
    q = torch.zeros((64, 128), dtype=torch.int8)
    with pytest.raises(ValueError):
        TK.q8_dequant_add_2d(q, torch.ones((2, 1)), None, block_rows=64)
    with pytest.raises(TypeError):
        TK.q8_dequant_add_2d(q.float(), torch.ones((1, 1)), None,
                             block_rows=64)


def test_cpu_path_does_not_count_as_a_launch():
    before = (TK.q8_quantize_2d.launches, TK.q8_dequant_add_2d.launches)
    q, s = TK.q8_quantize_2d(torch.ones((8, 128)), torch.zeros((8, 128)),
                             block_rows=8)
    TK.q8_dequant_add_2d(q, s, None, block_rows=8)
    assert (TK.q8_quantize_2d.launches,
            TK.q8_dequant_add_2d.launches) == before
