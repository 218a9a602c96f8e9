"""Port parity: shifted natural compression
(``repro_torch.kernels.natural``) against the reference's Pallas kernel
``shifted_natural_2d``, interpreted on the CPU as the reference's own
tests run it, and its wrapper ``shifted_natural`` with the reference's
uniforms replayed.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held bitwise against that plain version on the card by
``chip_smoke.py``.  Comparisons are of bit patterns (any NaN equals any
NaN).

The port computes C_nat exactly: the exponent from the float's bits and
the levels ``2^e`` exact.  XLA, running the reference on the CPU, does
neither everywhere, and two known differences follow (both pinned
below, and listed in ROADMAP queue 3):

1. ``floor(log2(a))`` is ``e`` instead of ``e - 1`` just below some
   powers of two ``2^e`` (and ``e - 1`` at some exact ones).  The output
   is still the same unless ``u`` is within an ulp or two of 1.
2. ``exp2(e)`` of an integer is exact at only 33 of the 254 exponents
   (-14, -12..12 and seven even ones up to 28), up to 67 ulps off
   ``2^e`` elsewhere, and 0 at e = -126 (flushed).  Where the difference
   lands on such a level and ``|h|`` is not large enough to absorb it in
   ``h + q``, the reference's output is that many ulps off a power of
   two.

So the comparison is bitwise at every element whose level XLA computes
exactly and whose exponent XLA floors right (``_exact_in_reference``),
and on the reference tests' inputs (g, h unit normal) at every element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.natural.kernel import shifted_natural_2d as jax_kernel
from repro.kernels.natural.ops import shifted_natural as jax_wrapper
from repro_torch.kernels.natural.kernel import shifted_natural_2d
from repro_torch.kernels.natural.ops import natural_layout, shifted_natural
from repro_torch.kernels.natural.ref import shifted_natural_ref


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32
TINY = F32(2.0 ** -126)


def _same(a, b):
    """Elementwise: equal bit patterns, or both NaN."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


def _xla_levels():
    """XLA's ``exp2`` of every integer exponent of a normal f32, and
    which of them are exact."""
    e = np.arange(-126, 128)
    got = np.asarray(jax.jit(jnp.exp2)(jnp.asarray(e, jnp.float32)))
    return dict(zip(e.tolist(), got == np.ldexp(F32(1), e).astype(F32)))


LEVEL_EXACT = _xla_levels()


def _ftz(x):
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) < TINY, x * F32(0), x).astype(F32)


def _exact_in_reference(g, h):
    """Elements whose reference result involves only exact levels and a
    right floor: a zero, NaN or infinite difference, or a normal one
    whose exponent e XLA floors to e and whose level exp2(e) it computes
    exactly (then 2 exp2(e) is exact too)."""
    with np.errstate(invalid="ignore"):
        x = _ftz(_ftz(g) - _ftz(h))
    a = np.abs(x)
    normal = np.isfinite(a) & (a > 0)
    e = np.frexp(np.where(normal, a, F32(1)))[1] - 1
    e_xla = np.asarray(jax.jit(
        lambda v: jnp.floor(jnp.log2(jnp.maximum(v, 1e-38))))(a))
    level_ok = np.vectorize(lambda v: LEVEL_EXACT.get(int(v), False))(e)
    return ~normal | (level_ok & (e_xla == e))


def _ref_kernel(g, h, u, block):
    return np.asarray(jax_kernel(jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(u), block_rows=block))


def _port_kernel(g, h, u, block, dtype=torch.float32):
    out = shifted_natural_2d(torch.from_numpy(g).to(dtype),
                             torch.from_numpy(h).to(dtype),
                             torch.from_numpy(u), block_rows=block)
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("rows,block", [(256, 256), (512, 256), (64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bitwise_vs_reference_kernel(rows, block, dtype):
    """The reference tests' parametrisation (tests/test_kernels.py), g and
    h unit normal: equal bit patterns at every element."""
    rng = np.random.default_rng(rows + block)
    g = rng.standard_normal((rows, 128)).astype(F32)
    h = rng.standard_normal((rows, 128)).astype(F32)
    u = rng.random((rows, 128), dtype=F32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jax_kernel(jnp.asarray(g).astype(jd),
                                jnp.asarray(h).astype(jd), jnp.asarray(u),
                                block_rows=block).astype(jnp.float32))
    td = getattr(torch, dtype)
    got = _port_kernel(g, h, u, block, td)
    assert _same(got, ref).all()


def _edge_inputs(rng):
    """Zeros, +-subnormals, NaN, +-inf and normal values against each
    other, plus 2^e and one and two ulps below it for every exponent of a
    normal f32 (both signs, h = 0 and h random), in (rows, 128)."""
    special = np.array([0.0, -0.0, 1e-39, -1e-39, 1e-38, 3e-38, -2e-38,
                        1.5e-38, 2.0 ** -126, np.nan, np.inf, -np.inf, 1.0,
                        -2.5, 3.0e38], F32)
    gs, hs = (a.ravel() for a in np.meshgrid(special, special))
    p2 = np.ldexp(F32(1), np.arange(-126, 128)).astype(F32)
    below1 = np.nextafter(p2, F32(0))
    below2 = np.nextafter(below1, F32(0))
    lat = np.concatenate([p2, below1, below2])
    lat = np.concatenate([lat, -lat, lat])
    lat_h = np.concatenate([np.zeros(2 * lat.size // 3, F32),
                            rng.standard_normal(lat.size // 3).astype(F32)])
    g = np.concatenate([gs, lat])
    h = np.concatenate([hs, lat_h])
    pad = (-g.size) % 128
    g = np.pad(g, (0, pad)).reshape(-1, 128)
    h = np.pad(h, (0, pad)).reshape(-1, 128)
    return g, h


def test_plain_bitwise_vs_reference_kernel_edges():
    """The edge set, with seeded u: bitwise wherever the reference's level
    and floor are exact (the two known differences aside); the subnormal
    flushes and NaN/inf propagation included."""
    rng = np.random.default_rng(3)
    g, h = _edge_inputs(rng)
    u = rng.random(g.shape, dtype=F32)
    ref = _ref_kernel(g, h, u, g.shape[0])
    got = _port_kernel(g, h, u, g.shape[0])
    exact = _exact_in_reference(g, h)
    # 739 of the 2,560: every zero, subnormal, NaN and inf case, and the
    # lattice at the exponents where XLA's exp2 is exact
    assert exact.sum() >= 700
    assert _same(got, ref)[exact].all()
    # the flush and NaN/inf cases the issue lists, by value
    cases = {(1e-39, 0.0): 0.0, (1e-39, 1e-39): 0.0, (3e-38, 2e-38): 2e-38,
             (np.nan, 0.0): np.nan, (np.inf, 0.0): np.inf,
             (-np.inf, 0.0): -np.inf}
    for (gv, hv), want in cases.items():
        one = np.zeros((1, 128), F32)
        gg, hh = one.copy(), one.copy()
        gg[0, 0], hh[0, 0] = gv, hv
        out = _port_kernel(gg, hh, np.full((1, 128), 0.5, F32), 1)[0, 0]
        assert _same(out, F32(want)), (gv, hv, out)


def test_levels_are_exact_where_xla_is_not():
    """Known difference 2, pinned: at g = 1.5 * 2^e, h = 0, u = 0.9 (round
    down), the port gives 2^e exactly; the reference gives XLA's exp2(e),
    which equals 2^e exactly at the exponents LEVEL_EXACT marks."""
    e = np.arange(-126, 128)
    g = np.zeros((2, 128), F32)
    g.ravel()[:e.size] = np.ldexp(F32(1.5), e).astype(F32)
    h = np.zeros_like(g)
    u = np.full(g.shape, 0.9, F32)
    ref = _ref_kernel(g, h, u, g.shape[0]).ravel()[:e.size]
    got = _port_kernel(g, h, u, g.shape[0]).ravel()[:e.size]
    np.testing.assert_array_equal(got, np.ldexp(F32(1), e).astype(F32))
    exact = np.array([LEVEL_EXACT[int(v)] for v in e])
    assert _same(got, ref)[exact].all()
    assert not _same(got, ref)[~exact].any()
    assert exact.sum() == 33                         # jax 0.9.0's XLA


def test_floor_difference_below_powers_of_two():
    """Known difference 1, pinned: one ulp below 2^E (h = 0) the exact
    exponent is E - 1 with p_up = 1 - 2^-23, so the port rounds up to
    2^E unless u >= 1 - 2^-23.  The reference, where XLA floors to E,
    gives exp2(E) for every u.  So for u < 1 - 2^-22 the two agree, and
    at u = 1 - 2^-23 they differ exactly where XLA's floor is off."""
    e = np.arange(-124, 127)
    e = e[[LEVEL_EXACT[int(v)] and LEVEL_EXACT[int(v) - 1] for v in e]]
    a = np.nextafter(np.ldexp(F32(1), e).astype(F32), F32(0))
    g = np.zeros((2, 128), F32)
    g.ravel()[:a.size] = a
    h = np.zeros_like(g)
    floor_off = np.asarray(jax.jit(
        lambda v: jnp.floor(jnp.log2(jnp.maximum(v, 1e-38))))(a)) == e
    assert floor_off.any()
    for uv in (0.0, 0.5, 1 - 2.0 ** -22):
        u = np.full(g.shape, uv, F32)
        np.testing.assert_array_equal(
            _port_kernel(g, h, u, 2).ravel()[:a.size],
            _ref_kernel(g, h, u, 2).ravel()[:a.size])
    u = np.full(g.shape, 1 - 2.0 ** -23, F32)
    got = _port_kernel(g, h, u, 2).ravel()[:a.size]
    ref = _ref_kernel(g, h, u, 2).ravel()[:a.size]
    np.testing.assert_array_equal(got, np.ldexp(F32(1), e - 1).astype(F32))
    np.testing.assert_array_equal(_same(got, ref), ~floor_off)


@pytest.mark.parametrize("shape", [(100,), (33, 7), (5, 4, 3, 2), (8192,)])
def test_wrapper_matches_reference_wrapper(shape):
    """``shifted_natural`` against the reference's wrapper, the reference's
    uniforms (one draw over the padded (rows_pad, 128) block) replayed:
    h = 0 as in the reference's test, and h unit normal.  Bitwise where
    the reference's level is exact; with h = 0 the output is a signed
    power of two or zero."""
    key = jax.random.PRNGKey(1)
    g = np.array(jax.random.normal(key, shape, jnp.float32))
    n = g.size
    _, _, rows_pad = natural_layout(n)
    u = np.array(jax.random.uniform(key, (rows_pad, 128), jnp.float32))
    rng = np.random.default_rng(n)
    for h in (np.zeros(shape, F32), rng.standard_normal(shape).astype(F32)):
        ref = np.asarray(jax_wrapper(key, jnp.asarray(g), jnp.asarray(h)))
        drawn = []

        def rand(s):
            drawn.append(tuple(s))
            return torch.from_numpy(u)

        got = shifted_natural(rand, torch.from_numpy(g), torch.from_numpy(h))
        assert drawn == [(rows_pad, 128)]
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        got = got.numpy()
        exact = _exact_in_reference(g, h)
        assert _same(got, ref)[exact].all()
        assert exact.mean() > 0.99
        if not h.any():
            nz = np.abs(got[got != 0])
            np.testing.assert_array_equal(np.frexp(nz)[0], 0.5)


def test_wrapper_bf16_and_checks():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((7, 40)).astype(F32))
    h = torch.from_numpy(rng.standard_normal((7, 40)).astype(F32))
    u = torch.rand((3, 128), generator=torch.Generator().manual_seed(0))
    out = shifted_natural(lambda s: u, g.bfloat16(), h.bfloat16())
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (7, 40)
    flat = torch.nn.functional.pad(g.bfloat16().reshape(-1), (0, 104))
    hflat = torch.nn.functional.pad(h.bfloat16().reshape(-1), (0, 104))
    ref = shifted_natural_ref(flat.reshape(3, 128), hflat.reshape(3, 128), u)
    assert torch.equal(out.reshape(-1), ref.reshape(-1)[:280])
    with pytest.raises(ValueError):
        shifted_natural(lambda s: u, g, h.T.contiguous())
    with pytest.raises(ValueError):
        shifted_natural_2d(g[:, :128].new_zeros(3, 128), h.new_zeros(3, 128),
                           u, block_rows=2)
    with pytest.raises(TypeError):
        shifted_natural_2d(u, u.bfloat16(), u, block_rows=1)


def test_unbiased():
    """Monte-Carlo unbiasedness of the wrapper as a U(1/8) member (the
    reference's test: 512 draws)."""
    g = torch.tensor([0.3, -1.7, 5.0, 0.011] * 32)
    h = torch.tensor([0.1, -1.0, 4.0, 0.0] * 32)
    gen = torch.Generator().manual_seed(0)
    outs = torch.stack([
        shifted_natural(lambda s: torch.rand(s, generator=gen), g, h)
        for _ in range(512)])
    np.testing.assert_allclose(outs.mean(0).numpy(), g.numpy(), rtol=0.05,
                               atol=0.01)
