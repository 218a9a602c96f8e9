"""Port parity: the ``natural`` and ``topk`` codecs
(``repro_torch.core.compressors``) against the reference's
``NaturalCompression`` and ``TopK``: same inputs and, for the natural
codec, the reference's uniforms replayed.  Payloads compare as integers
or bit patterns, ``wire_bits`` exactly; and the repair of the port's
default configuration (``CompressionConfig(enabled=True).make()`` and
the CLI's default codec ``natural``).

What can be bitwise (see tests/test_torch_natural.py): the natural
codec's payload is integers, equal wherever XLA's ``floor(log2(.))``
and ``exp2`` are exact at the element's exponent (its ``p_hi`` divides
by ``exp2(e)``); its decode is ``2^code`` exactly in the port and XLA's
``exp2(code)`` in the reference, so equal at the codes where XLA's is
exact.  TopK is exact everywhere, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressionConfig as JaxComp
from repro.core import compressors as JC
from repro_torch.configs.base import CompressionConfig
from repro_torch.core import compressors as TC
from repro_torch.core.compressors import ShapeDtype
from repro_torch.core.shift_rules import DianaShift, EF21Shift, EFBVShift
from repro_torch.launch import train as port_train


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32


def _xla_exact_codes():
    e = np.arange(-126, 128)
    got = np.asarray(jax.jit(jnp.exp2)(jnp.asarray(e, jnp.float32)))
    return e[got == np.ldexp(F32(1), e).astype(F32)]


EXACT_CODES = _xla_exact_codes()


def _jsd(x):
    return jax.ShapeDtypeStruct(x.shape, x.dtype)


def _natural_inputs(kind, shape, rng):
    x = rng.standard_normal(shape).astype(F32)
    if kind == "grad":            # gradient-sized magnitudes
        x *= F32(1e-3)
    elif kind == "wide":          # every exponent range
        x *= (10.0 ** rng.uniform(-30, 30, shape)).astype(F32)
    elif kind == "special":
        flat = x.reshape(-1)
        flat[:8] = [0.0, -0.0, 1e-39, -1e-39, np.inf, -np.inf, np.nan,
                    2.0 ** -126]
    return x


@pytest.mark.parametrize("kind", ["normal", "grad", "wide", "special"])
@pytest.mark.parametrize("shape", [(257,), (16, 40), (3, 5, 7)])
def test_natural_matches_reference(kind, shape):
    rng = np.random.default_rng(len(shape) * 10 + len(kind))
    x = _natural_inputs(kind, shape, rng)
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, shape))
    jq, tq = JC.NaturalCompression(), TC.make_compressor("natural")
    jp, _ = jq.encode(key, jnp.asarray(x))
    tp, meta = tq.encode(lambda s: torch.from_numpy(u), torch.from_numpy(x))
    assert meta == {}
    j_exp = np.asarray(jp["exp"].data)
    t_exp = tp["exp"].data.numpy()
    assert tp["exp"].data.dtype == torch.int16 and tp["exp"].width == 8
    assert tp["sign"].data.dtype == torch.int8 and tp["sign"].width == 1
    np.testing.assert_array_equal(tp["sign"].data.numpy(),
                                  np.asarray(jp["sign"].data))
    # the exponent codes: equal wherever XLA's exp2 at the element's
    # exponent is exact (the reference's p_hi divides by it) -- which on
    # these inputs leaves at most a handful of elements uncompared
    e = np.frexp(np.where(np.isfinite(x) & (np.abs(x) >= 2.0 ** -126),
                          np.abs(x), 1))[1] - 1
    comparable = np.isin(e, EXACT_CODES)
    np.testing.assert_array_equal(t_exp[comparable], j_exp[comparable])
    assert (t_exp != j_exp).sum() <= max(2, x.size // 1000)
    assert tq.wire_bits(tp) == jq.wire_bits(jp) == 9 * x.size
    # decode: exactly 2^code in the port; the reference's exp2 where exact
    like = ShapeDtype.of(torch.from_numpy(x))
    td = tq.decode(tp, {}, like).numpy()
    jd = np.asarray(jq.decode(jp, {}, _jsd(x)))
    codes = t_exp.astype(np.int64)
    with np.errstate(over="ignore"):                  # code 128: inf
        want = tp["sign"].data.numpy() * np.ldexp(
            F32(1), np.clip(codes, -126, 128)).astype(F32)
    np.testing.assert_array_equal(td, want.astype(F32))
    same = (t_exp == j_exp) & np.isin(codes, EXACT_CODES)
    np.testing.assert_array_equal(td[same], jd[same])
    if kind == "special":
        flat = td.reshape(-1)
        np.testing.assert_array_equal(flat[:7], [0, 0, 0, 0, np.inf,
                                                 -np.inf, 0])


def test_natural_unbiased_and_lattice():
    x = torch.tensor([0.3, -1.7, 5.0, 0.011] * 32)
    q = TC.NaturalCompression()
    gen = torch.Generator().manual_seed(0)
    outs = torch.stack([q(lambda s: torch.rand(s, generator=gen), x)
                        for _ in range(512)])
    np.testing.assert_allclose(outs.mean(0).numpy(), x.numpy(), rtol=0.05)
    m, e = np.frexp(np.abs(outs.numpy()))
    np.testing.assert_array_equal(m, 0.5)
    assert q.omega(10) == 0.125 and q.stochastic


def _topk_inputs(kind, d, rng):
    x = rng.standard_normal(d).astype(F32)
    if kind == "ties":                # many equal magnitudes at the k-th
        x = np.round(x * 2.0).astype(F32)
    elif kind == "all_equal":
        x = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(F32)
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "all_equal"])
@pytest.mark.parametrize("d,q", [(1000, 0.1), (4097, 0.05), (7, 0.5),
                                 (1, 0.1)])
def test_topk_matches_reference(kind, d, q):
    """Payload values and indices in the reference's order (lax.top_k:
    magnitude descending, ties by ascending index), decode and wire_bits:
    all exactly equal."""
    x = _topk_inputs(kind, d, np.random.default_rng(d))
    jq, tq = JC.TopK(q=q), TC.make_compressor("topk", q=q)
    jp, _ = jq.encode(jax.random.PRNGKey(0), jnp.asarray(x))
    called = []
    tp, _ = tq.encode(lambda s: called.append(s), torch.from_numpy(x))
    assert not called                     # deterministic: draws nothing
    assert tp["indices"].data.dtype == torch.int32
    assert tp["indices"].width == jp["indices"].width
    np.testing.assert_array_equal(tp["indices"].data.numpy(),
                                  np.asarray(jp["indices"].data))
    np.testing.assert_array_equal(tp["values"].numpy(),
                                  np.asarray(jp["values"]))
    assert tq.wire_bits(tp) == jq.wire_bits(jp)
    k = max(1, round(q * d))
    assert tq.wire_bits(tp) == k * (32 + max(1, int(np.ceil(np.log2(max(d, 2))))))
    like = ShapeDtype.of(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.decode(tp, {}, like).numpy(),
                                  np.asarray(jq.decode(jp, {}, _jsd(x))))
    assert tq.delta(d) == jq.delta(d) and not tq.stochastic


def test_topk_leaf_shapes_and_bf16():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 50)).astype(F32))
    q = TC.TopK(q=0.1)
    out = q(None, x)
    assert out.shape == x.shape and int((out != 0).sum()) == 30
    kept = out != 0
    assert torch.equal(out[kept], x[kept])
    xb = x.bfloat16()
    jp, _ = JC.TopK(q=0.1).encode(None, jnp.asarray(x).astype(jnp.bfloat16))
    tp, _ = q.encode(None, xb)
    np.testing.assert_array_equal(tp["indices"].data.numpy(),
                                  np.asarray(jp["indices"].data))
    assert tp["values"].dtype == torch.bfloat16


def test_wire_bits_packed_and_lists():
    pb = TC.PackedBits(torch.zeros(10, dtype=torch.int32), 7)
    payload = {"a": pb, "b": torch.zeros(3)}
    assert TC.wire_bits(payload) == 70 + 96
    assert TC.wire_bits([payload, payload]) == 2 * (70 + 96)
    assert TC._index_bits(1) == JC._index_bits(1) == 1
    for d in (2, 3, 1024, 1025, 155_582_464):
        assert TC._index_bits(d) == JC._index_bits(d)
    for q, d in ((0.1, 8192), (0.05, 10), (0.5, 5), (0.1, 1)):
        assert TC._k_of(q, d) == JC._k_of(q, d)


def test_contractive_classes():
    assert isinstance(TC.TopK(), TC.Contractive)
    assert isinstance(TC.Identity(), TC.Contractive)
    assert TC.Identity().delta(5) == 1.0 and TC.Zero().delta(5) == 0.0


def test_make_compressor_registry():
    """Every name of the reference's registry builds the reference's
    class, with the same fields (the induced entries their two parts);
    unknown names and unknown arguments raise as the reference's do."""
    assert isinstance(TC.make_compressor("natural"), TC.NaturalCompression)
    assert TC.make_compressor("topk", q=0.2) == TC.TopK(q=0.2)
    assert TC.make_compressor("randk", q=0.2) == TC.RandK(q=0.2)
    assert TC.make_compressor("sign") == TC.ScaledSign()
    assert TC.make_compressor("bernoulli", p=0.3) == TC.BernoulliP(p=0.3)
    assert TC.make_compressor("terngrad") == TC.TernGrad()
    assert TC.make_compressor("natural_dithering", s=4) == \
        TC.NaturalDithering(s=4)
    assert TC.make_compressor("induced_topk_randk", q=0.2) == TC.Induced(
        c=TC.TopK(0.2), q=TC.RandK(0.2))
    assert TC.make_compressor("induced_topk_natural") == TC.Induced(
        c=TC.TopK(0.1), q=TC.NaturalCompression())
    names = ("identity", "zero", "randk", "bernoulli", "natural_dithering",
             "natural", "terngrad", "int8", "q8_block", "topk", "sign",
             "induced", "induced_topk_randk", "induced_topk_natural")
    for name in names:
        got, want = TC.make_compressor(name), JC.make_compressor(name)
        assert type(got).__name__ == type(want).__name__, name
        if name.startswith("induced"):
            assert (type(got.c).__name__, type(got.q).__name__) == (
                type(want.c).__name__, type(want.q).__name__)
    for bad in (("nope", {}), ("induced_topk_randk", {"p": 0.1}),
                ("terngrad", {"q": 0.1})):
        with pytest.raises((ValueError, TypeError)):
            JC.make_compressor(bad[0], **bad[1])
        with pytest.raises((ValueError, TypeError)):
            TC.make_compressor(bad[0], **bad[1])


def test_default_config_builds_as_reference():
    """The repair: the default CompressionConfig builds (natural, DIANA
    alpha 0.125) in the port, as in the reference; the ef21/efbv comm
    modes build their rules with the config's eta and nu."""
    q, rule = CompressionConfig(enabled=True).make()
    jq, jrule = JaxComp(enabled=True).make()
    assert type(q).__name__ == type(jq).__name__ == "NaturalCompression"
    assert isinstance(rule, DianaShift) and rule.alpha == jrule.alpha == 0.125
    _, ef21 = CompressionConfig(comm_mode="ef21", compressor="topk").make()
    assert isinstance(ef21, EF21Shift)
    _, efbv = CompressionConfig(comm_mode="efbv", efbv_eta=0.5,
                                efbv_nu=0.75).make()
    assert efbv == EFBVShift(eta=0.5, nu=0.75)
    _, jefbv = JaxComp(comm_mode="efbv", efbv_eta=0.5, efbv_nu=0.75).make()
    assert (jefbv.eta, jefbv.nu) == (efbv.eta, efbv.nu)


def test_cli_default_codec_is_natural():
    ap_defaults = port_train.build_parser().parse_args(["--arch", "qwen3-0.6b"])
    assert ap_defaults.compressor == "natural"
    assert ap_defaults.comm_mode == "dense"
    args = port_train.build_parser().parse_args(["--arch", "qwen3-0.6b", "--comm-mode",
                                  "efbv", "--efbv-eta", "0.5", "--efbv-nu",
                                  "0.25", "--compressor", "topk"])
    assert (args.comm_mode, args.efbv_eta, args.efbv_nu) == ("efbv", 0.5,
                                                             0.25)
