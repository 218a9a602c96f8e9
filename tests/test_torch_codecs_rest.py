"""Port parity for the rest of the codecs (``repro_torch.core.compressors``):
``BernoulliP``, ``NaturalDithering``, ``TernGrad``, ``Induced`` (with
the ``induced_topk_randk`` and ``induced_topk_natural`` entries), and
the helpers ``shifted``, ``tree_compress``, ``tree_shifted_compress``,
``aot_wire_bits``, ``tree_bits``, ``tree_size`` and ``leaf_keys``.

Each codec's payload, decode and ``wire_bits`` against the reference's
jitted encode from the same draws (``KeyDraw`` replays the reference's
key: its uniforms, its permutations, and for a two-part codec the two
halves of its split), bitwise, and ``aot_wire_bits`` against the
reference's.  The known differences, each pinned in a named test:

* ``NaturalDithering``'s norm is an f32 sum over every element whose
  order is XLA's; the port's differs by an ulp or so.  Given the
  reference's norm (``encode_with_norm``) the payload is bitwise.
* XLA's ``floor(-log2 y)`` on the CPU is off by one at some powers of
  two and just above them, and its ``exp2(-j)`` inexact at some j; the
  port reads both from the float's bits.  A level index that differs
  gives a different code only when the uniform falls below an ulp-sized
  probability, so the test forces u = 0 there.
* A DIANA round with ``BernoulliP`` or ``Induced`` messages is bitwise
  the reference's jitted round, the two parts' draws addressed as parts
  ``"q/c"`` and ``"q/q"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.channel import SimChannel as JaxSim
from repro.core import compressors as JC
from repro.core.shift_rules import make_shift_rule as jax_rule
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.wire import AddressedNoise, LeafNoise
from repro_torch.core import compressors as TC
from repro_torch.core.compressors import ShapeDtype
from repro_torch.core.shift_rules import make_shift_rule


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32
NEW = ("bernoulli", "natural_dithering", "terngrad", "induced_topk_randk",
       "induced_topk_natural")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def _np(t):
    return (t.data if isinstance(t, TC.PackedBits) else t).numpy()


def _jsd(x):
    return jax.ShapeDtypeStruct(x.shape, x.dtype)


class KeyDraw:
    """The draws of the reference's key: ``jax.random.uniform`` and
    ``jax.random.permutation`` of it, and for a two-part codec the halves
    of its split (``Induced``: C the first, Q the second)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self.key, shape)))

    def permutation(self, d):
        return torch.from_numpy(np.array(jax.random.permutation(self.key, d)))

    def part_of(self, name):
        kc, kq = jax.random.split(self.key)
        return KeyDraw(kc if name == "c" else kq)


def _inputs(shape, seed, special=False):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(F32)
    if special:
        x.reshape(-1)[:4] = [0.0, -0.0, 1e-39, -2.0 ** -126]
    return x


def _payload_equal(tp, jp, what):
    """Two payload trees equal leaf by leaf, as bit patterns."""
    if isinstance(jp, dict):
        assert sorted(tp) == sorted(jp), what
        for k in jp:
            _payload_equal(tp[k], jp[k], f"{what}/{k}")
        return
    if isinstance(jp, JC.PackedBits):
        assert isinstance(tp, TC.PackedBits) and tp.width == jp.width, what
    got, want = _np(tp), np.asarray(getattr(jp, "data", jp))
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype == np.float32:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", ["bernoulli", "terngrad",
                                  "induced_topk_randk"])
@pytest.mark.parametrize("shape", [(257,), (16, 40), (3, 5, 7)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_matches_reference(name, shape, seed):
    """Payload, decode and ``wire_bits`` bitwise against the reference's
    jitted encode and decode, from the reference's draws; three keys,
    so ``BernoulliP`` both fires and does not."""
    x = _inputs(shape, seed, special=seed == 2)
    key = jax.random.PRNGKey(seed + 10)
    jq, tq = JC.make_compressor(name), TC.make_compressor(name)
    jp, jm = jax.jit(jq.encode)(key, jnp.asarray(x))
    xt = torch.from_numpy(x)
    tp, tm = tq.encode(KeyDraw(key), xt)
    _payload_equal(tp, jp, name)
    jd = jax.jit(lambda p, m: jq.decode(p, m, _jsd(x)))(jp, jm)
    td = tq.decode(tp, tm, ShapeDtype.of(xt))
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))
    assert float(tq.wire_bits(tp)) == float(jq.wire_bits(jp))
    assert TC.aot_wire_bits(tq, shape) == JC.aot_wire_bits(jq, shape)
    assert TC.aot_wire_bits(tq, int(np.prod(shape))) == JC.aot_wire_bits(
        jq, int(np.prod(shape)))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli_bits_live_stacked_and_expected(p):
    """``BernoulliP`` charges a live payload what it carries -- W
    worker payloads (the port's list, the reference's vmapped stack)
    their fired messages plus one flag bit each -- and quotes the
    expectation ahead of time; the draw is the reference's Bernoulli."""
    w, shape = 6, (4, 33)
    x = np.stack([_inputs(shape, j) for j in range(w)])
    keys = jax.random.split(jax.random.PRNGKey(int(p * 10)), w)
    jq, tq = JC.BernoulliP(p=p), TC.BernoulliP(p=p)
    jp, _ = jax.jit(jax.vmap(jq.encode))(keys, jnp.asarray(x))
    tps = [tq.encode(KeyDraw(k), torch.from_numpy(x[j]))[0]
           for j, k in enumerate(keys)]
    fired = [bool(t["sent"]) for t in tps]
    assert fired == list(np.asarray(jp["sent"]))
    got = tq.wire_bits(tps)
    assert got.dtype == torch.float32
    assert got.item() == float(jax.jit(jq.wire_bits)(jp)) == (
        sum(fired) * 32 * 132 + w)
    like = ShapeDtype(shape, torch.float32, torch.device("meta"))
    assert tq.wire_bits([tq.payload_like(like)] * w) == jq.wire_bits(
        jax.eval_shape(jax.vmap(jq.encode), jax.ShapeDtypeStruct(
            (w, 2), jnp.uint32), jax.ShapeDtypeStruct((w, *shape),
                                                      jnp.float32))[0])
    assert TC.aot_wire_bits(tq, shape) == JC.aot_wire_bits(jq, shape) == (
        p * 32 * 132 + 1)
    assert tq.omega(10) == jq.omega(10)


def _xla_off(y, s):
    """Where XLA's level index ``clip(floor(-log2(max(y, 1e-38))), 0,
    s - 1)`` (jitted, the reference's expression) differs from the
    exact one, or its ``exp2`` of the index or of the index + 1 is not
    the power of two: the elements whose code may differ."""
    y = np.asarray(y, F32)
    m, e = np.frexp(y)
    exact = np.clip(np.where(y > 0, -(e - 1) - (m != 0.5), s - 1), 0, s - 1)
    xla = np.asarray(jax.jit(lambda y: jnp.clip(jnp.floor(-jnp.log2(
        jnp.maximum(y, 1e-38))), 0, s - 1))(jnp.asarray(y)))
    ex = jax.jit(lambda j: (jnp.exp2(-j), jnp.exp2(-(j + 1.0))))
    hi, lo = (np.asarray(a) for a in ex(jnp.asarray(exact.astype(F32))))
    return ((xla != exact) | (hi != np.ldexp(F32(1), -exact))
            | (lo != np.ldexp(F32(1), -exact - 1)))


def _xla_exp2_exact(codes):
    """Where the reference's decode level ``exp2(-(code - 1))`` is the
    power of two (code 0 decodes to 0 on both sides)."""
    c = np.asarray(codes, F32)
    got = np.asarray(jax.jit(lambda c: jnp.exp2(-(c - 1.0)))(jnp.asarray(c)))
    return (c == 0) | (got == np.ldexp(F32(1), -(c.astype(int) - 1)))


@pytest.mark.parametrize("s", [8, 3, 16])
@pytest.mark.parametrize("shape", [(257,), (16, 40), (3, 5, 7)])
@pytest.mark.parametrize("special", [False, True])
def test_natural_dithering_matches_reference(s, shape, special):
    """Given the reference's norm the payload is bitwise wherever XLA's
    level index and levels are exact (the port reads them from bits; at
    s = 8 and 3 that is every element), and the decode wherever XLA's
    ``exp2`` of the code is; the port's own norm within an ulp-scale
    1e-6; bits equal."""
    x = _inputs(shape, s, special)
    key = jax.random.PRNGKey(s)
    jq, tq = JC.NaturalDithering(s=s), TC.make_compressor(
        "natural_dithering", s=s)
    jp, _ = jax.jit(jq.encode)(key, jnp.asarray(x))
    xt = torch.from_numpy(x)
    norm = torch.tensor(np.asarray(jp["norm"]))
    tp, _ = tq.encode_with_norm(KeyDraw(key), xt, norm)
    y = np.asarray(jax.jit(lambda x, n: jnp.abs(x) / n)(jnp.asarray(x),
                                                         jp["norm"]))
    off = _xla_off(y, s)
    if s < 13:
        assert not off.any()
    got, want = _np(tp["code"]), np.asarray(jp["code"].data)
    assert tp["code"].width == jp["code"].width
    np.testing.assert_array_equal(got[~off], want[~off])
    _payload_equal(tp["sign"], jp["sign"], "sign")
    _payload_equal(tp["norm"], jp["norm"], "norm")
    own, _ = tq.encode(KeyDraw(key), xt)
    np.testing.assert_allclose(own["norm"].item(), float(jp["norm"]),
                               rtol=1e-6)
    jd = np.asarray(jax.jit(lambda p: jq.decode(p, {}, _jsd(x)))(jp))
    ref_payload = {"code": TC.PackedBits(torch.from_numpy(want.copy()),
                                         tp["code"].width),
                   "sign": tp["sign"], "norm": norm}
    td = tq.decode(ref_payload, {}, ShapeDtype.of(xt)).numpy()
    same = _xla_exp2_exact(want)
    np.testing.assert_array_equal(_bits(td[same]), _bits(jd[same]))
    assert tq.wire_bits(tp) == jq.wire_bits(jp) == TC.aot_wire_bits(
        tq, shape) == JC.aot_wire_bits(jq, shape)
    assert tq.omega(1000) == jq.omega(1000)


def test_natural_dithering_floor_difference_near_powers_of_two(monkeypatch):
    """The known difference: x = [1, t...] with t^2 below half an ulp of
    1 has norm exactly 1, so y = t; at t = 2^-j and the floats beside it
    (j = 12..15, s = 16) XLA's ``floor(-log2 y)`` and ``exp2`` are off
    at some j.  With u = 0 (the reference's uniform replaced: a draw of
    probability 2^-23) a level index that differs shows as a code one
    apart; every other code is equal, and the port's codes are the exact
    lattice's."""
    ts = []
    for j in range(12, 16):
        p = F32(2.0 ** -j)
        ts += [p, np.nextafter(p, F32(0)), np.nextafter(p, F32(1))]
    x = np.array([1.0] + ts, F32)
    s = 16
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.zeros(shape))
    jp, _ = jax.jit(JC.NaturalDithering(s=s).encode)(jax.random.PRNGKey(0),
                                                     jnp.asarray(x))
    monkeypatch.undo()
    assert float(jp["norm"]) == 1.0
    tp, _ = TC.NaturalDithering(s=s).encode(
        lambda shape: torch.zeros(shape), torch.from_numpy(x))
    got, want = _np(tp["code"]), np.asarray(jp["code"].data)
    # the exact lattice: y = t, j = floor(-log2 t) exactly, u = 0 takes
    # the upper level wherever y is above the lower one
    m, e = np.frexp(x)
    j = np.clip(-(e - 1) - (m != 0.5), 0, s - 1)
    lo = np.where(j >= s - 1, 0.0, np.ldexp(1.0, -(j + 1)))
    exact = np.where(x - lo > 0, j + 1, np.where(j >= s - 1, 0, j + 2))
    np.testing.assert_array_equal(got, exact)
    off = _xla_off(x, s)
    assert off.any()
    np.testing.assert_array_equal(got[~off], want[~off])
    assert (got != want).any() and ((got != want) <= off).all()
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()


@pytest.mark.parametrize("shape", [(257,), (16, 40)])
def test_induced_natural_matches_reference(shape):
    """``induced_topk_natural``: C's payload (top-k) bitwise; Q's (the
    natural codec on x - C(x)) wherever XLA's ``exp2`` is exact at the
    element's exponent (queue 3, items 4-5; on these inputs every
    element); the parts' bits add."""
    x = _inputs(shape, 4)
    key = jax.random.PRNGKey(4)
    jq, tq = (JC.make_compressor("induced_topk_natural"),
              TC.make_compressor("induced_topk_natural"))
    jp, jm = jax.jit(jq.encode)(key, jnp.asarray(x))
    xt = torch.from_numpy(x)
    tp, tm = tq.encode(KeyDraw(key), xt)
    _payload_equal(tp["c"], jp["c"], "c")
    _payload_equal(tp["q"], jp["q"], "q")
    td = tq.decode(tp, tm, ShapeDtype.of(xt))
    jd = jax.jit(lambda p, m: jq.decode(p, m, _jsd(x)))(jp, jm)
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))
    assert tq.wire_bits(tp) == jq.wire_bits(jp) == TC.aot_wire_bits(
        tq, shape) == JC.aot_wire_bits(jq, shape)
    assert tq.omega(100) == jq.omega(100)


@pytest.mark.parametrize("name", ["bernoulli", "induced_topk_randk"])
def test_diana_round_with_new_codec_bitwise(name):
    """DIANA's round on the parameter server with the codec as its Q,
    jitted in the reference: ``g_bar``, ``h``, ``h_bar`` and ``bits``
    bitwise, the draws replayed by address (the induced codec's parts as
    ``"q/c"`` and ``"q/q"``)."""
    w = 4
    shapes = {"a": (40,), "b": (6, 9)}
    rng = np.random.default_rng(3)
    g = {k: (rng.standard_normal((w, *s)) * 0.02).astype(F32)
         for k, s in shapes.items()}
    h = {k: (0.5 * v[::-1]).astype(F32) for k, v in g.items()}
    hb = {k: np.asarray(v.mean(0), F32) for k, v in h.items()}
    key = jax.random.PRNGKey(5)
    jq = JC.make_compressor(name)
    ref = jax.jit(lambda k, g, h, hb: jax_rule("diana", alpha=0.125).round(
        jq, k, g, h, hb, JaxSim()))(key, g, h, hb)
    k_msg = jax.random.split(key, 3)[0]
    draws = {}
    for i in range(len(shapes)):
        _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
        for j, wk in enumerate(jax.random.split(kq, w)):
            draws[(i, j)] = KeyDraw(wk)

    class Replay:
        def uniform(self, leaf, worker, shape, part=None):
            return self._draw(leaf, worker, part)(shape)

        def permutation(self, leaf, worker, d, part=None):
            return self._draw(leaf, worker, part).permutation(d)

        @staticmethod
        def _draw(leaf, worker, part):
            d = draws[(leaf, worker)]
            for p in part.split("/")[1:]:
                d = d.part_of(p)
            return d

    t = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    th = {k: torch.from_numpy(v.copy()) for k, v in h.items()}
    thb = {k: torch.from_numpy(v.copy()) for k, v in hb.items()}
    got = make_shift_rule("diana", alpha=0.125).round(
        TC.make_compressor(name), Replay(), t, th, thb, SimChannel())
    assert got[3].item() == float(ref[3])
    for a, b in zip(got[:3], ref[:3]):
        for k in shapes:
            np.testing.assert_array_equal(_bits(a[k].numpy()), _bits(b[k]))


def test_two_part_draws_are_parts_of_one_address():
    """``Induced``'s C and Q draw from parts ``"c"`` and ``"q"`` of the
    address its caller hands it (under DIANA's Q part: ``"q/c"``,
    ``"q/q"``); a shared draw hands every worker the same parts."""
    from repro_torch.comm.wire import worker_draws

    seen = []

    class Spy(AddressedNoise):
        def permutation(self, leaf, worker, d, part=None):
            seen.append((leaf, worker, part))
            return super().permutation(leaf, worker, d, part)

    q = TC.make_compressor("induced_topk_randk", q=0.2)
    noise = Spy(0, "cpu")
    q.encode(LeafNoise(noise, 3, "q").worker(1), torch.randn(50))
    assert seen == [(3, 1, "q/q")]
    shared = worker_draws(TC.RandK(0.2, shared_pattern=True),
                          LeafNoise(noise, 2), 3)
    a = shared[0].part_of("q").permutation(10)
    b = shared[2].part_of("q").permutation(10)
    assert torch.equal(a, b) and seen[-1] == (2, None, "q")
    assert len(seen) == 2


def test_tree_helpers_match_reference():
    """``shifted`` is h + Q(x - h); ``tree_compress`` and
    ``tree_shifted_compress`` draw leaf i at address (i, no worker),
    the reference's ``fold_in(key, i)`` (``leaf_keys``); mismatched
    trees raise; ``aot_wire_bits``, ``tree_bits`` and ``tree_size`` as
    the reference's."""
    tree = {"a": torch.randn(40), "b": torch.randn(6, 9), "c": torch.randn(())}
    shift = {k: v * 0.5 for k, v in tree.items()}
    q = TC.TernGrad()
    noise = AddressedNoise(3, "cpu")
    out = TC.tree_shifted_compress(q, noise, tree, shift)
    for i, (k, x) in enumerate(tree.items()):
        rand = LeafNoise(noise, i).worker(None)
        assert torch.equal(out[k], TC.shifted(q, shift[k], rand, x))
        assert torch.equal(out[k], shift[k] + q(rand, x - shift[k]))
    plain = TC.tree_compress(q, noise, tree)
    assert list(plain) == list(tree)
    assert [(r.leaf, r.worker) for r in TC.leaf_keys(noise, tree)] == [
        (0, None), (1, None), (2, None)]
    with pytest.raises(ValueError, match="structure"):
        TC.tree_shifted_compress(q, noise, tree, {"b": shift["b"],
                                                  "a": shift["a"],
                                                  "c": shift["c"]})
    jtree = {k: jnp.zeros(v.shape) for k, v in tree.items()}
    for name in NEW + ("natural", "topk", "randk", "int8", "sign"):
        jq, tq = JC.make_compressor(name), TC.make_compressor(name)
        assert TC.tree_bits(tq, tree) == JC.tree_bits(jq, jtree), name
        for shape in [7, (3, 5), ()]:
            assert TC.aot_wire_bits(tq, shape) == JC.aot_wire_bits(
                jq, shape), (name, shape)
    assert TC.tree_size(tree) == JC.tree_size(jtree) == 95


@pytest.mark.parametrize("name", NEW)
def test_new_codecs_unbiased(name):
    """The unbiased codecs average to x over many draws (the induced
    ones: C(x) + Q's unbiased residual)."""
    x = torch.tensor([0.3, -1.7, 5.0, 0.011, 0.0, 2.5] * 8)
    q = TC.make_compressor(name, **({"p": 0.5} if name == "bernoulli"
                                    else {}))
    noise = AddressedNoise(0, "cpu")
    outs = torch.stack([q(LeafNoise(noise.at_round(r), 0).worker(None), x)
                        for r in range(2000)])
    np.testing.assert_allclose(outs.mean(0).numpy(), x.numpy(), rtol=0.15,
                               atol=0.15)
