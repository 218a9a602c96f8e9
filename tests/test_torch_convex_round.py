"""Port parity for ONE round of every shift rule of Algorithm 1 and one
update of each compressed-iterate method, BITWISE: the same numpy
inputs (W-stacked gradients, shifts, master shift) go through the
reference's jitted round and the port's, with the reference's draws
replayed along its own key chain (``ReferenceDraws``):

  per step  ``split(state.key)`` (GDCI: a 3-split);
  the round ``Channel.shift_round``'s 3-split (STAR's own 3-split,
            VR-GDCI's 2-split);
  per leaf  ``fold_in(key, leaf)``;
  per part  DIANA's ``split`` into C's key and Q's;
  per worker ``worker_keys`` (one key for every worker when the codec
            is shared or deterministic);

and the codec's own draw with that key (RandK's ``permutation``,
natural's ``uniform``).  Rand-DIANA's refresh is ``bernoulli(k_aux)``,
i.e. ``uniform(k_aux, (W,)) < p``.  The replay source checks that the
port asks for every draw in that order, with the tags of
``repro_torch.comm.wire``.

``g_bar``, the shifts, the master shift, the new iterate and ``bits``
must be equal bit for bit (f32 bit patterns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.wire import worker_keys
from repro.core import compressors as JC
from repro.core import iterate_comp as JI
from repro.core import shift_rules as JS
from repro_torch.core import compressors as TC
from repro_torch.core import iterate_comp as TI
from repro_torch.core import shift_rules as TS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32
W = 10
SHAPES = {"a": (80,), "b": (7,)}          # two leaves, the reference's order


# -- the reference's draws -------------------------------------------------


def _codec_draw(codec, key, shape):
    """The draw a reference codec makes with its worker key, and the
    port's name for it."""
    if isinstance(codec, JC.RandK):
        return "permutation", jax.random.permutation(key, int(np.prod(shape)))
    if isinstance(codec, JC.NaturalCompression):
        return "uniform", jax.random.uniform(key, shape)
    raise NotImplementedError(type(codec).__name__)


def _leaf_draws(codec, key, shape, w, leaf, part):
    """(tag, array) of one leaf's message part: ``worker_keys``' rule."""
    if not codec.stochastic:
        return []
    if getattr(codec, "shared_pattern", False):
        kind, a = _codec_draw(codec, key, shape)
        return [((kind, leaf, None, part), a)]
    out = []
    for j, wk in enumerate(worker_keys(codec, key, w)):
        kind, a = _codec_draw(codec, wk, shape)
        out.append(((kind, leaf, j, part), a))
    return out


def round_draws(kind, key, shapes, w, q, c=None):
    """The draws of one round at round key ``key``, in the reference's
    order.  ``kind``: ``shift`` (Channel.shift_round), ``diana``
    (two-part message), ``rand_diana``, ``star``, ``gdci`` (one uplink
    with the key as it is), ``vr_gdci`` (the round's 2-split first)."""
    out = []
    if kind == "star":
        kq, kc, _ = jax.random.split(key, 3)
        for part, codec, k in (("q", q, kq), ("c", c, kc)):
            for i, shape in enumerate(shapes):
                out += _leaf_draws(codec, jax.random.fold_in(k, i), shape, w,
                                   i, part)
        return out
    if kind in ("gdci", "vr_gdci"):
        k_msg = key if kind == "gdci" else jax.random.split(key)[0]
        for i, shape in enumerate(shapes):
            out += _leaf_draws(q, jax.random.fold_in(k_msg, i), shape, w, i,
                               None)
        return out
    k_msg, k_aux, _ = jax.random.split(key, 3)
    for i, shape in enumerate(shapes):
        lk = jax.random.fold_in(k_msg, i)
        if kind == "diana":
            kc, kq = jax.random.split(lk)
            out += _leaf_draws(c, kc, shape, w, i, "c")
            out += _leaf_draws(q, kq, shape, w, i, "q")
        else:
            out += _leaf_draws(q, lk, shape, w, i, None)
    if kind == "rand_diana":
        out.append((("aux", None, None, None),
                    jax.random.uniform(k_aux, (w,))))
    return out


def step_keys(seed, steps, kind):
    """The round key of each of ``steps`` steps from ``PRNGKey(seed)``:
    ``key, sub = split(key)`` (GDCI: ``key, sub, _ = split(key, 3)``)."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        ks = jax.random.split(key, 3 if kind == "gdci" else 2)
        key = ks[0]
        subs.append(ks[1])
    return jnp.stack(subs)


def trace_draws(kind, seed, steps, shapes, w, q, c=None):
    """Every draw of ``steps`` steps, in order: the per-round draws
    vmapped over the step keys (eagerly: each primitive is compiled once
    for the whole suite, where a jit of this closure would compile anew
    on every call)."""
    tags = [t for t, _ in round_draws(kind, jax.random.PRNGKey(0), shapes, w,
                                      q, c)]
    arrays = [np.asarray(a) for a in jax.vmap(lambda k: [a for _, a in
              round_draws(kind, k, shapes, w, q, c)])(
                  step_keys(seed, steps, kind))]
    return [(t, a[s]) for s in range(steps) for t, a in zip(tags, arrays)]


class ReplayNoise:
    """The port's noise source replaying the reference's draws, checking
    that each is asked for in the reference's order with the port's
    tags (``repro_torch.comm.wire``)."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.at = 0

    def _pop(self, tag):
        want, a = self.draws[self.at]
        assert tag == want, f"draw {self.at}: asked {tag}, reference {want}"
        self.at += 1
        return np.asarray(a)

    def uniform(self, leaf, worker, shape, part=None):
        a = self._pop(("uniform", leaf, worker, part))
        assert a.shape == tuple(shape)
        return torch.from_numpy(np.array(a, F32))

    def permutation(self, leaf, worker, d, part=None):
        a = self._pop(("permutation", leaf, worker, part))
        assert a.shape == (d,)
        return torch.from_numpy(a.astype(np.int64))

    def aux_uniform(self, shape):
        a = self._pop(("aux", None, None, None))
        assert a.shape == tuple(shape)
        return torch.from_numpy(np.array(a, F32))

    def next_round(self):
        """A training step ends its round; the replay goes on in order."""

    @property
    def done(self):
        return self.at == len(self.draws)


# -- helpers -----------------------------------------------------------------


def bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, F32))
    b = np.ascontiguousarray(np.asarray(b, F32))
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def assert_tree_bitwise(ref, port, what):
    assert list(ref) == list(port), what
    for k in ref:
        assert bits_equal(ref[k], port[k]), f"{what}[{k}]"


def _t(tree):
    return {k: torch.from_numpy(np.array(v, F32)) for k, v in tree.items()}


def inputs(seed, w=W, shapes=SHAPES):
    """W-stacked gradients, shifts and a master shift from one seed."""
    rng = np.random.default_rng(seed)

    def tree(lead, scale):
        return {k: (rng.standard_normal(lead + s) * scale).astype(F32)
                for k, s in shapes.items()}

    return tree((w,), 3.0), tree((w,), 1.0), tree((), 0.5)


Q = (JC.RandK(0.25), TC.RandK(0.25))
TOPK = (JC.TopK(0.25), TC.TopK(0.25))
NAT = (JC.NaturalCompression(), TC.NaturalCompression())

ROUNDS = {
    # name: (draw kind, (ref rule, port rule), (ref q, port q))
    "fixed": ("shift", (JS.FixedShift(), TS.FixedShift()), Q),
    "diana": ("diana", (JS.DianaShift(alpha=0.3), TS.DianaShift(alpha=0.3)),
              Q),
    "diana_natural": ("diana", (JS.DianaShift(alpha=0.3),
                                TS.DianaShift(alpha=0.3)), NAT),
    "diana_topk": ("diana", (JS.DianaShift(alpha=0.3, c=JC.TopK(0.25)),
                             TS.DianaShift(alpha=0.3, c=TC.TopK(0.25))), Q),
    "rand_diana": ("rand_diana", (JS.RandDianaShift(p=0.5),
                                  TS.RandDianaShift(p=0.5)), Q),
    "ef21": ("shift", (JS.EF21Shift(), TS.EF21Shift()), TOPK),
    "efbv": ("shift", (JS.EFBVShift(eta=0.3, nu=0.7),
                       TS.EFBVShift(eta=0.3, nu=0.7)), Q),
}


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_shift_round_bitwise(name):
    kind, (jrule, trule), (jq, tq) = ROUNDS[name]
    wg, h, hb = inputs(1)
    if not jrule.stateful:
        h = hb = None
    key = jax.random.PRNGKey(11)
    g_bar, h1, hb1, bits = jax.jit(
        lambda k, g, s, sb: jrule.round(jq, k, g, s, sb))(key, wg, h, hb)
    c = getattr(jrule, "c", None)
    noise = ReplayNoise(round_draws(kind, key, list(SHAPES.values()), W, jq,
                                    c))
    tg, th, thb, tbits = trule.round(tq, noise, _t(wg),
                                     None if h is None else _t(h),
                                     None if hb is None else _t(hb))
    assert noise.done
    assert_tree_bitwise(g_bar, tg, "g_bar")
    if h is not None:
        assert_tree_bitwise(h1, th, "h")
        assert_tree_bitwise(hb1, thb, "h_bar")
    assert float(bits) == tbits.item()
    assert tbits.dtype == torch.float32


def test_rand_diana_refreshes_some_workers():
    """The round above is not vacuous: with p = 0.5 the draw refreshes
    some workers and keeps others, and the refresh cost is charged."""
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(jax.random.split(key, 3)[1], (W,)))
    n = int((u < np.float32(0.5)).sum())
    assert 0 < n < W
    wg, h, hb = inputs(1)
    rule = TS.RandDianaShift(p=0.5)
    noise = ReplayNoise(round_draws("rand_diana", key, list(SHAPES.values()),
                                    W, Q[0]))
    h0 = _t(h)
    _, th, _, bits = rule.round(Q[1], noise, _t(wg), h0, _t(hb))
    kept = [torch.equal(th["a"][j], torch.from_numpy(h["a"][j]))
            for j in range(W)]
    assert sum(kept) == W - n
    dense = sum(32 * int(np.prod(s)) for s in SHAPES.values())
    assert TS.dense_message_bits(_t(wg)) == float(dense)
    q_bits = sum(W * TC._k_of(0.25, int(np.prod(s)))
                 * (32 + TC._index_bits(int(np.prod(s))))
                 for s in SHAPES.values())
    assert bits.item() == float(np.float32(q_bits) + np.float32(n * dense))


@pytest.mark.parametrize("c", ["zero", "topk"])
def test_star_round_bitwise(c):
    jc, tc = ((JC.Zero(), TC.Zero()) if c == "zero" else TOPK)
    wg, star, _ = inputs(2)
    _, h, _ = inputs(3)
    jrule, trule = JS.StarShift(c=jc), TS.StarShift(c=tc)
    key = jax.random.PRNGKey(5)
    state = {"h": h, "star": star}
    g_bar, st1, hb1, bits = jax.jit(
        lambda k, g, s: jrule.round(Q[0], k, g, s, None))(key, wg, state)
    noise = ReplayNoise(round_draws("star", key, list(SHAPES.values()), W,
                                    Q[0], jc))
    tg, tst, thb, tbits = trule.round(Q[1], noise, _t(wg),
                                      {"h": _t(h), "star": _t(star)}, None)
    assert noise.done and hb1 is None and thb is None
    assert_tree_bitwise(g_bar, tg, "g_bar")
    assert_tree_bitwise(st1["h"], tst["h"], "h")
    assert_tree_bitwise(st1["star"], tst["star"], "star")
    assert float(bits) == tbits.item()


def test_star_init_with_star():
    wg, _, _ = inputs(4)
    st = TS.StarShift().init_with_star(_t(wg))
    assert set(st) == {"h", "star"}
    assert all(torch.equal(st["h"][k], st["star"][k]) for k in wg)
    with pytest.raises(ValueError, match="init_with_star"):
        TS.StarShift().init({"a": torch.zeros(3)}, 2)


def test_gdci_update_bitwise():
    wg, _, hb = inputs(5)
    params = hb
    jm = JI.GDCI(q=Q[0], gamma=0.05, eta=0.4)
    tm = TI.GDCI(q=Q[1], gamma=0.05, eta=0.4)
    st = jm.init(params, seed=3)
    new, st1 = jax.jit(jm.update)(params, st, wg)
    noise = ReplayNoise(trace_draws("gdci", 3, 1, list(SHAPES.values()), W,
                                    Q[0]))
    tnew, tst1 = tm.update(_t(params), tm.init(_t(params), noise=noise),
                           _t(wg))
    assert noise.done
    assert_tree_bitwise(new, tnew, "x")
    assert float(st1.bits) == tst1.bits.item() and tst1.step == 1


def test_vr_gdci_update_bitwise():
    wg, _, hb = inputs(6)
    params = hb
    jm = JI.VRGDCI(q=Q[0], gamma=0.05, eta=0.4, alpha=0.3)
    tm = TI.VRGDCI(q=Q[1], gamma=0.05, eta=0.4, alpha=0.3)
    _, h, h_bar = inputs(7)
    st = JI.VRGDCIState(h=h, h_bar=h_bar, key=jax.random.PRNGKey(3),
                        step=jnp.zeros((), jnp.int32),
                        bits=jnp.zeros((), jnp.float32))
    new, st1 = jax.jit(jm.update)(params, st, wg)
    noise = ReplayNoise(trace_draws("vr_gdci", 3, 1, list(SHAPES.values()),
                                    W, Q[0]))
    tst = TI.VRGDCIState(_t(h), _t(h_bar), noise, 0,
                         torch.zeros((), dtype=torch.float32))
    tnew, tst1 = tm.update(_t(params), tst, _t(wg))
    assert noise.done
    assert_tree_bitwise(new, tnew, "x")
    assert_tree_bitwise(st1.h, tst1.h, "h")
    assert_tree_bitwise(st1.h_bar, tst1.h_bar, "h_bar")
    assert float(st1.bits) == tst1.bits.item()


def test_dcgd_estimate_bitwise():
    """``DCGDShift.estimate``: the step's key split, then the round, and
    the cumulative bits (two steps)."""
    from repro.core.algorithms import DCGDShift as JD
    from repro_torch.core.algorithms import DCGDShift as TD

    jd = JD(q=Q[0], rule=JS.DianaShift(alpha=0.3))
    td = TD(q=Q[1], rule=TS.DianaShift(alpha=0.3))
    wg, _, _ = inputs(8)
    st = jd.init(wg, seed=4)
    noise = ReplayNoise(trace_draws("diana", 4, 2, list(SHAPES.values()), W,
                                    Q[0], JC.Zero()))
    tst = td.init(_t(wg), noise=noise)
    est = jax.jit(jd.estimate)
    for _ in range(2):
        g, st = est(st, wg)
        tg, tst = td.estimate(tst, _t(wg))
        assert_tree_bitwise(g, tg, "g_bar")
        assert_tree_bitwise(st.h, tst.h, "h")
        assert_tree_bitwise(st.h_bar, tst.h_bar, "h_bar")
    assert noise.done and tst.step == 2
    assert float(st.bits) == tst.bits.item()


def test_residual_sq_diag_and_dense_bits():
    wg, h, _ = inputs(9)
    ref = JS.residual_sq_diag(wg, h)
    port = TS.residual_sq_diag(_t(wg), _t(h))
    for k in ("grad_sq", "shift_residual_sq"):
        np.testing.assert_allclose(float(ref[k]), port[k].item(), rtol=1e-6)
    ref0, port0 = JS.residual_sq_diag(wg, None), TS.residual_sq_diag(_t(wg),
                                                                    None)
    assert port0["grad_sq"] is port0["shift_residual_sq"]
    np.testing.assert_allclose(float(ref0["grad_sq"]),
                               port0["grad_sq"].item(), rtol=1e-6)
    assert TS.dense_message_bits(_t(wg)) == JS.dense_message_bits(wg)


def test_make_shift_rule_ports_every_rule():
    for name in TS.SHIFT_RULES:
        rule = TS.make_shift_rule(name)
        assert type(rule).__name__ == type(JS.make_shift_rule(name)).__name__
    with pytest.raises(ValueError, match="unknown shift rule"):
        TS.make_shift_rule("nope")


@pytest.mark.parametrize("case", ["random", "ties", "edges"])
def test_topk_stacked_equals_rows(case):
    """TopK's ``encode_decode_stacked`` (the W-stacked uplink's path) is
    bit for bit its rows' ``encode``/``decode`` one by one, the tie rule
    included, and charges the same bits."""
    rng = np.random.default_rng(3)
    w, d = 6, 90
    x = rng.standard_normal((w, d)).astype(F32)
    if case == "ties":
        x = np.round(x * 2).astype(F32)          # many equal magnitudes
        x[1] = 1.0
        x[2, :] = -0.0
    elif case == "edges":
        x[0, :5] = (np.nan, np.inf, -np.inf, 1e-40, -0.0)
        x[3] = 0.0
    codec = TC.TopK(0.2)
    xt = torch.from_numpy(x)
    pay, out = codec.encode_decode_stacked(None, xt)
    like = TC.ShapeDtype((d,), torch.float32, torch.device("cpu"))
    rows = [codec.encode(None, xt[j]) for j in range(w)]
    for j, (p, m) in enumerate(rows):
        assert bits_equal(out[j], codec.decode(p, m, like)), j
        assert (sorted(p["indices"].data.tolist())
                == pay["indices"].data[j].tolist())
    assert codec.wire_bits(pay) == codec.wire_bits([p for p, _ in rows])
