"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro/models/moe.py``, on the qwen2-moe-a2.7b smoke config
(d 128, 4 experts, top-2, one shared expert) in float32.

* ``route``: the dispatch (which token goes to which expert slot) is
  discrete and compares bitwise on inputs whose router logits both sides
  compute exactly (integers times 2^-6); the gates and the aux loss come
  out of the softmax, whose ``exp`` differs between XLA and torch in the
  last bit, so they agree within a few f32 ulps (``GATE_TOL``).  Ties
  break toward the lower expert index on both sides.
* ``moe_apply`` with one group and with several zero-padded groups, with
  and without the shared experts, on random inputs: outputs within
  RTOL of their scale, aux within RTOL; every token's expert choice the
  reference's (a flipped choice is counted and reported).
* The moe wire (``Int8Stochastic``, uniforms replayed by address):
  the dispatched buffer is a copy of token rows, so its send and its EF
  residual compare bitwise; the combine buffer comes out of the expert
  matmuls and compares within its quantization step.  The backward pass
  through a send is straight through.
"""

import jax
import numpy as np
import pytest
import torch

from repro.comm.channel import SimChannel as JaxSim
from repro.comm.transport import Wire as JaxWire
from repro.configs import get_smoke_config as jax_smoke
from repro.core.compressors import Int8Stochastic as JaxInt8
from repro.models import moe as JMOE
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.transport import SendDraw, Wire
from repro_torch.configs import get_smoke_config
from repro_torch.core.compressors import Int8Stochastic
from repro_torch.models import moe as TMOE

RTOL = 1e-5
#: gates and aux: a few f32 ulps of the softmax
GATE_TOL = 4e-7
ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _cfgs(**kw):
    return (jax_smoke(ARCH).with_(dtype="float32", **kw),
            get_smoke_config(ARCH).with_(dtype="float32", **kw))


def _moe_params(cfg, seed=0):
    """The reference's init of one MoE FFN, as numpy (nested) and as the
    port's flat dict."""
    pj = jax.tree_util.tree_map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(seed), cfg))
    flat = {}
    for k, v in pj.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": torch.from_numpy(vv.copy())
                         for kk, vv in v.items()})
        else:
            flat[k] = torch.from_numpy(v.copy())
    return pj, flat


class SendReplay:
    """A wire stream replaying the reference's send uniforms by address
    ``(layer, worker, group, part)``; each may be taken once."""

    def __init__(self, table):
        self.table = dict(table)

    def send_uniform(self, address, shape):
        u = self.table.pop(address)
        assert u.shape == tuple(shape), (address, u.shape, shape)
        return torch.from_numpy(np.array(u, np.float32))


def test_port_specs_are_the_reference_init():
    cfg_j, cfg_t = _cfgs()
    pj, pt = _moe_params(cfg_j)
    assert {k: tuple(v.shape) for k, v in pt.items()} == {
        p: s for p, s, _ in TMOE.moe_specs(cfg_t)}
    assert pt["router"].dtype == torch.float32
    for n in (1, 7, 64, 512, 4096):
        assert TMOE._capacity(n, cfg_t) == JMOE._capacity(n, cfg_j)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vj, ij = jax.lax.top_k(probs, 2)
    vt, it = TMOE.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("n", [6, 40])
def test_route_matches_reference(n):
    """Exact router logits: the dispatch bitwise (at n = 40, capacity
    factor 0.5, capacity 16 drops tokens), the gates and aux within
    GATE_TOL."""
    cfg_j, cfg_t = _cfgs(capacity_factor=1.25 if n == 6 else 0.5)
    rng = np.random.default_rng(n)
    x = rng.integers(-4, 5, (n, cfg_j.d_model)).astype(np.float32)
    router = (rng.integers(-8, 9, (cfg_j.d_model, cfg_j.n_experts))
              / 64).astype(np.float32)
    dj, cj, aj = jax.jit(lambda p, x: JMOE.route(p, x, cfg_j))(
        {"router": router}, x)
    dt, ct, at = TMOE.route({"router": torch.from_numpy(router)},
                            torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    if n == 40:      # 40 tokens x 2 slots over 4 experts of 16 slots
        assert dt.sum() < n * cfg_t.experts_per_token
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=GATE_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=GATE_TOL)


def _choices(dispatch):
    """Each token's set of experts, from a (N, E, C) dispatch."""
    return np.asarray(dispatch).sum(-1) > 0


@pytest.mark.parametrize("shared", [1, 0])
@pytest.mark.parametrize("b,s,group", [(2, 8, 4096), (2, 11, 8)])
def test_moe_apply_matches_reference(b, s, group, shared):
    """One group (16 tokens) and three groups of 8 over 22 tokens, the
    last padded by two zero rows that route and take capacity; with and
    without the shared expert."""
    cfg_j, cfg_t = _cfgs(moe_group_size=group, n_shared_experts=shared)
    pj, pt = _moe_params(cfg_j, seed=3)
    x = (np.random.default_rng(b * s).standard_normal(
        (b, s, cfg_j.d_model))).astype(np.float32)
    yj, aj = jax.jit(lambda p, x: JMOE.moe_apply(p, x, cfg_j))(pj, x)
    yt, at = TMOE.moe_apply(pt, torch.from_numpy(x), cfg_t)
    assert ("shared/w_up" in pt) == bool(shared)
    # every token's expert choice (the reference's routing of the flat
    # tokens with the port's): a flipped choice is reported
    xf = x.reshape(-1, cfg_j.d_model)
    flips = int((_choices(JMOE.route(pj, xf[:8], cfg_j)[0])
                 != _choices(TMOE.route(pt, torch.from_numpy(xf[:8]),
                                        cfg_t)[0])).any(-1).sum())
    assert flips == 0, f"{flips} tokens routed otherwise"
    scale = np.abs(np.asarray(yj)).max()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=RTOL * scale)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


def _wire_draws(key, group_shape, n_groups, fold=True):
    """The reference's send uniforms of one moe layer keyed ``key``:
    group ``gi`` folds ``gi`` in (``moe_apply``; not ``_moe_group``
    alone, ``fold=False``), then splits into dispatch and combine; as
    the port's addresses (layer 0, worker 0)."""
    out = {}
    for gi in range(n_groups):
        kd, kc = jax.random.split(jax.random.fold_in(key, gi) if fold
                                  else key)
        for part, k in (("dispatch", kd), ("combine", kc)):
            out[(0, 0, gi, part)] = np.asarray(
                jax.random.uniform(k, group_shape))
    return out


def test_wired_group_sends_and_shift():
    """``_moe_group`` with the moe wire and a nonzero EF pair: the
    dispatched buffer's send and residual bitwise, the combine residual
    within one quantization step of the reference's, the output within
    RTOL of its scale."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _moe_params(cfg_j, seed=5)
    rng = np.random.default_rng(11)
    n = 12
    xf = rng.standard_normal((n, cfg_j.d_model)).astype(np.float32)
    c = JMOE._capacity(n, cfg_j)
    shape = (cfg_j.n_experts, c, cfg_j.d_model)
    e0 = tuple((rng.standard_normal(shape) * 1e-3).astype(np.float32)
               for _ in range(2))
    key = jax.random.PRNGKey(4)
    jw = JaxWire(name="moe", topology="all_to_all", codec=JaxInt8(),
                 channel=JaxSim())
    yj, aj, (edj, ecj) = jax.jit(lambda p, x, k, e: JMOE._moe_group(
        p, x, cfg_j, wire=jw, key=k, shift=e))(pj, xf, key, e0)
    src = SendReplay(_wire_draws(key, shape, 1, fold=False))
    tw = Wire(name="moe", topology="all_to_all", codec=Int8Stochastic(),
              channel=SimChannel())
    yt, at, (edt, ect) = TMOE._moe_group(
        pt, torch.from_numpy(xf), cfg_t, wire=tw,
        draw=lambda part: SendDraw(src, (0, 0, 0, part)),
        shift=tuple(torch.from_numpy(e.copy()) for e in e0))
    assert not src.table                       # both sends drew once
    np.testing.assert_array_equal(_bits(edt.numpy()), _bits(edj))
    step = np.abs(np.asarray(ecj)).max() * 2 / 127 + 1e-6
    np.testing.assert_allclose(ect.numpy(), np.asarray(ecj), rtol=0,
                               atol=step)
    scale = np.abs(np.asarray(yj)).max()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=RTOL * scale + step)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


def test_wired_moe_apply_threads_the_shift_over_groups():
    """Three groups on the wire: the replay hands out each group's two
    draws once (the group's address), and the port's output tracks the
    reference's within the combine's quantization step."""
    cfg_j, cfg_t = _cfgs(moe_group_size=8)
    pj, pt = _moe_params(cfg_j, seed=6)
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg_j.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jw = JaxWire(name="moe", topology="all_to_all", codec=JaxInt8(),
                 channel=JaxSim())
    yj, aj = jax.jit(lambda p, x, k: JMOE.moe_apply(
        p, x, cfg_j, wire=jw, key=k))(pj, x, key)
    shape = (cfg_j.n_experts, JMOE._capacity(8, cfg_j), cfg_j.d_model)
    src = SendReplay(_wire_draws(key, shape, 3))
    tw = Wire(name="moe", topology="all_to_all", codec=Int8Stochastic(),
              channel=SimChannel())
    yt, at = TMOE.moe_apply(
        pt, torch.from_numpy(x), cfg_t, wire=tw,
        draw=lambda g, part: SendDraw(src, (0, 0, g, part)))
    assert not src.table
    scale = np.abs(np.asarray(yj)).max()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=4 * scale / 127)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


def test_send_is_straight_through():
    """The gradient through ``Wire.send`` is the identity: the gradient
    of ``sum(w * y)`` with respect to ``x`` is ``w``, and the moe
    layer's input gradient with the wire on is the reference's."""
    x = torch.randn(4, 6, dtype=torch.float64).to(torch.float32)
    x.requires_grad_(True)
    w = torch.randn(4, 6)
    tw = Wire(name="act", topology="p2p", codec=Int8Stochastic(),
              channel=SimChannel())
    src = SendReplay({(0, 0, None, None): np.full((4, 6), 0.5, np.float32)})
    y, e = tw.send(SendDraw(src, (0, 0, None, None)), x, torch.zeros(4, 6))
    assert not e.requires_grad
    (g,) = torch.autograd.grad((w * y).sum(), x)
    assert torch.equal(g, w)

    cfg_j, cfg_t = _cfgs()
    pj, pt = _moe_params(cfg_j, seed=8)
    xb = np.random.default_rng(3).standard_normal(
        (1, 6, cfg_j.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jw = JaxWire(name="moe", topology="all_to_all", codec=JaxInt8(),
                 channel=JaxSim())
    gj = jax.jit(jax.grad(lambda x: JMOE.moe_apply(
        pj, x, cfg_j, wire=jw, key=key)[0].sum()))(xb)
    shape = (cfg_j.n_experts, JMOE._capacity(6, cfg_j), cfg_j.d_model)
    src = SendReplay(_wire_draws(key, shape, 1))
    xt = torch.from_numpy(xb).requires_grad_(True)
    yt, _ = TMOE.moe_apply(pt, xt, cfg_t, wire=Wire(
        name="moe", topology="all_to_all", codec=Int8Stochastic(),
        channel=SimChannel()),
        draw=lambda g, part: SendDraw(src, (0, 0, g, part)))
    (gt,) = torch.autograd.grad(yt.sum(), xt)
    scale = np.abs(np.asarray(gj)).max()
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=RTOL * scale)


def test_wire_traffic_matches_reference():
    """``moe_wire_traffic``: the (E, C, D) buffer and 2 sends a group,
    with ``moe_apply``'s group arithmetic."""
    cfg_j, cfg_t = _cfgs(moe_group_size=64)
    for n in (0, 10, 64, 100, 512):
        want = JMOE.moe_wire_traffic(cfg_j, n)
        got = TMOE.moe_wire_traffic(cfg_t, n)
        assert [(tuple(a.shape), c) for a, c in got] == [
            (tuple(a.shape), c) for a, c in want]
