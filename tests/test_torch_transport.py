"""Port parity: the Transport (``repro_torch.comm.transport``) -- its
``grad`` and ``model`` wires, their structural accounting, the model
wire's downlink (``Channel.broadcast``) and its codec ``ScaledSign``.

* ``Wire.wire_bits()`` and ``payload_nbytes()`` equal the reference's
  for the grad wire of every comm mode's aggregation codec and the model
  wire of every codec flag: live at the smoke size (the port's
  broadcast of real params counts the same bits), and ahead of time at
  the FULL qwen3-0.6b size (the reference through ``jax.eval_shape``,
  the port on meta tensors; nothing allocated).
* The grad wire's ``shift_round`` is bitwise ``Channel.shift_round``
  (its noise passes verbatim); every other wire draws from its own
  stream (``AddressedNoise.stream``).
* ``Channel.broadcast`` with the q8 codec bitwise the reference's jitted
  broadcast, the uniforms replayed by address; ``ScaledSign``'s sign
  and payload bitwise, its scale (a mean of |x| summed in another order)
  within 1e-6 relative.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import SimChannel as JaxSim
from repro.comm import build_transport as jax_build
from repro.comm import wire_flag_codec as jax_flag_codec
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.core.compressors import ScaledSign as JaxSign
from repro.models import model as JM
from repro_torch.comm.channel import MeshChannel, SimChannel
from repro_torch.comm.transport import (
    WIRE_CODEC_FLAGS,
    Transport,
    Wire,
    build_transport,
    wire_flag_codec,
    wire_stream,
)
from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import ScaledSign, ShapeDtype
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.model import param_specs
from repro_torch.weights import flatten_tree, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL_FLAGS = [f for f in WIRE_CODEC_FLAGS if f != "none"]
W = 4

#: grad-wire configurations: (comm_mode, compressor, enabled)
GRAD_COMPS = [("dense", "natural", False), ("dense", "natural", True),
              ("sim", "natural", True), ("q8_ring", "natural", True),
              ("q8_ring_fused", "natural", True),
              ("q8_ring_overlap", "natural", True),
              ("ef21", "topk", True), ("efbv", "natural", True),
              ("randk_shared", "natural", True)]


def _like(cfg):
    return {path: ShapeDtype(shape, torch.float32, torch.device("meta"))
            for path, shape, _ in param_specs(cfg)}


def _jax_like(cfg_j):
    return jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _both(arch_cfgs, comp_kw, w=1):
    cfg_j, cfg = arch_cfgs
    jt = jax_build(JaxComp(**comp_kw), cfg_j, JaxSim(), w=w,
                   params_like=_jax_like(cfg_j))
    tt = build_transport(CompressionConfig(**comp_kw), cfg, SimChannel(),
                         w=w, params_like=_like(cfg))
    return jt, tt


@pytest.fixture(scope="module")
def smoke():
    return (jax_smoke("qwen3-0.6b").with_(dtype="float32"),
            get_smoke_config("qwen3-0.6b").with_(dtype="float32"))


@pytest.fixture(scope="module")
def full():
    return (jax_config("qwen3-0.6b").with_(dtype="float32"),
            get_config("qwen3-0.6b").with_(dtype="float32"))


def test_wire_flag_codec_matches_reference():
    for flag in WIRE_CODEC_FLAGS:
        want, got = jax_flag_codec(flag), wire_flag_codec(flag)
        assert type(got).__name__ == type(want).__name__, flag
        assert getattr(got, "q", None) == getattr(want, "q", None)
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire_flag_codec("bogus")


@pytest.mark.parametrize("flag", MODEL_FLAGS)
def test_model_wire_accounting_smoke_live(smoke, flag):
    """The model wire's per-step bits and payload bytes equal the
    reference's at the smoke size, and a live broadcast of real params
    through the wire counts the same bits."""
    jt, tt = _both(smoke, dict(enabled=False, model_wire=flag,
                               publish_every=2))
    assert tt["model"].wire_bits() == jt["model"].wire_bits()
    assert tt["model"].payload_nbytes() == jt["model"].payload_nbytes()
    assert tt.per_wire_bits() == jt.per_wire_bits()
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), smoke[0])))
    _, bits = tt["model"].broadcast(
        wire_stream(AddressedNoise(0, "cpu"), "model"), params)
    assert float(bits) == 2 * tt["model"].wire_bits()


@pytest.mark.parametrize("mode,codec,enabled", GRAD_COMPS)
def test_grad_wire_accounting_smoke(smoke, mode, codec, enabled):
    """The grad wire's accounting codec (``aggregation_wire_codec``) and
    its W-stacked traffic, against the reference's, W = 4."""
    kw = dict(enabled=enabled, comm_mode=mode, compressor=codec,
              model_wire="q8")
    jt, tt = _both(smoke, kw, w=W)
    assert type(tt["grad"].codec).__name__ == type(jt["grad"].codec).__name__
    assert tt["grad"].wire_bits() == jt["grad"].wire_bits()
    assert tt["grad"].payload_nbytes() == jt["grad"].payload_nbytes()


@pytest.mark.parametrize("flag", MODEL_FLAGS)
def test_model_wire_accounting_full_size_aot(full, flag):
    """Full-size qwen3-0.6b, ahead of time: the reference through
    ``jax.eval_shape``, the port on meta tensors.  A publish moves
    2,384,199,680 bytes dense, 670,556,160 natural and 596,049,920 + 13
    f32 scales q8."""
    jt, tt = _both(full, dict(enabled=False, model_wire=flag,
                              publish_every=1))
    got = tt["model"].wire_bits()
    assert got == jt["model"].wire_bits()
    assert tt["model"].payload_nbytes() == jt["model"].payload_nbytes()
    expect = {"dense": 2_384_199_680, "natural": 670_556_160,
              "q8": 596_049_920 + 13 * 4}
    if flag in expect:
        assert got / 8 == expect[flag]


def test_grad_wire_full_size_aot(full):
    jt, tt = _both(full, dict(enabled=True, comm_mode="q8_ring_fused",
                              model_wire="none"), w=W)
    assert tt.names() == jt.names() == ("grad",)
    assert tt["grad"].wire_bits() == jt["grad"].wire_bits()
    assert tt["grad"].payload_nbytes() == jt["grad"].payload_nbytes()


@pytest.mark.parametrize("rule_name,codec", [("diana", "natural"),
                                             ("ef21", "topk"),
                                             ("efbv", "int8")])
def test_grad_wire_shift_round_is_channel_shift_round(smoke, rule_name,
                                                      codec):
    """The grad wire hands its round noise to the rule verbatim: its
    round is bitwise ``Channel.shift_round``'s from the same noise."""
    _, cfg = smoke
    comp = CompressionConfig(compressor=codec, shift_rule=rule_name,
                             comm_mode="dense")
    q, rule = comp.make()
    channel = MeshChannel(mode="dense", mesh=HostMesh())
    tt = build_transport(comp, cfg, channel, rule=rule, msg_codec=q, w=W)
    rng = np.random.default_rng(5)
    shapes = {path: shape for path, shape, _ in param_specs(cfg)}
    g = {k: torch.from_numpy(rng.standard_normal((W, *s)).astype(np.float32))
         for k, s in shapes.items()}
    h = rule.init({k: v[0] for k, v in g.items()}, W)
    hb = rule.init_bar({k: v[0] for k, v in g.items()})

    def clone(t):
        return None if t is None else {k: v.clone() for k, v in t.items()}

    want = channel.shift_round(rule, q, AddressedNoise(3, "cpu"), g,
                               clone(h), clone(hb))
    got = tt["grad"].shift_round(AddressedNoise(3, "cpu"), g, clone(h),
                                 clone(hb))
    for a, b in zip(got[:3], want[:3]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert float(got[3]) == float(want[3])


def test_channel_broadcast_matches_reference(smoke):
    """The q8 downlink of the smoke params: decoded bitwise and bits
    equal the reference's jitted ``Channel.broadcast``, the uniforms
    replayed by the leaf's address; the identity downlink hands back
    the receiver's own copy."""
    cfg_j, _ = smoke
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    key = jax.random.PRNGKey(7)
    dj, bj = jax.jit(lambda k, p: JaxSim().broadcast(
        jax_flag_codec("q8"), k, p))(key, params_j)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))

    class Replay:
        def uniform(self, leaf, worker, shape, part=None):
            assert worker is None
            u = jax.random.uniform(jax.random.fold_in(key, leaf), shape)
            return torch.from_numpy(np.array(u))

    dt, bt = SimChannel().broadcast(wire_flag_codec("q8"), Replay(), params)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, dj))
    for k, v in dt.items():
        np.testing.assert_array_equal(v.numpy().view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    assert float(bt) == float(bj)
    same, _ = SimChannel().broadcast(wire_flag_codec("dense"), Replay(),
                                     params)
    for k, v in same.items():
        assert torch.equal(v, params[k])
        assert v.data_ptr() != params[k].data_ptr()


@pytest.mark.parametrize("shape", [(17,), (4, 33), (2, 3, 64)])
def test_scaled_sign_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, -0.0, np.nan]
    xj = jnp.asarray(x)
    jp, _ = JaxSign().encode(jax.random.PRNGKey(0), xj)
    tp, _ = ScaledSign().encode(None, torch.from_numpy(x))
    np.testing.assert_array_equal(tp["sign"].data.numpy(),
                                  np.asarray(jp["sign"].data))
    assert tp["sign"].width == jp["sign"].width == 1
    assert ScaledSign().wire_bits(tp) == JaxSign().wire_bits(jp)
    if np.isnan(x).any():
        assert np.isnan(tp["scale"].item()) and np.isnan(float(jp["scale"]))
        return
    np.testing.assert_allclose(tp["scale"].item(), float(jp["scale"]),
                               rtol=1e-6)


def test_scaled_sign_decode_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    x[0, :4] = 0.0
    jp, jm = JaxSign().encode(jax.random.PRNGKey(0), jnp.asarray(x))
    dj = JaxSign().decode(jp, jm, jax.ShapeDtypeStruct(x.shape, jnp.float32))
    xt = torch.from_numpy(x)
    tp, tm = ScaledSign().encode(None, xt)
    dt = ScaledSign().decode(tp, tm, ShapeDtype.of(xt))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    assert ScaledSign().delta(40) == JaxSign().delta(40)
    assert not ScaledSign().stochastic


def test_unported_wires_raise(smoke):
    """The moe and act wires are ported: on an architecture that cannot
    carry one (the dense qwen3 has no experts) they raise the
    reference's ValueError; their topologies build."""
    _, cfg = smoke
    with pytest.raises(ValueError, match="needs a MoE architecture"):
        build_transport(CompressionConfig(moe_wire="q8"), cfg, SimChannel())
    tt = build_transport(CompressionConfig(act_wire="q8"), cfg, SimChannel())
    assert tt["act"].topology == "p2p"
    for topology in ("all_to_all", "p2p"):
        assert Wire(name="x", topology=topology, codec=None).traffic == ()
    with pytest.raises(ValueError, match="topology"):
        Wire(name="x", topology="mesh", codec=None)
    with pytest.raises(ValueError, match="auto"):
        build_transport(CompressionConfig(comm_mode="auto"), cfg,
                        SimChannel())


def test_transport_registry(smoke):
    _, cfg = smoke
    tt = build_transport(CompressionConfig(model_wire="natural"), cfg,
                         SimChannel(), params_like=_like(cfg))
    assert tt.names() == ("grad", "model") and len(tt) == 2
    assert "model" in tt and tt.get("act") is None
    assert [w.name for w in tt] == ["grad", "model"]
    with pytest.raises(KeyError, match="no wire"):
        tt["act"]
    with pytest.raises(ValueError, match="already registered"):
        tt.register(Wire(name="grad", topology="allreduce", codec=None))
    assert len(Transport()) == 0


def test_wire_stream_is_an_address_field():
    """A wire's stream addresses its draws by the CRC-32 of its name (31
    bits, as the reference folds it into its key): no two wires, and no
    wire and the grad path, share draws; the grad path's addresses are
    those without the field; ``at_round`` is the source moved on."""
    base = AddressedNoise(4, "cpu")
    model, act = wire_stream(base, "model"), wire_stream(base, "act")
    assert model.wire == zlib.crc32(b"model") & 0x7FFFFFFF
    draws = [s.uniform(0, 0, (64,)) for s in (base, model, act)]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])
    assert torch.equal(draws[0], AddressedNoise(4, "cpu").uniform(0, 0, (64,)))
    moved = AddressedNoise(4, "cpu")
    for _ in range(3):
        moved.next_round()
    assert torch.equal(base.at_round(3).uniform(2, 1, (8,)),
                       moved.uniform(2, 1, (8,)))
    assert torch.equal(model.at_round(2).uniform(0, None, (8,)),
                       wire_stream(AddressedNoise(4, "cpu"), "model")
                       .at_round(2).uniform(0, None, (8,)))
