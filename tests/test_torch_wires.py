"""Port parity: the moe and act wires (``comm.transport``: ``Wire.send``,
``Channel.all_to_all``, ``build_transport``'s ``moe`` / ``act`` wires,
``WorkerWireNoise``) and the training step that carries them.

* ``Wire.send`` on the act wire's ``p2p`` topology with
  ``Int8Stochastic`` and an EF shift: the forward value ``x + (decoded -
  x)`` and the residual (the decode fused in, one fma as XLA has it)
  bitwise the reference's jitted send.
* Two wired smoke steps of qwen2-moe-a2.7b (W = 2, both wires q8, two
  token groups a worker, DIANA + int8 messages, dense aggregation)
  against the reference's jitted ``build_train_step``, every draw of the
  round and of both wires replayed by ADDRESS from the reference's key
  chain: ``wire_stream(key, "transport")`` split over the workers, then
  ``wire_stream(., "act" | "moe")``, folded by layer (and group, split
  into dispatch and combine).  Each draw is taken once.  The loss
  (whose forward runs through the act wire's quantized boundaries)
  within RTOL = 1e-5; the shifts and ``h_bar`` within one int8 step of
  the messages (gradients that agree within RTOL may round a message
  the other way); after the first step the params within RTOL of their
  scale plus 1% of an AdamW step but at 0.01% of the elements, after
  both within two steps (the test says why); the bits exactly.
* ``per_wire_bits`` of the smoke config at batch 8, seq 64, W = 1: the
  committed ``BENCH_moe_wire`` rows of ``experiments/obs/baseline.json``
  exactly.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.comm.channel import SimChannel as JaxSim
from repro.comm.transport import Wire as JaxWire
from repro.comm.transport import wire_stream as jax_wire_stream
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.configs.base import TrainConfig as JaxTrain
from repro.core.compressors import Int8Stochastic as JaxInt8
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_step
from repro.launch.train import init_state as jax_init
from repro.models import moe as JMOE
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.transport import SendDraw, Wire, build_transport
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.core.compressors import Int8Stochastic, make_compressor
from repro_torch.launch.train import build_train_step, params_like
from repro_torch.weights import flatten_tree, state_from_jax

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
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


def test_act_send_bitwise_vs_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 16, 32)) * 0.1).astype(np.float32)
    e = (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jw = JaxWire(name="act", topology="p2p", codec=JaxInt8(),
                 channel=JaxSim())
    yj, ej = jax.jit(lambda k, x, e: jw.send(k, x, e))(key, x, e)
    u = np.asarray(jax.random.uniform(key, x.shape))

    class Stream:
        def send_uniform(self, address, shape):
            assert address == (3, 1, None, None)
            return torch.from_numpy(u.copy())

    tw = Wire(name="act", topology="p2p", codec=Int8Stochastic(),
              channel=SimChannel())
    yt, et = tw.send(SendDraw(Stream(), (3, 1, None, None)),
                     torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_array_equal(_bits(yt.numpy()), _bits(yj))
    np.testing.assert_array_equal(_bits(et.numpy()), _bits(ej))
    # without a shift: no residual
    yt2, et2 = tw.send(SendDraw(Stream(), (3, 1, None, None)),
                       torch.from_numpy(x))
    assert et2 is None and yt2.shape == yt.shape


def test_all_to_all_rejects_meta_codecs():
    x = torch.randn(40)
    rand = lambda shape: torch.rand(shape)  # noqa: E731
    with pytest.raises(ValueError, match="meta"):
        SimChannel().all_to_all(make_compressor("randk", q=0.25,
                                                shared_pattern=True),
                                type("R", (), {"permutation": staticmethod(
                                    torch.randperm), "__call__": rand})(),
                                x)
    d = SimChannel().all_to_all(Int8Stochastic(), rand, x)
    assert d.shape == x.shape and (d - x).abs().max() <= x.abs().max() / 127


def test_wires_raise_for_unfit_architectures():
    """The reference's messages: the moe wire needs experts, the act wire
    residual-stream blocks."""
    with pytest.raises(ValueError, match="needs a MoE architecture"):
        build_transport(CompressionConfig(moe_wire="q8"),
                        get_smoke_config("qwen3-0.6b"), SimChannel())
    with pytest.raises(ValueError, match="supports arch_type"):
        build_transport(CompressionConfig(act_wire="q8"),
                        get_smoke_config("rwkv6-3b"), SimChannel())
    with pytest.raises(ValueError, match="unknown wire codec"):
        build_transport(CompressionConfig(act_wire="q4"),
                        get_smoke_config("qwen3-0.6b"), SimChannel())


def _bench_rows():
    base = json.loads((ROOT / "experiments/obs/baseline.json").read_text())
    return base["artifacts"]["BENCH_moe_wire.json"]["metrics"]


@pytest.mark.parametrize("label,moe,act", [
    ("grad-only", "none", "none"), ("moe-dense", "dense", "none"),
    ("moe-q8", "q8", "none"), ("moe-q8+act-q8", "q8", "q8")])
def test_per_wire_bytes_match_bench_rows(label, moe, act):
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    comp = CompressionConfig(comm_mode="dense", shift_rule="diana",
                             moe_wire=moe, act_wire=act)
    t = build_transport(comp, cfg, None, w=1, params_like=params_like(cfg),
                        tokens_per_worker=8 * 64)
    got = {n: b / 8.0 for n, b in t.per_wire_bits().items()}
    want = {k[len(label) + len(".wire_bytes."):]: v
            for k, v in _bench_rows().items()
            if k.startswith(label + ".wire_bytes.")}
    assert got == want
    if moe == "q8":
        assert got["moe"] == 655_376.0
    if act == "q8":
        assert got["act"] == 131_080.0


# -- the wired step against the reference's -----------------------------------


W, B, S, GROUP, LR = 2, 4, 16, 24, 1e-3


class StepReplay:
    """The step's noise, replaying the reference's draws by address: the
    round's message uniforms by ``(leaf, worker, part)``, each wire's
    sends by ``(layer, worker, group, part)`` (its stream, at the step's
    round).  Each draw may be taken once."""

    def __init__(self, msg, sends, round=0, wire=None):
        self.msg, self.sends = msg, sends
        self.round, self.wire = round, wire

    @staticmethod
    def _take(table, key, shape):
        u = table.pop(key)
        assert u.shape == tuple(shape), (key, u.shape, shape)
        return torch.from_numpy(np.array(u, np.float32))

    def uniform(self, leaf, worker, shape, part=None):
        return self._take(self.msg, (self.round, leaf, worker, part), shape)

    def stream(self, name):
        return StepReplay(self.msg, self.sends, 0, name)

    def at_round(self, r):
        return StepReplay(self.msg, self.sends, r, self.wire)

    def send_uniform(self, address, shape):
        return self._take(self.sends, (self.round, self.wire, *address),
                          shape)

    def next_round(self):
        self.round += 1

    @property
    def done(self):
        return not self.msg and not self.sends


def _reference_draws(key, params, cfg, r, msg, sends):
    """Round ``r``'s draws of the reference step at ``key`` (its state
    key): the DIANA round's int8 message uniforms and both wires' sends,
    under the port's addresses."""
    _, sub = jax.random.split(key)
    k_msg = jax.random.split(sub, 3)[0]
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
        for j, wk in enumerate(jax.random.split(kq, W)):
            msg[(r, i, j, "q")] = np.asarray(jax.random.uniform(wk,
                                                                 leaf.shape))
    n_tok = (B // W) * S
    n_groups = -(-n_tok // GROUP)
    ebuf = (cfg.n_experts, JMOE._capacity(GROUP, cfg), cfg.d_model)
    kw = jax.random.split(jax_wire_stream(key, "transport"), W)
    for j in range(W):
        k_act = jax_wire_stream(kw[j], "act")
        k_moe = jax_wire_stream(kw[j], "moe")
        for li in range(cfg.n_layers):
            sends[(r, "act", li, j, None, None)] = np.asarray(
                jax.random.uniform(jax.random.fold_in(k_act, li),
                                   (B // W, S, cfg.d_model)))
            lk = jax.random.fold_in(k_moe, li)
            for g in range(n_groups):
                kd, kc = jax.random.split(jax.random.fold_in(lk, g))
                for part, k in (("dispatch", kd), ("combine", kc)):
                    sends[(r, "moe", li, j, g, part)] = np.asarray(
                        jax.random.uniform(k, ebuf))


def test_wired_step_matches_reference():
    cfg_j = jax_smoke(ARCH).with_(dtype="float32", moe_group_size=GROUP)
    cfg_t = get_smoke_config(ARCH).with_(dtype="float32",
                                         moe_group_size=GROUP)
    kw = dict(comm_mode="dense", compressor="int8", shift_rule="diana",
              moe_wire="q8", act_wire="q8")
    tj = JaxTrain(learning_rate=LR, total_steps=10, warmup_steps=1,
                  compression=JaxComp(**kw))
    tt = TrainConfig(learning_rate=LR, total_steps=10, warmup_steps=1,
                     compression=CompressionConfig(**kw))
    sj = jax_init(jax.random.PRNGKey(0), cfg_j, tj, W)
    npt = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    noise = StepReplay({}, {})
    st = state_from_jax(npt(sj.params), npt(sj.opt.m), npt(sj.opt.v), 0,
                        npt(sj.h), npt(sj.h_bar), noise=noise)
    step_j = jax.jit(jax_step(cfg_j, tj, make_host_mesh(), W))
    step_t = build_train_step(cfg_t, tt, W)
    toks = np.random.default_rng(0).integers(
        0, cfg_t.vocab_size, (2, B, S)).astype(np.int32)
    for r in range(2):
        _reference_draws(sj.key, sj.params, cfg_j, r, noise.msg,
                         noise.sends)
        sj, mj = step_j(sj, {"tokens": toks[r]})
        st, mt = step_t(st, {"tokens": torch.from_numpy(toks[r]).long()})
        assert noise.done, (r, len(noise.msg), len(noise.sends))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(mt["aux"]), float(mj["aux"]),
                                   rtol=RTOL)
        assert float(mt["bits"]) == float(mj["bits"])
        off = size = 0
        for name, got, want in (("params", st.params, sj.params),
                                ("h", st.h, sj.h),
                                ("h_bar", st.h_bar, sj.h_bar)):
            ref = flatten_tree(npt(want))
            for k, g in got.items():
                scale = np.abs(ref[k]).max() + 1e-30
                err = np.abs(g.numpy() - ref[k])
                if name != "params":
                    # an int8 message may round the other way where the
                    # gradients differ in their last bits: one step of
                    # its scale
                    assert err.max() <= 2 / 127 * scale, (r, name, k)
                    continue
                # AdamW's g / (|g| + eps) turns last-bit gradient
                # differences at |g| ~ eps into a visible part of a step:
                # RTOL of the scale plus 1% of lr everywhere but at 0.01%
                # of all the elements, and those within two steps.  After
                # the second step the int8 messages of the first that
                # rounded the other way change g / sqrt(v) visibly where
                # g is small (measured: 456 of 905,856 elements past the
                # first bound): that step is held by its loss, shifts,
                # bits and draws, its params only within two steps.
                off += int((err > RTOL * scale + 1e-2 * LR).sum())
                size += err.size
                assert err.max() <= 2 * LR, (r, k, float(err.max()))
        if r == 0:
            assert off <= 1e-4 * size, (off, size)
