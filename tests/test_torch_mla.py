"""Port parity: multi-head latent attention (``repro_torch.models.mla``)
and deepseek-v2-lite-16b's wired training step.

* ``mla_apply`` (the expanded training form) and ``mla_decode`` (the
  absorbed decode, with and without a sliding window, through a ring
  cache that wraps) against the reference's jitted functions on one
  layer of the smoke config in float32: outputs and cache leaves within
  TOL (1 + |reference|), positions bitwise.  Both sides run the same f32
  arithmetic in other summation orders.
* The absorbed decode against the expanded form on the same tokens: the
  latent attention is the same function either way.
* Two wired smoke steps of deepseek-v2-lite-16b (its leading dense layer
  and one MoE layer; W = 2, both wires q8, two token groups a worker,
  DIANA + int8 messages, dense aggregation) against the reference's
  jitted ``build_train_step``, every draw replayed by address
  (``StepReplay`` of ``tests/test_torch_wires.py``): the moe wire sends
  at the MoE layer's global index 1, the act wire at both layers, its
  shift zeroed at each stack.  Held as ``test_torch_wires.py`` holds
  qwen2-moe-a2.7b's step.
* ``per_wire_bits`` against the reference's ``Transport`` at the smoke
  size and, ahead of time, at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import SimChannel as JaxSim
from repro.comm import build_transport as jax_build
from repro.comm.transport import wire_stream as jax_wire_stream
from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.configs.base import TrainConfig as JaxTrain
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_step
from repro.launch.train import init_state as jax_init
from repro.models import mla as JMLA
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.transport import build_transport
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch.train import build_train_step, params_like
from repro_torch.models import mla as TMLA
from repro_torch.weights import flatten_tree, params_from_jax, state_from_jax

from test_torch_wires import StepReplay

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - np.asarray(want))
    assert (err <= TOL * (1 + np.abs(np.asarray(want)))).all(), (
        what, float(err.max()))


@pytest.fixture(scope="module")
def layer():
    """(cfg_j, cfg_t, one MLA layer's params both sides, x (2, 10, D))."""
    cfg_j = jax_smoke(ARCH).with_(dtype="float32")
    cfg_t = get_smoke_config(ARCH).with_(dtype="float32")
    pj = JMLA.init_mla(jax.random.PRNGKey(4), cfg_j)
    pt = params_from_jax(_np(pj))
    x = (np.random.default_rng(5).standard_normal((2, 10, cfg_j.d_model))
         ).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, x


def test_specs_match_reference(layer):
    cfg_j, cfg_t, pj, pt, _ = layer
    ref = flatten_tree(_np(pj))
    assert sorted((n, s) for n, s, _ in TMLA.mla_specs(cfg_t)) == [
        (k, v.shape) for k, v in ref.items()]
    assert ref["wq"].shape == (cfg_t.d_model, cfg_t.n_heads,
                               cfg_t.qk_nope_dim + cfg_t.qk_rope_dim)
    assert ref["wo"].shape == (cfg_t.n_heads, cfg_t.v_head_dim,
                               cfg_t.d_model)


def test_mla_apply_matches_reference(layer):
    cfg_j, cfg_t, pj, pt, x = layer
    yj = jax.jit(lambda p, x: JMLA.mla_apply(p, x, cfg_j))(pj, x)
    with torch.no_grad():
        yt = TMLA.mla_apply(pt, torch.from_numpy(x), cfg_t)
    _close(yt, yj, "mla_apply")


@pytest.mark.parametrize("window", [0, 3])
def test_mla_decode_matches_reference(layer, window):
    """10 tokens through a 4-slot latent cache (the ring wraps)."""
    cfg_j, cfg_t, pj, pt, x = layer
    cj = JMLA.make_mla_cache(cfg_j, 2, 4, jnp.float32)
    ct = TMLA.make_mla_cache(cfg_t, 2, 4, torch.float32, "cpu")
    assert list(ct) == sorted(cj)
    step = jax.jit(lambda p, x, c, pos: JMLA.mla_decode(p, x, cfg_j, c, pos,
                                                        window=window))
    for t in range(x.shape[1]):
        yj, cj = step(pj, x[:, t:t + 1], cj, jnp.int32(t))
        with torch.no_grad():
            yt = TMLA.mla_decode(pt, torch.from_numpy(x[:, t:t + 1]), cfg_t,
                                 ct, t, window=window)
        _close(yt, yj, f"y step {t}")
        _close(ct["ckv"], cj["ckv"], f"ckv step {t}")
        _close(ct["kr"], cj["kr"], f"kr step {t}")
        np.testing.assert_array_equal(ct["kpos"].numpy(), np.asarray(cj["kpos"]))


def test_absorbed_decode_equals_expanded_forward(layer):
    """Token by token through a cache as long as the sequence, the
    absorbed decode gives the expanded form's outputs."""
    _, cfg_t, _, pt, x = layer
    xt = torch.from_numpy(x)
    cache = TMLA.make_mla_cache(cfg_t, 2, x.shape[1], torch.float32, "cpu")
    with torch.no_grad():
        full = TMLA.mla_apply(pt, xt, cfg_t)
        for t in range(x.shape[1]):
            y = TMLA.mla_decode(pt, xt[:, t:t + 1], cfg_t, cache, t)
            _close(y[:, 0], full[:, t].numpy(), f"position {t}")


# -- the wired step against the reference's ----------------------------------


W, B, S, GROUP, LR = 2, 4, 16, 24, 1e-3


def _reference_draws(key, params, cfg, r, msg, sends):
    """Round ``r``'s draws of the reference step at ``key`` (its state
    key) under the port's addresses: the DIANA round's int8 message
    uniforms, the act wire's send at every layer and the moe wire's at
    every MoE layer (global index ``first_dense_layers`` on)."""
    _, sub = jax.random.split(key)
    k_msg = jax.random.split(sub, 3)[0]
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
        for j, wk in enumerate(jax.random.split(kq, W)):
            msg[(r, i, j, "q")] = np.asarray(jax.random.uniform(wk,
                                                                 leaf.shape))
    n_groups = -(-(B // W) * S // GROUP)
    ebuf = (cfg.n_experts, JMOE._capacity(GROUP, cfg), cfg.d_model)
    kw = jax.random.split(jax_wire_stream(key, "transport"), W)
    for j in range(W):
        k_act = jax_wire_stream(kw[j], "act")
        k_moe = jax_wire_stream(kw[j], "moe")
        for li in range(cfg.n_layers):
            sends[(r, "act", li, j, None, None)] = np.asarray(
                jax.random.uniform(jax.random.fold_in(k_act, li),
                                   (B // W, S, cfg.d_model)))
            if li < cfg.first_dense_layers:
                continue
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
    assert cfg_t.first_dense_layers == 1 and cfg_t.n_layers == 2
    kw = dict(comm_mode="dense", compressor="int8", shift_rule="diana",
              moe_wire="q8", act_wire="q8")
    tj = JaxTrain(learning_rate=LR, total_steps=10, warmup_steps=1,
                  compression=JaxComp(**kw))
    tt = TrainConfig(learning_rate=LR, total_steps=10, warmup_steps=1,
                     compression=CompressionConfig(**kw))
    sj = jax_init(jax.random.PRNGKey(0), cfg_j, tj, W)
    noise = StepReplay({}, {})
    st = state_from_jax(_np(sj.params), _np(sj.opt.m), _np(sj.opt.v), 0,
                        _np(sj.h), _np(sj.h_bar), noise=noise)
    step_j = jax.jit(jax_step(cfg_j, tj, make_host_mesh(), W))
    step_t = build_train_step(cfg_t, tt, W)
    toks = np.random.default_rng(0).integers(
        0, cfg_t.vocab_size, (2, B, S)).astype(np.int32)
    for r in range(2):
        _reference_draws(sj.key, sj.params, cfg_j, r, noise.msg, noise.sends)
        assert sum(k[1] == "moe" for k in noise.sends) == W * 2 * 2
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
            ref = flatten_tree(_np(want))
            for k, g in got.items():
                scale = np.abs(ref[k]).max() + 1e-30
                err = np.abs(g.numpy() - ref[k])
                if name != "params":
                    # an int8 message may round the other way where the
                    # gradients differ in their last bits: one step of
                    # its scale
                    assert err.max() <= 2 / 127 * scale, (r, name, k)
                    continue
                # as tests/test_torch_wires.py: RTOL of the scale plus 1%
                # of lr everywhere but at 0.01% of the elements after the
                # first step, within two AdamW steps after both
                off += int((err > RTOL * scale + 1e-2 * LR).sum())
                size += err.size
                assert err.max() <= 2 * LR, (r, k, float(err.max()))
        if r == 0:
            assert off <= 1e-4 * size, (off, size)


@pytest.mark.parametrize("full", [False, True])
def test_per_wire_bits_match_reference(full):
    """Both wires q8 at W = 2, 512 tokens a worker: the grad, moe and act
    wires' bits a step equal the reference's (full size ahead of time,
    nothing allocated); the moe wire two sends of the (E, C, D) buffer
    at the one MoE layer of the smoke config."""
    cfg_j = (jax_full if full else jax_smoke)(ARCH).with_(dtype="float32")
    cfg_t = (get_config if full else get_smoke_config)(ARCH).with_(
        dtype="float32")
    kw = dict(comm_mode="q8_ring_fused", compressor="q8_block",
              shift_rule="diana", moe_wire="q8", act_wire="q8")
    like_j = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    jt = jax_build(JaxComp(**kw), cfg_j, JaxSim(), w=W, params_like=like_j,
                   tokens_per_worker=512)
    tt = build_transport(CompressionConfig(**kw), cfg_t, SimChannel(), w=W,
                         params_like=params_like(cfg_t),
                         tokens_per_worker=512)
    got = tt.per_wire_bits()
    assert got == jt.per_wire_bits()
    assert set(got) == {"grad", "moe", "act"}
    if not full:
        c = JMOE._capacity(512, cfg_j)
        assert got["moe"] == W * 2 * (8 * cfg_t.n_experts * c
                                      * cfg_t.d_model + 32)
        assert got["act"] == W * cfg_t.n_layers * (8 * 512 * cfg_t.d_model
                                                   + 32)
