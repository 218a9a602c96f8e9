"""Port parity for the step's round through the transport's grad wire
and its diagnostics (``repro_torch.launch.train.build_train_step``,
``diag=True``).

* The four diagnostics (``ef_err_norm``, ``grad_sq``,
  ``shift_residual_sq``, ``h_bar_drift``) against the reference's
  jitted ``diag=True`` step on the qwen3-0.6b smoke config, from one
  state carried from the reference (its master shift moved off the
  shifts' mean, so the drift is a real quantity) with the reference's
  uniforms replayed: within 1e-4 relative (the gradients agree to ~1e-6
  and XLA may reassociate the sums of squares).
* The state under ``diag=True`` is bitwise the state under
  ``diag=False``, for every shift rule and every ported comm mode (2
  smoke steps, the same addressed noise): the diagnostics consume no
  draws and write nothing.
* The step through the grad wire is bitwise the step before it went
  through the wire (the round called on the rule and the channel
  directly, as the step did), in every kind of round: shift, fused,
  iterate and uncompressed.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.configs.base import TrainConfig as JaxTrain
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_build
from repro.launch.train import init_state as jax_init
from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch import train as T
from repro_torch.launch.mesh import HostMesh
from test_torch_train import COMP, ReplayNoise, _port_state, round_uniforms

W, LR, ALPHA = 4, 1e-2, 0.125
DIAG = ("ef_err_norm", "grad_sq", "shift_residual_sq", "h_bar_drift")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke steps are tiny: one intra-op thread each, so that test
    processes running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_diag_metrics_match_reference():
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = JaxTrain(learning_rate=LR, total_steps=3, warmup_steps=1,
                    compression=JaxComp(**COMP))
    state = jax_init(jax.random.PRNGKey(0), cfg, tcfg, W)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
               for _ in range(2)]
    plain = jax.jit(jax_build(cfg, tcfg, make_host_mesh(), W))
    state, _ = plain(state, {"tokens": batches[0]})       # non-zero shifts
    state = state._replace(h_bar=jax.tree_util.tree_map(
        lambda a: a + 1e-3 * jax.numpy.ones_like(a), state.h_bar))
    draws = round_uniforms(state.key, state.params)
    _, ref = jax.jit(jax_build(cfg, tcfg, make_host_mesh(), W, diag=True))(
        state, {"tokens": batches[1]})
    step = T.build_train_step(
        get_smoke_config("qwen3-0.6b").with_(dtype="float32"),
        TrainConfig(learning_rate=LR, total_steps=3, warmup_steps=1,
                    compression=CompressionConfig(**COMP)), W, diag=True)
    port = _port_state(state, ReplayNoise(draws))
    _, m = step(port, {"tokens": torch.from_numpy(batches[1]).long()})
    for k in DIAG:
        assert m[k].dtype == torch.float32 and m[k].dim() == 0, k
        np.testing.assert_allclose(m[k].item(), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert m["h_bar_drift"].item() > 0.1       # the moved master shift


# -- diag=True leaves the state bitwise ------------------------------------------

CASES = [(mode, "diana") for mode in (
    "dense", "q8_ring", "q8_ring_fused", "randk_shared", "q8_ring_overlap",
    "q8_ring_fused_vjp")] + [
    ("dense", rule) for rule in ("fixed", "dcgd", "rand_diana", "vr_gdci")
] + [("ef21", "diana"), ("efbv", "diana"), ("efbv_overlap", "diana")]


def _run(mode, rule, diag, steps=2, codec="q8_block", mesh=None):
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    comp = CompressionConfig(
        enabled=True, compressor="randk" if rule == "rand_diana" else codec,
        shift_rule=rule, comm_mode=mode, shift_alpha=ALPHA,
        overlap_bucket_bytes=1 << 16)
    tcfg = TrainConfig(learning_rate=LR, total_steps=steps, warmup_steps=1,
                       compression=comp)
    mesh = mesh or HostMesh(data=2, device="cpu")
    state = T.init_state(0, cfg, tcfg, W, "cpu")
    step = T.build_train_step(cfg, tcfg, W, mesh, diag=diag)
    rng = np.random.default_rng(2)
    metrics = []
    for _ in range(steps):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
        state, m = step(state, {"tokens": tokens})
        metrics.append(m)
    return state, metrics


def _same_state(a, b):
    for name in ("params", "h", "h_bar"):
        ta, tb = getattr(a, name), getattr(b, name)
        if ta is None:
            assert tb is None
            continue
        for k in ta:
            assert torch.equal(ta[k].view(torch.int32),
                               tb[k].view(torch.int32)), (name, k)
    for k in a.opt.m:
        assert torch.equal(a.opt.m[k], b.opt.m[k])
        assert torch.equal(a.opt.v[k], b.opt.v[k])
    assert a.bits.item() == b.bits.item() and a.step == b.step
    assert a.noise.round == b.noise.round


@pytest.mark.parametrize("mode,rule", CASES)
def test_diag_state_is_bitwise_the_plain_state(mode, rule):
    plain, pm = _run(mode, rule, diag=False)
    diag, dm = _run(mode, rule, diag=True)
    _same_state(plain, diag)
    for a, b in zip(pm, dm):
        assert a["loss"].item() == b["loss"].item()
    shifted = rule not in ("fixed", "dcgd", "vr_gdci")
    want = set()
    if rule != "vr_gdci":
        want = {"grad_sq", "shift_residual_sq"} | (
            {"h_bar_drift"} if shifted else set())
        if mode != "q8_ring_fused_vjp":
            want.add("ef_err_norm")
        else:
            want = {"h_bar_drift"}
    assert set(DIAG) & set(dm[-1]) == want
    assert not set(DIAG) & set(pm[-1])
    for k in want:
        assert torch.isfinite(dm[-1][k]).all(), k
    if rule in ("fixed", "dcgd"):      # no shift: the residual IS the grad
        assert dm[-1]["shift_residual_sq"].item() == dm[-1]["grad_sq"].item()


def test_diag_on_the_pod_model_mesh():
    """The production layout (pod 2, data 2, model 2): the state is the
    plain state's and the round's error is the ring's."""
    mesh = HostMesh(pod=2, data=2, model=2, device="cpu")
    plain, _ = _run("q8_ring_fused", "diana", False, mesh=mesh)
    diag, dm = _run("q8_ring_fused", "diana", True, mesh=mesh)
    _same_state(plain, diag)
    assert dm[-1]["ef_err_norm"].item() > 0


# -- the round through the grad wire == the round called directly ------------------


def _old_step(cfg, tcfg, w, mesh):
    """The step as it was before its round went through the grad wire:
    the rule's and the channel's rounds called directly."""
    from repro_torch.comm import fused_vjp
    from repro_torch.comm.channel import FUSED_VJP_MODES, resync_h_bar
    from repro_torch.core.iterate_comp import VRGDCI
    from repro_torch.dist.worker_grads import per_worker_grads, split_batch
    from repro_torch.optim.optimizers import make_optimizer

    cfg = cfg.with_(attn_q_chunk=tcfg.train_attn_chunk)
    comp = tcfg.compression
    optimizer = make_optimizer(tcfg)
    channel = T.build_channel(comp, cfg, mesh, w)
    q, rule = (comp.make(learning_rate=tcfg.learning_rate) if comp.enabled
               else (None, None))
    fused = comp.enabled and comp.comm_mode in FUSED_VJP_MODES
    loss_fn = T.worker_loss(cfg, rule, q) if fused else T.worker_loss(cfg)

    def step(state, batch):
        wbatch = split_batch(batch, w)
        if fused:
            wbatch = T.with_fused_draws(wbatch, rule, q, state, w)
        grads, loss, _ = per_worker_grads(loss_fn, state.params, wbatch)
        if not comp.enabled:
            g_bar = channel.reduce_mean(state.noise, grads)
            h, h_bar, bits = state.h, state.h_bar, state.bits
        elif isinstance(rule, VRGDCI):
            params, h, h_bar, sb = rule.round(state.noise, state.params,
                                              grads, state.h, state.h_bar,
                                              channel)
            state.noise.next_round()
            return T.TrainState(params, state.opt, h, h_bar, state.noise,
                                state.step + 1, state.bits + sb), {}
        else:
            if fused:
                g_bar, h, h_bar, sb = channel.fused_round(
                    rule, q, state.noise, grads, state.h, state.h_bar)
            else:
                g_bar, h, h_bar, sb = rule.round(q, state.noise, grads,
                                                 state.h, state.h_bar,
                                                 channel)
            h_bar = resync_h_bar(h, h_bar, state.step,
                                 comp.drift_resync_every)
            bits = state.bits + sb
        params, opt = optimizer.update(g_bar, state.opt, state.params)
        state.noise.next_round()
        return T.TrainState(params, opt, h, h_bar, state.noise,
                            state.step + 1, bits), {}

    return step


@pytest.mark.parametrize("mode,rule,enabled", [
    ("dense", "diana", True), ("q8_ring_fused", "diana", True),
    ("q8_ring_fused_vjp", "diana", True), ("randk_shared", "diana", True),
    ("dense", "vr_gdci", True), ("dense", "diana", False)])
def test_step_through_grad_wire_is_the_direct_round(mode, rule, enabled):
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    comp = CompressionConfig(enabled=enabled, compressor="q8_block",
                             shift_rule=rule, comm_mode=mode,
                             shift_alpha=ALPHA)
    tcfg = TrainConfig(learning_rate=LR, total_steps=2, warmup_steps=1,
                       compression=comp)
    mesh = HostMesh(data=2, device="cpu")
    states = []
    for build in (T.build_train_step, _old_step):
        state = T.init_state(0, cfg, tcfg, W, "cpu")
        step = build(cfg, tcfg, W, mesh)
        rng = np.random.default_rng(3)
        for _ in range(2):
            state, _ = step(state, {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (4, 16)))})
        states.append(state)
    _same_state(*states)


def test_cli_randk_shared_runs_on_cpu(capsys):
    """``--comm-mode randk_shared`` runs (one position on the CPU)."""
    state = T.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                    "--batch", "4", "--seq", "16", "--device", "cpu",
                    "--comm-mode", "randk_shared"])
    out = capsys.readouterr().out
    assert "comm=randk_shared" in out and "workers=1" in out
    assert state.step == 2 and state.bits.item() > 0
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert isinstance(state.noise, AddressedNoise)
