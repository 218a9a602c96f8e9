"""Port parity for the RWKV-6 training path: the rwkv6-3b smoke config
(2 layers, d 128, 2 WKV heads of 64, vocab 512) in float32, with params
carried from the reference's ``init_params`` by ``params_from_jax``.

* The leaf specs, paths, shapes and order, equal the reference's flatten;
  ``count_params_analytic`` equals the reference's at full size and at
  the 6 layers the card runs.
* The time-mix and channel-mix layers, ``forward_train``, and
  ``train_loss`` with every leaf's gradient, against the reference (and
  ``jax.value_and_grad``).  Tolerance as in ``test_torch_model.py``: the
  same f32 arithmetic summed in other orders (matmul blocking, the WKV
  recurrence's per-step sums, reductions), so 1e-5 relative to each
  output's largest entry.
* One DIANA + ``q8_block`` step from the reference's state against the
  reference's ``build_train_step``, with the reference's uniforms
  replayed (``test_torch_train.round_uniforms``) and that file's bounds.
* The CLI with ``--arch rwkv6-3b``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.configs.base import TrainConfig as JaxTrain
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_build
from repro.launch.train import init_state as jax_init
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rwkv6 as JR
from repro_torch.configs import get_config as port_full
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch import train as port_train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TR
from repro_torch.weights import flatten_tree, params_from_jax
from test_torch_train import (ReplayNoise, _lattice, _np, _port_state,
                              round_uniforms)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "rwkv6-3b"
RTOL = 1e-5
W, LR, ALPHA = 4, 1e-2, 0.125
TIGHT, RARE = 1e-5, 1e-4      # as in test_torch_train.py


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_smoke(ARCH).with_(dtype="float32")
    cfg_t = port_smoke(ARCH).with_(dtype="float32")
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (2, 24)).astype(np.int32)
    return cfg_j, cfg_t, pj, pt, toks


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def _paths_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), tuple(leaf.shape))
            for path, leaf in flat]


def test_param_specs_match_reference(setup):
    cfg_j, cfg_t, pj, pt, _ = setup
    ref = _paths_shapes(pj)
    assert [(p, s) for p, s, _ in TM.param_specs(cfg_t)] == ref
    assert len(ref) == 25
    # the constant inits are the reference's values
    init = TM.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    ref_np = flatten_tree(jax.tree_util.tree_map(np.asarray, pj))
    for path, _, spec in TM.param_specs(cfg_t):
        if isinstance(spec, tuple):
            np.testing.assert_array_equal(init[path].numpy(), ref_np[path],
                                          err_msg=path)
        else:
            assert init[path].std().item() == pytest.approx(
                float(ref_np[path].std()), rel=0.2), path


@pytest.mark.parametrize("n_layers,count", [(32, 3_068_070_400),
                                            (6, 847_895_040)])
def test_full_width_layout_and_count_match_reference(n_layers, count):
    cfg_j = jax_full(ARCH).with_(dtype="float32", n_layers=n_layers)
    cfg_t = port_full(ARCH).with_(dtype="float32", n_layers=n_layers)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert [(p, s) for p, s, _ in TM.param_specs(cfg_t)] == _paths_shapes(
        shapes)
    assert TM.count_params_analytic(cfg_t) == JM.count_params_analytic(
        cfg_j) == count


def test_params_from_jax_carries_the_ssm_tree(setup):
    """Every leaf of the reference's nested ssm tree, unchanged, under its
    flattened path and in its flatten order."""
    _, cfg_t, pj, pt, _ = setup
    flat, _ = jax.tree_util.tree_flatten_with_path(pj)
    assert list(pt) == TM.leaf_paths(cfg_t)
    for (path, leaf), (k, v) in zip(flat, pt.items()):
        assert k == "/".join(str(p.key) for p in path)
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(leaf), err_msg=k)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def test_layers_match_reference(setup):
    """Layer 0's time-mix and channel-mix, and the helpers they use, on
    one activation."""
    cfg_j, cfg_t, pj, pt, _ = setup
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg_j.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    tm_j = _layer(pj["blocks"]["time"], 0)
    tm_t = {k[len("blocks/time/"):]: v[0] for k, v in pt.items()
            if k.startswith("blocks/time/")}
    cm_j = _layer(pj["blocks"]["channel"], 0)
    cm_t = {k[len("blocks/channel/"):]: v[0] for k, v in pt.items()
            if k.startswith("blocks/channel/")}
    # a nonzero LoRA so the decay is data dependent
    lora_b = np.random.default_rng(2).standard_normal(
        tm_t["w_lora_b"].shape).astype(np.float32)
    tm_j = {**tm_j, "w_lora_b": jnp.asarray(lora_b)}
    tm_t = {**tm_t, "w_lora_b": torch.from_numpy(lora_b)}

    _close(TR._shift(xt), JR._shift(x), "shift")
    _close(TR._decay(tm_t, xt), JR._decay(tm_j, x), "decay")
    _close(TR._group_norm(xt, tm_t["ln_scale"], 2, cfg_t.norm_eps),
           JR._group_norm(x, tm_j["ln_scale"], 2, cfg_j.norm_eps),
           "group_norm")
    out_j, _ = JR.time_mix_apply(tm_j, x, cfg_j)
    _close(TR.time_mix_apply(tm_t, xt, cfg_t), out_j, "time_mix")
    out_j, _ = JR.channel_mix_apply(cm_j, x)
    _close(TR.channel_mix_apply(cm_t, xt), out_j, "channel_mix")
    _close(TL.rmsnorm(tm_t["ln_scale"], xt, cfg_t.norm_eps),
           JL.rmsnorm({"scale": tm_j["ln_scale"]}, x, cfg_j.norm_eps),
           "rmsnorm")


def test_forward_train_matches_reference(setup):
    cfg_j, cfg_t, pj, pt, toks = setup
    lj, _ = jax.jit(lambda p, t: JM.forward_train(p, cfg_j, {"tokens": t}))(
        pj, toks)
    lt, aux = TM.forward_train(pt, cfg_t,
                               {"tokens": torch.from_numpy(toks).long()})
    assert tuple(lt.shape) == tuple(lj.shape) == (2, 24, cfg_t.vocab_size)
    assert aux.item() == 0.0
    _close(lt, lj, "logits")


def test_train_loss_and_grads_match_reference(setup):
    cfg_j, cfg_t, pj, pt, toks = setup
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, t: JM.train_loss(p, cfg_j, {"tokens": t}),
        has_aux=True))(pj, toks)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    lt, _ = TM.train_loss(leaves, cfg_t,
                          {"tokens": torch.from_numpy(toks).long()})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    ref = _np(gj)
    assert list(ref) == list(leaves)
    for k, v in leaves.items():
        _close(v.grad, ref[k], f"grad {k}")


@pytest.fixture(scope="module")
def reference_step():
    """One reference step of DIANA + q8_block (dense aggregation, W
    workers) on the smoke config: the state before and after, its round
    uniforms, its metrics and the batch."""
    cfg = jax_smoke(ARCH).with_(dtype="float32")
    comp = JaxComp(enabled=True, compressor="q8_block", shift_rule="diana",
                   comm_mode="dense", shift_alpha=ALPHA)
    tcfg = JaxTrain(learning_rate=LR, total_steps=3, warmup_steps=1,
                    compression=comp)
    step = jax.jit(jax_build(cfg, tcfg, make_host_mesh(), W))
    state = jax_init(jax.random.PRNGKey(0), cfg, tcfg, W)
    batch = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    draws = round_uniforms(state.key, state.params)
    after, m = step(state, {"tokens": batch})
    return state, after, draws, {k: np.asarray(v) for k, v in m.items()}, batch


def test_step_matches_reference(reference_step):
    """The port's step from the reference's state, with the reference's
    uniforms: bits exactly, loss to f32 precision, shifts within alpha
    lattice steps of their tile (at most RARE of them off), h_bar and
    params within 2 lr (at most 1e-3 of them beyond f32 noise)."""
    before, after, draws, metrics, batch = reference_step
    cfg = port_smoke(ARCH).with_(dtype="float32")
    comp = CompressionConfig(enabled=True, compressor="q8_block",
                             shift_rule="diana", comm_mode="dense",
                             shift_alpha=ALPHA)
    tcfg = TrainConfig(learning_rate=LR, total_steps=3, warmup_steps=1,
                       compression=comp)
    step = port_train.build_train_step(cfg, tcfg, W)
    port, m = step(_port_state(before, ReplayNoise(draws)),
                   {"tokens": torch.from_numpy(batch).long()})
    assert not port.noise.draws
    assert m["bits"].item() == float(metrics["bits"])
    np.testing.assert_allclose(float(m["loss"]), metrics["loss"], rtol=TIGHT)

    h0, h1 = _np(before.h), _np(after.h)
    flipped = total = 0
    for k, ref in h1.items():
        lat = _lattice((ref - h0[k]) / ALPHA)
        d = np.abs(port.h[k].numpy() - ref)
        noise = TIGHT * np.abs(ref).max()
        assert (d <= ALPHA * lat * 1.001 + noise).all(), k
        flipped += int((d > noise).sum())
        total += d.size
    assert flipped <= RARE * total, (flipped, total)
    for name, ref_tree, got in [("h_bar", _np(after.h_bar), port.h_bar),
                                ("params", _np(after.params), port.params)]:
        off = n = 0
        for k, ref in ref_tree.items():
            d = np.abs(got[k].numpy() - ref)
            assert (d <= 2 * LR).all(), (name, k)
            off += int((d > TIGHT * np.abs(ref).max()).sum())
            n += d.size
        assert off <= 1e-3 * n, (name, off, n)


def test_cli_runs_on_cpu(capsys):
    state = port_train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "step    1" in out
    assert state.step == 2 and state.bits.item() > 0
    assert all(torch.isfinite(p).all() for p in state.params.values())
