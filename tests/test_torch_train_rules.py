"""Port parity for the two shift rules this slice adds to the training
step, one step each of ``repro_torch.launch.train.build_train_step``
against ``repro.launch.train.build_train_step`` on the qwen3-0.6b smoke
config (4 workers, batch 8, seq 32), from the reference's state, with
its draws replayed along its key chain
(``test_torch_convex_round.round_draws``):

* ``rand_diana`` + ``randk`` (q = 0.1), dense aggregation, AdamW; the
  refresh probability is raised to p = 0.75 so that the step refreshes
  some workers (two of four here; the config's 0.05 would most likely
  refresh none);
* ``vr_gdci`` + ``randk``: Algorithm 2, whose round mixes the params
  itself (gamma = the learning rate) and bypasses AdamW.

What can and cannot be bitwise:

* ``bits`` is structural: EXACTLY equal (k (32 + ceil(log2 d)) per leaf
  and worker, plus one dense f32 message per refreshing worker).
* The gradients agree to ~1e-6 of their largest entry, not bitwise.
  RandK's draws are replayed, so every message element is the same
  coordinate of nearly the same gradient: shifts, master shifts and the
  VR-GDCI iterate are held within TIGHT of each leaf's largest entry.
* AdamW's first step normalises ``g / (|g| + eps)``: params within
  ``2 lr``, at most 1e-3 of them beyond f32 noise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.configs.base import TrainConfig as JaxTrain
from repro.core.compressors import RandK as JaxRandK
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_build
from repro.launch.train import init_state as jax_init
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch import train as port_train
from test_torch_convex_round import ReplayNoise, round_draws
from test_torch_train import _np, _port_state, _tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, LR, Q = 4, 1e-2, 0.1
TIGHT = 1e-5       # f32 agreement, relative to a leaf's largest entry
CONFIGS = {
    "rand_diana": dict(enabled=True, compressor="randk",
                       shift_rule="rand_diana", shift_p=0.75),
    "vr_gdci": dict(enabled=True, compressor="randk", shift_rule="vr_gdci"),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reference(request):
    """One reference step from its initial state: the state before and
    after, the round's draws, the metrics and the batch."""
    name = request.param
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = JaxTrain(learning_rate=LR, total_steps=1, warmup_steps=1,
                    compression=JaxComp(**CONFIGS[name]))
    step = jax.jit(jax_build(cfg, tcfg, make_host_mesh(), W))
    state = jax_init(jax.random.PRNGKey(0), cfg, tcfg, W)
    batch = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    _, sub = jax.random.split(state.key)
    shapes = [p.shape for p in jax.tree_util.tree_leaves(state.params)]
    draws = round_draws(name, sub, shapes, W, JaxRandK(Q))
    after, metrics = step(state, {"tokens": batch})
    return name, state, after, draws, {k: np.asarray(v)
                                       for k, v in metrics.items()}, batch


def _close(ref_tree, got, what):
    for k, ref in ref_tree.items():
        d = np.abs(got[k].numpy() - ref)
        assert d.max() <= TIGHT * np.abs(ref).max() + 1e-30, (what, k,
                                                              d.max())


def test_step_matches_reference(reference):
    name, before, after, draws, metrics, batch = reference
    cfg = port_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = TrainConfig(learning_rate=LR, total_steps=1, warmup_steps=1,
                       compression=CompressionConfig(**CONFIGS[name]))
    step = port_train.build_train_step(cfg, tcfg, W)
    noise = ReplayNoise(draws)
    port, m = step(_port_state(before, noise), _tokens(batch))
    assert noise.done                      # every draw was consumed
    assert port.step == 1
    assert m["bits"].item() == float(metrics["bits"])
    np.testing.assert_allclose(float(m["loss"]), metrics["loss"],
                               rtol=TIGHT)
    _close(_np(after.h), port.h, "h")
    _close(_np(after.h_bar), port.h_bar, "h_bar")
    if name == "rand_diana":               # the step is not vacuous
        assert 0 < int((draws[-1][1] < np.float32(0.75)).sum()) < W
    if name == "vr_gdci":
        _close(_np(after.params), port.params, "params")
        for k, ref in _np(after.opt.m).items():   # AdamW untouched
            assert (port.opt.m[k].numpy() == ref).all()
        return
    off = n = 0
    for k, ref in _np(after.params).items():
        d = np.abs(port.params[k].numpy() - ref)
        assert (d <= 2 * LR).all(), k
        off += int((d > TIGHT * np.abs(ref).max()).sum())
        n += d.size
    assert off <= 1e-3 * n, (off, n)


@pytest.mark.parametrize("flags", [["--shift-rule", "rand_diana",
                                    "--compressor", "randk"],
                                   ["--shift-rule", "vr_gdci"]])
def test_cli_rules_run_on_cpu(flags, capsys):
    state = port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "16", "--device",
                             "cpu", *flags])
    out = capsys.readouterr().out
    assert f"rule={flags[1]}" in out and "step    1" in out
    assert state.step == 2 and state.bits.item() > 0
    assert all(np.isfinite(p.numpy()).all() for p in state.params.values())
    if flags[1] == "vr_gdci":
        assert state.opt.step == 0         # the optimizer is bypassed
