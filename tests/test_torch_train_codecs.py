"""Port parity for the two codec paths this slice adds to the training
step: one step of ``repro_torch.launch.train.build_train_step`` against
``repro.launch.train.build_train_step`` on the qwen3-0.6b smoke config
(4 workers, batch 8, seq 32, AdamW), from the reference's state, with
its round uniforms replayed through the port's noise source:

* DIANA + ``natural`` + dense aggregation: the reference's default
  configuration (``CompressionConfig(enabled=True)``);
* the ``ef21`` comm mode + ``topk`` (q = 0.1): EF21's rule, dense
  aggregation, a codec that draws nothing.

What can and cannot be bitwise:

* ``bits`` is structural: EXACTLY equal (natural: 9 bits per element and
  worker; topk: k (32 + ceil(log2 d)) per leaf and worker).
* The gradients agree to ~1e-6 of their largest entry, not bitwise.  For
  natural, where ``u`` lies that close to an element's ``p_up`` the two
  sides round to neighbouring powers of two, so the message element
  differs by at most the reference's own magnitude ``|m|`` and the shift
  by ``alpha |m|``; the levels also differ by a few ulps where XLA's
  ``exp2`` is not exact (tests/test_torch_natural.py), inside the f32
  noise bound.  For topk, two magnitudes that close across a leaf's k-th
  can trade places in the kept set, moving a message element by at most
  that leaf's k-th magnitude.  Each is held as a bound on every element
  plus a cap on the share of elements beyond f32 noise.
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
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_build
from repro.launch.train import init_state as jax_init
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch import train as port_train
from test_torch_train import ReplayNoise, _np, _port_state, _tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, LR, ALPHA, Q = 4, 1e-2, 0.125, 0.1
TIGHT = 1e-5       # f32 agreement, relative to a leaf's largest entry
RARE = 1e-4        # share of shift elements beyond f32 noise
CONFIGS = {
    "diana_natural": dict(enabled=True, compressor="natural",
                          shift_rule="diana", comm_mode="dense",
                          shift_alpha=ALPHA),
    "ef21_topk": dict(enabled=True, compressor="topk",
                      compressor_kwargs=(("q", Q),), comm_mode="ef21"),
}


def natural_uniforms(state_key, params):
    """The uniforms of one DIANA + natural step at state key
    ``state_key``, along the reference's key chain: the step's split, the
    round's 3-split (k_msg), leaf_key, DIANA's split (the C = Zero half
    draws nothing), worker_keys, and NaturalCompression.encode's uniform
    over the worker's leaf shape."""
    _, sub = jax.random.split(state_key)
    k_msg = jax.random.split(sub, 3)[0]
    draws = []
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
        for j, wk in enumerate(jax.random.split(kq, W)):
            draws.append((i, j, np.asarray(jax.random.uniform(wk,
                                                              leaf.shape))))
    return draws


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reference(request):
    """One reference step from its initial state: the state before and
    after, the round uniforms, the metrics and the batch."""
    name = request.param
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = JaxTrain(learning_rate=LR, total_steps=1, warmup_steps=1,
                    compression=JaxComp(**CONFIGS[name]))
    step = jax.jit(jax_build(cfg, tcfg, make_host_mesh(), W))
    state = jax_init(jax.random.PRNGKey(0), cfg, tcfg, W)
    batch = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    draws = (natural_uniforms(state.key, state.params)
             if name == "diana_natural" else [])
    after, metrics = step(state, {"tokens": batch})
    return name, state, after, draws, {k: np.asarray(v)
                                       for k, v in metrics.items()}, batch


def _message_bound(name, h0, h1, k):
    """Per element, how far a flipped or traded message element can move
    the port's shift from the reference's (see the module docstring)."""
    msg = h1[k] - h0[k]                    # the reference's alpha m / m
    if name == "diana_natural":
        return np.abs(msg)                 # alpha |m|
    w = msg.shape[0]
    flat = np.abs(msg.reshape(w, -1))
    kth = np.array([np.sort(row)[-max(1, round(Q * row.size))]
                    for row in flat])
    return np.broadcast_to(kth.reshape((w,) + (1,) * (msg.ndim - 1)),
                           msg.shape)


def test_step_matches_reference(reference):
    name, before, after, draws, metrics, batch = reference
    cfg = port_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = TrainConfig(learning_rate=LR, total_steps=1, warmup_steps=1,
                       compression=CompressionConfig(**CONFIGS[name]))
    step = port_train.build_train_step(cfg, tcfg, W)
    port, m = step(_port_state(before, ReplayNoise(draws)), _tokens(batch))
    assert not port.noise.draws            # every uniform was consumed
    assert m["bits"].item() == float(metrics["bits"])
    np.testing.assert_allclose(float(m["loss"]), metrics["loss"],
                               rtol=TIGHT)

    h0, h1 = _np(before.h), _np(after.h)
    flipped = total = 0
    for k, ref in h1.items():
        bound = _message_bound(name, h0, h1, k)
        d = np.abs(port.h[k].numpy() - ref)
        noise = TIGHT * np.abs(ref).max()
        assert (d <= bound * 1.001 + noise).all(), k
        flipped += int((d > noise).sum())
        total += d.size
    assert flipped <= RARE * total, (flipped, total)

    for what, ref_tree, got in [("h_bar", _np(after.h_bar), port.h_bar),
                                ("params", _np(after.params), port.params)]:
        off = n = 0
        for k, ref in ref_tree.items():
            d = np.abs(got[k].numpy() - ref)
            assert (d <= 2 * LR).all(), (what, k)
            off += int((d > TIGHT * np.abs(ref).max()).sum())
            n += d.size
        assert off <= 1e-3 * n, (what, off, n)


@pytest.mark.parametrize("flags", [["--comm-mode", "ef21", "--compressor",
                                    "topk"],
                                   ["--comm-mode", "efbv", "--efbv-eta",
                                    "0.5", "--compressor", "natural"]])
def test_cli_error_feedback_modes_run_on_cpu(flags, capsys):
    state = port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "16", "--device",
                             "cpu", *flags])
    out = capsys.readouterr().out
    assert f"comm={flags[1]}" in out and f"rule={flags[1]}" in out
    assert state.step == 2 and state.bits.item() > 0
    assert all(np.isfinite(p.numpy()).all() for p in state.params.values())


@pytest.mark.parametrize("rule,kw", [("ef21", {}),
                                     ("efbv", {"eta": 0.5, "nu": 0.75})])
def test_error_feedback_round_matches_reference(rule, kw):
    """One round of EF21 / EF-BV through the parameter server with the
    top-k codec, from the same gradients and shifts: the messages are
    exact, and g_bar, h and h_bar equal the reference's jitted round bit
    for bit (XLA contracts ``a + c * b`` into one fma, as the training
    step runs it; ``torch.add(..., alpha=c)`` rounds once too)."""
    import jax.numpy as jnp
    import torch

    from repro.comm.channel import SimChannel as JaxSim
    from repro.core.compressors import TopK as JaxTopK
    from repro.core.shift_rules import make_shift_rule as jax_rule
    from repro_torch.comm.channel import make_channel
    from repro_torch.core.compressors import TopK
    from repro_torch.core.shift_rules import make_shift_rule as port_rule
    from repro_torch.weights import flatten_tree

    rng = np.random.default_rng(9)
    shapes = {"a": (3, 400), "b": (37,)}
    grads = {k: rng.standard_normal((W, *s)).astype(np.float32)
             for k, s in shapes.items()}
    h = {k: 0.5 * g[::-1].copy() for k, g in grads.items()}
    h_bar = {k: v.mean(axis=0) for k, v in h.items()}
    j = jax.jit(lambda g, hh, hb: jax_rule(rule, **kw).round(
        JaxTopK(q=Q), jax.random.PRNGKey(0), g, hh, hb, JaxSim()))(
        *({k: jnp.asarray(v) for k, v in t.items()}
          for t in (grads, h, h_bar)))

    def port(t):
        return {k: torch.from_numpy(v.copy()) for k, v in t.items()}

    p = port_rule(rule, **kw).round(TopK(q=Q), None, port(grads), port(h),
                                    port(h_bar), make_channel("sim"))
    assert p[3].item() == float(j[3])
    for ref, got in zip(j[:3], p[:3]):
        for k, r in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        ref)).items():
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
