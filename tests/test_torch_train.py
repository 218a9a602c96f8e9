"""Port parity for the slice as a whole: three steps of
``repro_torch.launch.train.build_train_step`` (DIANA + the blockwise q8
codec + dense aggregation, 4 workers, batch 8, seq 32, AdamW) against
``repro.launch.train.build_train_step`` on the qwen3-0.6b smoke config,
from one state carried from the reference, with the reference's round
uniforms replayed through the port's noise source.

What can and cannot be bitwise:

* ``bits`` is structural (payload shapes summed in f32 in leaf order):
  EXACTLY equal.
* The gradients agree to ~1e-6 of their largest entry, not bitwise (see
  test_torch_model.py).  Stochastic rounding turns that into rare
  discrete differences: where ``frac(x / scale)`` lies within an ulp of
  the uniform, the two sides round to neighbouring lattice points, so
  one message element differs by one lattice step (its tile's
  ``scale``) and its shift by ``alpha * scale``.  Measured: 11-12 such
  elements of 1.4 M per step.  That is the bound the per-step test
  states: every shift element within ``alpha`` lattice steps of its tile
  (plus f32 noise), and at most 1e-4 of the elements that far off.
* AdamW's first steps normalise ``g / (|g| + eps)``, so a gradient entry
  near zero that moved by a lattice step or by cancellation noise moves
  its param by up to ``2 * lr``; such entries are rare (<= 1e-3 of the
  params) and the rest agree to 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.configs.base import TrainConfig as JaxTrain
from repro.kernels.q8ring.ops import q8_layout
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_train_step as jax_build
from repro.launch.train import init_state as jax_init
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.launch import train as port_train
from repro_torch.weights import flatten_tree, state_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, STEPS, LR, ALPHA = 4, 3, 1e-2, 0.125
COMP = dict(enabled=True, compressor="q8_block", shift_rule="diana",
            comm_mode="dense", shift_alpha=ALPHA)
TIGHT = 1e-5       # f32 agreement, relative to a leaf's largest entry
RARE = 1e-4        # share of shift elements one lattice step off


class ReplayNoise:
    """Noise source that replays the reference's uniforms, checking that
    the port asks for them in the reference's (leaf, worker) order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def uniform(self, leaf, worker, shape, part=None):
        assert part in (None, "q")           # DIANA's Q part, or one part
        l, w, u = self.draws.pop(0)
        assert (l, w) == (leaf, worker) and u.shape == tuple(shape)
        return torch.from_numpy(u.copy())

    def next_round(self):
        """The step ends its round; the replayed draws go on in order."""


def shift_round_uniforms(key, params, diana=True, w=W):
    """The uniforms the reference's ``Channel.shift_round`` draws with
    round key ``key``, along its own key chain: the 3-split (k_msg),
    leaf_key, DIANA's split (kq; the C = Zero half draws nothing),
    worker_keys, and FusedQ8.encode's uniform over the padded lanes.
    ``params`` gives the per-worker leaf shapes."""
    k_msg = jax.random.split(key, 3)[0]
    draws = []
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        kq = jax.random.fold_in(k_msg, i)
        if diana:
            _, kq = jax.random.split(kq)
        _, _, rows_pad = q8_layout(int(np.prod(leaf.shape)))
        for j, wk in enumerate(jax.random.split(kq, w)):
            draws.append(
                (i, j, np.asarray(jax.random.uniform(wk, (rows_pad, 128)))))
    return draws


def round_uniforms(state_key, params):
    """The uniforms of one train step at state key ``state_key`` (the
    step splits the round key off first)."""
    _, sub = jax.random.split(state_key)
    return shift_round_uniforms(sub, params)


def _np(t):
    return None if t is None else flatten_tree(
        jax.tree_util.tree_map(np.asarray, t))


def _port_state(js, noise):
    return state_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params),
        jax.tree_util.tree_map(np.asarray, js.opt.m),
        jax.tree_util.tree_map(np.asarray, js.opt.v), int(js.opt.step),
        jax.tree_util.tree_map(np.asarray, js.h),
        jax.tree_util.tree_map(np.asarray, js.h_bar),
        step=int(js.step), bits=float(js.bits), noise=noise)


@pytest.fixture(scope="module")
def reference():
    """The reference's trajectory: states before/after every step, the
    round uniforms of every step, the metrics and the batches."""
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = JaxTrain(learning_rate=LR, total_steps=STEPS, warmup_steps=1,
                    compression=JaxComp(**COMP))
    step = jax.jit(jax_build(cfg, tcfg, make_host_mesh(), W))
    state = jax_init(jax.random.PRNGKey(0), cfg, tcfg, W)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
               for _ in range(STEPS)]
    states, draws, metrics = [state], [], []
    for b in batches:
        draws.append(round_uniforms(state.key, state.params))
        state, m = step(state, {"tokens": b})
        states.append(state)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return states, draws, metrics, batches


def _port_step():
    cfg = port_smoke("qwen3-0.6b").with_(dtype="float32")
    tcfg = TrainConfig(learning_rate=LR, total_steps=STEPS, warmup_steps=1,
                       compression=CompressionConfig(**COMP))
    return port_train.build_train_step(cfg, tcfg, W)


def _tokens(b):
    return {"tokens": torch.from_numpy(b).long()}


def _lattice(msg, block_rows=64):
    """Per-element lattice step of the reference's q8 messages: each
    worker row flattened, tiled as FusedQ8 tiles it, max|m| / 127 per
    tile (the element at the tile max is quantized to +-127)."""
    w = msg.shape[0]
    out = np.empty_like(msg)
    for j in range(w):
        flat = msg[j].ravel()
        _, block, rows_pad = q8_layout(flat.size, block_rows)
        pad = rows_pad * 128 - flat.size
        tiles = np.pad(np.abs(flat), (0, pad)).reshape(-1, block * 128)
        step = np.repeat(tiles.max(axis=1) / 127.0, block * 128)
        out[j] = step[:flat.size].reshape(msg.shape[1:])
    return out


def test_step_matches_reference_from_its_state(reference):
    """Each step run by the port from the reference's state before it,
    compared with the reference's state after it."""
    states, draws, metrics, batches = reference
    step = _port_step()
    for s in range(STEPS):
        before, after = states[s], states[s + 1]
        port, m = step(_port_state(before, ReplayNoise(draws[s])),
                       _tokens(batches[s]))
        assert not port.noise.draws          # every uniform was consumed
        assert port.step == int(after.step)
        assert m["bits"].dtype == torch.float32
        assert m["bits"].item() == float(metrics[s]["bits"])
        np.testing.assert_allclose(float(m["loss"]), metrics[s]["loss"],
                                   rtol=TIGHT)

        h0, h1 = _np(before.h), _np(after.h)
        flipped = total = 0
        for k, ref in h1.items():
            # the reference's decoded messages, and their lattice steps
            lat = _lattice((ref - h0[k]) / ALPHA)
            d = np.abs(port.h[k].numpy() - ref)
            noise = TIGHT * np.abs(ref).max()
            assert (d <= ALPHA * lat * 1.001 + noise).all(), k
            flipped += int((d > noise).sum())
            total += d.size
        assert flipped <= RARE * total, (flipped, total)

        for name, ref_tree, got in [("h_bar", _np(after.h_bar), port.h_bar),
                                    ("params", _np(after.params),
                                     port.params)]:
            off = n = 0
            for k, ref in ref_tree.items():
                d = np.abs(got[k].numpy() - ref)
                assert (d <= 2 * LR).all(), (name, k)
                off += int((d > TIGHT * np.abs(ref).max()).sum())
                n += d.size
            assert off <= 1e-3 * n, (name, off, n)


def test_three_steps_match_reference(reference):
    """Three free-running port steps from the reference's initial state:
    bits exactly, loss to f32 precision, and params/shifts within three
    steps of the per-step bound (the second and third steps also see the
    first step's differences in their gradients)."""
    states, draws, metrics, batches = reference
    step = _port_step()
    port = _port_state(states[0], ReplayNoise([d for r in draws for d in r]))
    for s in range(STEPS):
        port, m = step(port, _tokens(batches[s]))
        assert m["bits"].item() == float(metrics[s]["bits"])
        np.testing.assert_allclose(float(m["loss"]), metrics[s]["loss"],
                                   rtol=TIGHT)
    assert not port.noise.draws
    final = states[-1]
    hs = [_np(st.h) for st in states]
    # shifts and their mean: at most one lattice step (the leaf's
    # largest) per step per element
    for name, ref_tree, got in [("h", hs[-1], port.h),
                                ("h_bar", _np(final.h_bar), port.h_bar)]:
        for k, ref in ref_tree.items():
            lat = sum(_lattice((hs[s + 1][k] - hs[s][k]) / ALPHA).max()
                      for s in range(STEPS))
            d = np.abs(got[k].numpy() - ref)
            assert d.max() <= ALPHA * lat * 1.001 + TIGHT * np.abs(ref).max(), (
                name, k)
    for k, ref in _np(final.params).items():
        d = np.abs(port.params[k].numpy() - ref)
        assert d.max() <= 2 * LR * STEPS, k
    assert port.bits.item() == float(final.bits)


@pytest.mark.parametrize("channel", ["sim", "dense"])
@pytest.mark.parametrize("rule", ["fixed", "diana"])
def test_shift_round_matches_reference(rule, channel):
    """One round of each ported rule through each ported channel, on a
    small tree with a leaf spanning several q8 tiles, one short tile and
    one scalar-sized leaf, from the same gradients, shifts and uniforms:
    bitwise -- the codec, the worker mean (summed in XLA's order, times
    f32(1/W)) and the shift update."""
    _shift_round_bitwise(rule, channel, W)


@pytest.mark.parametrize("channel", ["sim", "dense"])
@pytest.mark.parametrize("rule", ["fixed", "diana"])
@pytest.mark.parametrize("w", [3, 10])
def test_shift_round_bitwise_at_other_worker_counts(w, rule, channel):
    """The same round at worker counts that are not powers of two, where
    ``torch.mean``'s order differed from the reference's."""
    _shift_round_bitwise(rule, channel, w)


def _shift_round_bitwise(rule, channel, w):
    from repro.comm.channel import SimChannel as JaxSim
    from repro.comm.channel import MeshChannel as JaxMesh
    from repro.core.shift_rules import make_shift_rule as jax_rule
    from repro.kernels.q8ring.ops import FusedQ8 as JaxQ8
    from repro_torch.comm.channel import make_channel
    from repro_torch.core.shift_rules import make_shift_rule as port_rule
    from repro_torch.kernels.q8ring.ops import FusedQ8

    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4000), "b": {"c": (200,), "d": (1,)}}
    grads = jax.tree_util.tree_map(
        lambda s: rng.standard_normal((w, *s)).astype(np.float32),
        shapes, is_leaf=lambda s: isinstance(s, tuple))
    kw = {"alpha": ALPHA} if rule == "diana" else {}
    jr, pr = jax_rule(rule, **kw), port_rule(rule, **kw)
    if rule == "diana":
        h = jax.tree_util.tree_map(lambda g: 0.5 * g[::-1].copy(), grads)
        h_bar = jax.tree_util.tree_map(lambda x: x.mean(axis=0), h)
    else:
        h = h_bar = None
    key = jax.random.PRNGKey(11)
    jch = JaxSim() if channel == "sim" else JaxMesh(mode="dense")
    # jitted, as the reference runs its round (XLA folds the mean's
    # f32(1/W) into the shift updates that consume it)
    g_bar, h1, hb1, bits = jax.jit(
        lambda g, s, sb: jr.round(JaxQ8(), key, g, s, sb, jch))(
            grads, h, h_bar)

    def port(t):
        return None if t is None else {
            k: torch.from_numpy(np.array(v)) for k, v in flatten_tree(t).items()}

    like = jax.tree_util.tree_map(lambda g: g[0], grads)
    noise = ReplayNoise(shift_round_uniforms(key, like, rule == "diana", w))
    pg, ph, phb, pbits = pr.round(FusedQ8(), noise, port(grads), port(h),
                                  port(h_bar), make_channel(channel))
    assert not noise.draws
    assert pbits.item() == float(bits)
    for ref, got in [(g_bar, pg), (h1, ph), (hb1, phb)]:
        if ref is None:
            assert got is None
            continue
        for k, r in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        ref)).items():
            np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                          r.view(np.int32), err_msg=k)


@pytest.mark.parametrize("flags", [[], ["--shift-rule", "fixed"],
                                   ["--no-compression"]])
def test_cli_runs_on_cpu(flags, capsys):
    state = port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                             "--batch", "4", "--seq", "16", "--device", "cpu",
                             *flags])
    out = capsys.readouterr().out
    assert "step    1" in out and "compressor=natural" in out
    assert state.step == 2
    assert (state.bits.item() > 0) == ("--no-compression" not in flags)
    assert (state.h is None) == bool(flags)
    assert all(torch.isfinite(p).all() for p in state.params.values())
