"""Port parity for the slice as a whole: DIANA's round aggregated by the
q8 ring on the q8 kernels (``q8_ring_fused``), and the training step in
that mode.

The oracle is the reference's ROUND, not its whole step: the
reference's ``build_train_step`` on a multi-device host mesh raises
``jax._src.core.ShardingTypeError`` at the embedding gather
(``repro/models/layers.py:458``) in both ring modes under jax 0.9.0, in
the same family as the known failure
``test_integration::test_sharded_loss_matches_single_device``.  The
step around the round is held against the reference in dense mode by
``tests/test_torch_train.py``; the round is the only part the ring mode
changes.  So:

* the round, on 4 fake devices in a subprocess (jitted), against the
  port's on a ``HostMesh(data=4)``, from the same gradients and shifts
  (numpy, at the smoke config's leaf shapes) and the reference's
  message and ring uniforms replayed: ``g_bar``, ``h``, ``h_bar`` and
  ``bits`` BITWISE equal;
* three port steps in ``q8_ring_fused`` mode on the CPU against three in
  ``dense`` mode from the same state and noise seed, with the
  tolerances stated at the test.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro_torch.comm.channel import MeshChannel
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.core.shift_rules import make_shift_rule
from repro_torch.kernels.q8ring.ops import FusedQ8
from repro_torch.launch.mesh import HostMesh
from repro_torch.launch.train import build_train_step, init_state


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent
W, ALPHA = 4, 0.125


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


class ReplayNoise:
    """Replays the reference's message and ring uniforms, checking that
    the port asks for them in the reference's order: every message draw
    (leaf, worker), then every ring draw (leaf, hop)."""

    def __init__(self, msg, ring):
        self.msg, self.ring = list(msg), list(ring)

    def uniform(self, leaf, worker, shape, part=None):
        assert part in (None, "q")           # DIANA's Q part, or one part
        l, w, u = self.msg.pop(0)
        assert (l, w) == (leaf, worker) and u.shape == tuple(shape)
        return torch.from_numpy(u.copy())

    def ring_uniform(self, leaf, hop, shape):
        assert not self.msg                  # the messages drew first
        l, h, u = self.ring.pop(0)
        assert (l, h) == (leaf, hop) and u.shape == tuple(shape)
        return torch.from_numpy(u.copy())


# The reference's DIANA round through MeshChannel("q8_ring_fused") on 4
# fake devices, jitted, and its uniforms along its key chain: the round
# splits k_msg, k_aux, k_agg = split(key, 3); a message draw is
# fold_in(k_msg, leaf), DIANA's split (the Q half), split per worker; a
# ring draw is fold_in(k_agg, leaf), fold_in(., 0) for the data axis, then
# fold_in(., hop) for hop < n-1 and fold_in(., n+1) for the all-gather.
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.comm.channel import MeshChannel
    from repro.core.shift_rules import make_shift_rule
    from repro.kernels.q8ring.ops import FusedQ8, q8_layout, ring_chunk_layout

    src, dst = sys.argv[1], sys.argv[2]
    data = dict(np.load(src))
    names = sorted(k[2:] for k in data if k.startswith("g/"))
    tree = lambda p: {k: jnp.asarray(data[p + k]) for k in names}
    n = w = 4
    mesh = jax.make_mesh((n, 1), ("data", "model"))
    rule = make_shift_rule("diana", alpha=float(data["alpha"]))
    key = jax.random.PRNGKey(int(data["seed"]))
    g_bar, h, h_bar, bits = jax.jit(lambda k, g, h, hb: rule.round(
        FusedQ8(), k, g, h, hb, MeshChannel("q8_ring_fused", mesh)))(
        key, tree("g/"), tree("h/"), tree("hb/"))
    out = {"bits": np.asarray(bits)}
    for k in names:
        out["g_bar/" + k] = np.asarray(g_bar[k])
        out["h/" + k] = np.asarray(h[k])
        out["h_bar/" + k] = np.asarray(h_bar[k])
    k_msg, _, k_agg = jax.random.split(key, 3)
    for i, k in enumerate(names):
        d = int(np.prod(data["g/" + k].shape[1:]))
        _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
        for j, wk in enumerate(jax.random.split(kq, w)):
            out[f"m/{i}/{j}"] = np.asarray(
                jax.random.uniform(wk, (q8_layout(d)[2], 128)))
        lk = jax.random.fold_in(jax.random.fold_in(k_agg, i), 0)
        for hop in range(n):
            hk = jax.random.fold_in(lk, hop if hop < n - 1 else n + 1)
            out[f"r/{i}/{hop}"] = np.asarray(
                jax.random.uniform(hk, (ring_chunk_layout(d, n)[0], 128)))
    np.savez(dst, **out)
    print("REFERENCE_OK")
""")


def _smoke_shapes():
    """The smoke config's leaf shapes, in the reference's leaf order, as
    the leaves "00", "01", ... (so both sides flatten them alike)."""
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return {f"{i:02d}": tuple(a.shape)
            for i, a in enumerate(jax.tree_util.tree_leaves(shapes))}


def test_diana_round_bitwise_vs_reference(tmp_path):
    rng = np.random.default_rng(12)
    inputs = {"seed": np.int64(11), "alpha": np.float64(ALPHA)}
    for k, shape in _smoke_shapes().items():
        g = (rng.standard_normal((W, *shape)) * 0.02).astype(np.float32)
        h = (0.5 * g[::-1] + rng.standard_normal(g.shape) * 1e-3).astype(
            np.float32)
        inputs["g/" + k], inputs["h/" + k] = g, h
        inputs["hb/" + k] = h.mean(axis=0).astype(np.float32)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(src), str(dst)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    out = dict(np.load(dst))

    names = sorted(k[2:] for k in inputs if k.startswith("g/"))
    msg = [(i, j, out[f"m/{i}/{j}"]) for i in range(len(names))
           for j in range(W)]
    ring = [(i, hop, out[f"r/{i}/{hop}"]) for i in range(len(names))
            for hop in range(W)]
    noise = ReplayNoise(msg, ring)

    def port(prefix):
        return {k: torch.from_numpy(inputs[prefix + k].copy()) for k in names}

    g_bar, h, h_bar, bits = make_shift_rule("diana", alpha=ALPHA).round(
        FusedQ8(), noise, port("g/"), port("h/"), port("hb/"),
        MeshChannel(mode="q8_ring_fused", mesh=HostMesh(data=W)))
    assert not noise.msg and not noise.ring
    assert bits.dtype == torch.float32 and bits.item() == float(out["bits"])
    for name, got in [("g_bar", g_bar), ("h", h), ("h_bar", h_bar)]:
        for k in names:
            np.testing.assert_array_equal(_bits(got[k].numpy()),
                                          _bits(out[f"{name}/{k}"]),
                                          err_msg=f"{name}[{k}]")


STEPS, LR = 3, 1e-2


def _run(comm_mode):
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    tcfg = TrainConfig(learning_rate=LR, total_steps=STEPS, warmup_steps=1,
                       compression=CompressionConfig(
                           compressor="q8_block", shift_rule="diana",
                           comm_mode=comm_mode, shift_alpha=ALPHA))
    state = init_state(0, cfg, tcfg, W, "cpu")
    step = build_train_step(cfg, tcfg, W, HostMesh(data=W, device="cpu"))
    rng = np.random.default_rng(4)
    losses, bits = [], []
    for _ in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (8, 32))
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(m["loss"].item())
        bits.append(m["bits"].item())
    return state, losses, bits


def test_three_ring_steps_track_dense():
    """Three steps in ``q8_ring_fused`` mode against three in ``dense``
    mode, same state, batches and noise seed.

    * ``bits`` counts the uplink messages only (the reference does not
      charge the ring's own traffic): EXACTLY the dense run's.
    * The first step's messages draw the same uniforms first, so its loss
      is the same bit for bit; the runs part at the aggregation: the
      ring mean differs from the exact mean by its quantization error.
    * AdamW moves each param by at most ~lr per step (its first steps
      normalise g / (|g| + eps)), so the two runs' params lie within
      2 lr per step of each other; and the losses stay within 1% (the
      param difference is a few lr on a loss of ~6).
    """
    ring, ring_loss, ring_bits = _run("q8_ring_fused")
    dense, dense_loss, dense_bits = _run("dense")
    assert ring_bits == dense_bits
    assert ring_loss[0] == dense_loss[0]
    np.testing.assert_allclose(ring_loss, dense_loss, rtol=1e-2)
    assert all(np.isfinite(ring_loss))
    for k, p in ring.params.items():
        d = (p - dense.params[k]).abs().max().item()
        assert d <= 2 * LR * STEPS, (k, d)


@pytest.mark.parametrize("mode", ["dense", "randk_shared", "q8_ring",
                                  "q8_ring_fused", "sim", "ef21", "efbv",
                                  "q8_ring_overlap", "efbv_overlap",
                                  "q8_ring_fused_vjp"])
def test_comm_modes_match_reference(mode):
    """The comm-mode normalisation is the reference's; every mode builds
    a channel over the mesh in its aggregation format (ef21 and efbv:
    dense; the overlap and fused-VJP modes: the q8 ring, through the
    AsyncChannel; ``randk_shared`` with the config's keep fraction)."""
    from repro.comm.channel import aggregation_mode_of as jax_agg
    from repro.configs.base import CompressionConfig as JaxComp
    from repro_torch.comm.channel import aggregation_mode_of, make_channel

    assert aggregation_mode_of(mode) == jax_agg(mode)
    for enabled in (True, False):
        assert CompressionConfig(comm_mode=mode, enabled=enabled
                                 ).aggregation_mode == JaxComp(
            comm_mode=mode, enabled=enabled).aggregation_mode
    mesh = HostMesh(data=2)
    if mode != "sim":
        ch = make_channel(mode, mesh)
        assert (ch.mode, ch.mesh) == (aggregation_mode_of(mode), mesh)
    if mode == "randk_shared":
        from repro.comm.channel import make_channel as jax_make

        cfg = CompressionConfig(comm_mode=mode, randk_q=0.2)
        assert make_channel(cfg, mesh).randk_q == jax_make(JaxComp(
            comm_mode=mode, randk_q=0.2)).randk_q == 0.2
        assert make_channel(mode, mesh, randk_q=0.3).randk_q == 0.3


def test_ring_stages_not_ported_raise():
    """The pod stage and the ``wspecs`` are ported (item 5): on a mesh
    with a ``pod`` axis the channel runs the pod stage, the channel's
    specs reach the ring, and worker rows that do not split over the
    worker positions still raise.  (The stages' parity with the
    reference: ``tests/test_torch_pod_ring.py``.)"""
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.dist.collectives import q8_ring_tree_mean
    from repro_torch.dist.sharding import PSpec

    tree = {"a": torch.ones((4, 8))}
    for mesh, kw in ((HostMesh(data=2, pod=2), {"pod_axis": "pod"}),
                     (HostMesh(data=2, model=2),
                      {"wspecs": {"a": PSpec("data", "model")}})):
        got = q8_ring_tree_mean(AddressedNoise(0, "cpu"), tree, mesh, **kw)
        assert torch.equal(got["a"], torch.ones(8))   # ones quantize exactly
        ch = MeshChannel(mode="q8_ring", mesh=mesh,
                         wspecs=kw.get("wspecs"))
        assert torch.equal(ch.reduce_mean(AddressedNoise(0, "cpu"),
                                          tree)["a"], got["a"])
    with pytest.raises(ValueError):     # 3 worker rows over 2 positions
        q8_ring_tree_mean(None, {"a": torch.zeros((3, 8))}, HostMesh(data=2))
    with pytest.raises(ValueError):     # 6 rows over 2 pods x 2 positions
        q8_ring_tree_mean(None, {"a": torch.zeros((6, 8))},
                          HostMesh(pod=2, data=2), pod_axis="pod")


@pytest.mark.parametrize("mode", ["q8_ring", "q8_ring_fused"])
def test_cli_ring_modes_run_on_cpu(mode, capsys):
    """The CLI takes the ring modes; its worker count is the host mesh's
    (one position on the CPU, where the ring is the exact sum)."""
    from repro_torch.launch import train as port_train

    state = port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "16", "--device",
                             "cpu", "--comm-mode", mode])
    out = capsys.readouterr().out
    assert f"comm={mode}" in out and "workers=1" in out
    assert state.step == 2 and state.bits.item() > 0
    assert all(torch.isfinite(p).all() for p in state.params.values())
