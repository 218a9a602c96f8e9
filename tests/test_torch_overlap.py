"""Port parity for the overlap runtime (``repro_torch.comm.overlap``):
``plan_buckets``, the ``AsyncChannel`` and the channels ``make_channel``
builds for the overlap modes.

* ``plan_buckets`` equals the reference's (indices and bytes) on the
  qwen3-0.6b smoke tree at three budgets and per leaf, and rejects the
  budgets the reference rejects.
* The drained ``AsyncChannel`` is BITWISE ``MeshChannel`` in ``dense``
  and ``q8_ring_fused`` over ``HostMesh(data=4)``: ``reduce_mean``,
  ``push_mean`` and the DIANA, EF21 and EF-BV rounds, from one
  ``AddressedNoise`` seed (its draws do not depend on the order of the
  calls, which the bucketed schedule changes); the plan really has more
  than one bucket, and handles finished in any order give the same
  tree.
* The reference's ``AsyncChannel("q8_ring_fused", bucket_bytes=2048)``
  DIANA round, jitted on 4 fake devices in a subprocess (the reference's
  own 8-device overlap tests fail under jax 0.9.0 at a sharding error
  that unsharded inputs avoid), against the port's round with the
  reference's message and ring uniforms replayed by ADDRESS
  (``KeyedReplay``): ``g_bar``, ``h``, ``h_bar`` and ``bits`` bitwise.
"""

import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.overlap import AsyncChannel as JaxAsync
from repro.comm.overlap import plan_buckets as jax_plan
from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro_torch.comm.channel import MeshChannel, make_channel
from repro_torch.comm.overlap import (
    DEFAULT_BUCKET_BYTES,
    AsyncChannel,
    plan_buckets,
)
from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_smoke_config
from repro_torch.core.compressors import ShapeDtype
from repro_torch.core.shift_rules import make_shift_rule
from repro_torch.kernels.q8ring.ops import FusedQ8
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.model import param_specs

ROOT = Path(__file__).resolve().parent.parent
W = 4


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def assert_bitwise(a, b, what=""):
    """Two {path: tensor} trees (or two tensors) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        a, b = {"": a}, {"": b}
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), \
            (what, k)


class KeyedReplay:
    """A noise source replaying draws by ADDRESS, not by order: message
    uniforms by ``(leaf, worker, part)``, ring uniforms by ``(leaf,
    hop)``.  Every draw may be asked for once; ``done`` says whether all
    were."""

    def __init__(self, msg, ring):
        self.msg, self.ring = dict(msg), dict(ring)

    @staticmethod
    def _take(table, key, shape):
        u = table.pop(key)
        assert u.shape == tuple(shape), (key, u.shape, shape)
        return torch.from_numpy(np.array(u, np.float32))

    def uniform(self, leaf, worker, shape, part=None):
        return self._take(self.msg, (leaf, worker, part), shape)

    def ring_uniform(self, leaf, hop, shape):
        return self._take(self.ring, (leaf, hop), shape)

    def next_round(self):
        pass

    @property
    def done(self):
        return not self.msg and not self.ring


# -- plan_buckets ------------------------------------------------------------


def _smoke_trees():
    """The qwen3-0.6b smoke params, W-stacked: the reference's tree of
    ShapeDtypeStructs and the port's {path: ShapeDtype}, same leaf order."""
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    ref = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct((W, *a.shape), a.dtype), shapes)
    port = {path: ShapeDtype((W, *shape), torch.float32, None)
            for path, shape, _ in param_specs(
                get_smoke_config("qwen3-0.6b").with_(dtype="float32"))}
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref)] == [
        s.shape for s in port.values()]
    return ref, port


@pytest.mark.parametrize("budget,per_leaf", [
    (2048, False), (65536, False), (DEFAULT_BUCKET_BYTES, False),
    (1, False), (DEFAULT_BUCKET_BYTES, True)])
def test_plan_buckets_matches_reference(budget, per_leaf):
    """Reverse-layer buckets of whole leaves, the reference's indices and
    bytes: three budgets, an oversize leaf at every leaf (budget 1: each
    leaf its own bucket) and the per-leaf plan."""
    ref, port = _smoke_trees()
    want = jax_plan(ref, budget, per_leaf=per_leaf)
    got = plan_buckets(port, budget, per_leaf=per_leaf)
    assert got.n_leaves == want.n_leaves and len(got) == len(want)
    assert [(b.indices, b.nbytes) for b in got.buckets] == [
        (b.indices, b.nbytes) for b in want.buckets]
    assert sorted(i for b in got.buckets for i in b.indices) == list(
        range(got.n_leaves))
    if budget == 2048:
        assert 1 < len(got) < got.n_leaves     # whole leaves grouped


@pytest.mark.parametrize("budget", [0, -1])
def test_plan_buckets_rejects_bad_budget(budget):
    ref, port = _smoke_trees()
    with pytest.raises(ValueError, match="positive"):
        jax_plan(ref, budget)
    with pytest.raises(ValueError, match="positive"):
        plan_buckets(port, budget)
    with pytest.raises(ValueError, match="positive"):
        AsyncChannel(mesh=HostMesh(data=2), bucket_bytes=budget)


# -- drained AsyncChannel == MeshChannel ---------------------------------------


def _tree(seed, w=W):
    """A W-stacked tree of awkward leaves (a scalar per worker, dims not
    a multiple of 128, one leaf over several q8 tiles)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (40,), "b": (3, 5), "c": (), "d": (2, 700), "e": (7,),
              "f": (300,)}
    return {k: torch.from_numpy(
        (rng.standard_normal((w, *s)) * 0.1).astype(np.float32))
        for k, s in shapes.items()}


def _run(channel, op, seed=3):
    """``op`` through ``channel`` from fresh inputs and a fresh
    ``AddressedNoise``; returns its outputs as a list of trees/tensors."""
    g = _tree(1)
    noise = AddressedNoise(seed, "cpu")
    q = FusedQ8(block_rows=2)
    if op == "reduce_mean":
        return [channel.reduce_mean(noise, g)]
    if op == "push_mean":
        return list(channel.push_mean(q, noise, g))
    rule = make_shift_rule(op, **({"alpha": 0.125} if op == "diana" else
                                  {"eta": 0.5, "nu": 0.75} if op == "efbv"
                                  else {}))
    h = _tree(2)
    h_bar = {k: v.mean(0) for k, v in h.items()}
    g_bar, h1, hb1, bits = rule.round(q, noise, g, h, h_bar, channel)
    return [g_bar, h1, hb1, bits]


@pytest.mark.parametrize("mode", ["dense", "q8_ring_fused"])
@pytest.mark.parametrize("op", ["reduce_mean", "push_mean", "diana", "ef21",
                                "efbv"])
def test_drained_async_is_bitwise_mesh(mode, op):
    mesh = HostMesh(data=W)
    channel = AsyncChannel(mode=mode, mesh=mesh, bucket_bytes=1024)
    assert len(channel.reduce_start(AddressedNoise(0, "cpu"),
                                     _tree(1)).handles) > 1
    got = _run(channel, op)
    want = _run(MeshChannel(mode=mode, mesh=mesh), op)
    for a, b in zip(got, want):
        assert_bitwise(a, b, f"{mode} {op}")


def test_handles_finish_in_any_order():
    """``finish`` over the handles shuffled, and the handles consumed one
    by one, give the tree the in-order drain gives."""
    channel = AsyncChannel(mode="q8_ring_fused", mesh=HostMesh(data=W),
                           bucket_bytes=512)
    want = channel.reduce_mean(AddressedNoise(5, "cpu"), _tree(1))
    inflight = channel.reduce_start(AddressedNoise(5, "cpu"), _tree(1))
    handles = list(inflight.handles)
    assert len(handles) > 2
    random.Random(0).shuffle(handles)
    got = channel.finish(inflight._replace(handles=tuple(handles)))
    assert_bitwise({k: m.value() for k, m in got.items()}, want)
    one_by_one = {}
    for h in handles:
        for i, m in zip(h.bucket.indices, h.wait()):
            one_by_one[inflight.keys[i]] = m.value()
    assert_bitwise({k: one_by_one[k] for k in want}, want)
    with pytest.raises(ValueError, match="cover"):
        channel.finish(inflight._replace(handles=tuple(handles[1:])))


# -- the reference's AsyncChannel round ------------------------------------------


# The reference's DIANA round through AsyncChannel("q8_ring_fused",
# bucket_bytes=2048) on 4 fake devices, jitted, on unsharded inputs, and
# its uniforms along its key chain: k_msg, k_aux, k_agg = split(key, 3); a
# message draw is fold_in(k_msg, leaf), DIANA's split (the Q half), split
# per worker; a ring draw fold_in(k_agg, leaf), fold_in(., 0) for the data
# axis, then fold_in(., hop) for hop < n-1 and fold_in(., n+1) for the
# all-gather.
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.comm.overlap import AsyncChannel
    from repro.core.shift_rules import make_shift_rule
    from repro.kernels.q8ring.ops import FusedQ8, q8_layout, ring_chunk_layout

    src, dst = sys.argv[1], sys.argv[2]
    data = dict(np.load(src))
    names = sorted(k[2:] for k in data if k.startswith("g/"))
    tree = lambda p: {k: jnp.asarray(data[p + k]) for k in names}
    n = w = 4
    mesh = jax.make_mesh((n, 1), ("data", "model"))
    channel = AsyncChannel(mode="q8_ring_fused", mesh=mesh, bucket_bytes=2048)
    g = tree("g/")
    print("BUCKETS", len(channel._plan(g)))
    rule = make_shift_rule("diana", alpha=float(data["alpha"]))
    key = jax.random.PRNGKey(int(data["seed"]))
    g_bar, h, h_bar, bits = jax.jit(lambda k, g, h, hb: rule.round(
        FusedQ8(), k, g, h, hb, channel))(key, g, tree("h/"), tree("hb/"))
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


def test_async_diana_round_bitwise_vs_reference(tmp_path):
    shapes = {"a": (40,), "b": (3, 5), "c": (), "d": (2, 700), "e": (7,),
              "f": (300,), "g": (9000,)}
    rng = np.random.default_rng(7)
    inputs = {"seed": np.int64(13), "alpha": np.float64(0.125)}
    for k, s in shapes.items():
        g = (rng.standard_normal((W, *s)) * 0.02).astype(np.float32)
        h = (0.5 * g[::-1] + rng.standard_normal(g.shape) * 1e-3).astype(
            np.float32)
        inputs["g/" + k], inputs["h/" + k] = g, h
        inputs["hb/" + k] = np.asarray(h.mean(axis=0), np.float32)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(src), str(dst)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    out = dict(np.load(dst))
    names = sorted(shapes)
    noise = KeyedReplay(
        {(i, j, "q"): out[f"m/{i}/{j}"] for i in range(len(names))
         for j in range(W)},
        {(i, hop): out[f"r/{i}/{hop}"] for i in range(len(names))
         for hop in range(W)})

    def port(prefix):
        return {k: torch.from_numpy(inputs[prefix + k].copy()) for k in names}

    channel = AsyncChannel(mode="q8_ring_fused", mesh=HostMesh(data=W),
                           bucket_bytes=2048)
    g = port("g/")
    assert f"BUCKETS {len(channel._plan(g))}" in r.stdout
    assert 1 < len(channel._plan(g)) < len(names)
    g_bar, h, h_bar, bits = make_shift_rule("diana", alpha=0.125).round(
        FusedQ8(), noise, g, port("h/"), port("hb/"), channel)
    assert noise.done
    assert bits.dtype == torch.float32 and bits.item() == float(out["bits"])
    for name, got in [("g_bar", g_bar), ("h", h), ("h_bar", h_bar)]:
        for k in names:
            np.testing.assert_array_equal(_bits(got[k].numpy()),
                                          _bits(out[f"{name}/{k}"]),
                                          err_msg=f"{name}[{k}]")


# -- make_channel --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "q8_ring", "q8_ring_fused", "sim",
                                  "ef21", "efbv", "q8_ring_overlap",
                                  "efbv_overlap", "q8_ring_fused_vjp"])
def test_make_channel_builds_the_references_channel(mode):
    """The class the reference builds (AsyncChannel for the overlap modes,
    per leaf for the fused one, with the default or the config's budget);
    ``bucket_bytes`` rejected for every other mode, as the reference does."""
    from repro.comm.channel import make_channel as jax_make
    from repro.configs.base import CompressionConfig as JaxComp
    from repro_torch.configs.base import CompressionConfig

    mesh = HostMesh(data=2)
    ref, got = jax_make(mode), make_channel(mode, mesh)
    assert type(got).__name__ == type(ref).__name__
    if isinstance(ref, JaxAsync):
        assert (got.mode, got.per_leaf, got.bucket_bytes) == (
            ref.mode, ref.per_leaf, ref.bucket_bytes)
        assert make_channel(mode, mesh, bucket_bytes=4096).bucket_bytes == \
            jax_make(mode, bucket_bytes=4096).bucket_bytes
        cfg = CompressionConfig(comm_mode=mode, overlap_bucket_bytes=512)
        assert make_channel(cfg, mesh).bucket_bytes == jax_make(JaxComp(
            comm_mode=mode, overlap_bucket_bytes=512)).bucket_bytes == 512
    else:
        with pytest.raises(ValueError, match="bucket_bytes"):
            jax_make(mode, bucket_bytes=4096)
        with pytest.raises(ValueError, match="bucket_bytes"):
            make_channel(mode, mesh, bucket_bytes=4096)


def test_async_channel_items_not_ported_raise():
    """Nothing of the channel raises any more: ``obs`` (the
    ``StampRecorder``, ported with obs) stamps the ``reduce_start`` and
    ``finish`` windows of the drained reduction and leaves its means
    bitwise as they were; since item 5 was ported the channel takes
    ``wspecs`` and the ``randk_shared`` mode, and its drained rounds are
    ``MeshChannel``'s with them: each bucket reduces with the specs of
    its own leaves."""
    from repro_torch.obs.trace import StampRecorder

    rec = StampRecorder()
    stamped = AsyncChannel(mode="dense", mesh=HostMesh(data=2),
                           bucket_bytes=1024, obs=rec)
    plain = AsyncChannel(mode="dense", mesh=HostMesh(data=2),
                         bucket_bytes=1024)
    g = _tree(1)
    got = stamped.reduce_mean(AddressedNoise(3, "cpu"), g)
    want = plain.reduce_mean(AddressedNoise(3, "cpu"), g)
    for k in want:
        assert_bitwise(got[k], want[k], f"stamped {k}")
    assert [n for n, _, _ in rec.events] == ["reduce_start", "finish"]
    assert all(t1 >= t0 for _, t0, t1 in rec.events)
    from repro_torch.dist.sharding import PSpec

    mesh = HostMesh(data=2, model=2)
    g = _tree(1)
    wspecs = {k: PSpec("data", *([None] * (v.dim() - 1))) for k, v in
              g.items()}
    wspecs["d"] = PSpec("data", None, "model")      # (W, 2, 700)
    wspecs["f"] = PSpec("data", "model")            # (W, 300)
    for mode in ("randk_shared", "q8_ring_fused", "q8_ring"):
        channel = AsyncChannel(mode=mode, mesh=mesh, bucket_bytes=1024,
                               wspecs=wspecs, randk_q=0.25)
        assert len(channel._plan(g)) > 1
        want = MeshChannel(mode=mode, mesh=mesh, wspecs=wspecs, randk_q=0.25)
        for op in ("reduce_mean", "diana"):
            for a, b in zip(_run(channel, op), _run(want, op)):
                assert_bitwise(a, b, f"{mode} {op}")


@pytest.mark.parametrize("mode", ["q8_ring_overlap", "efbv_overlap",
                                  "q8_ring_fused_vjp"])
def test_cli_new_modes_run_on_cpu(mode, capsys):
    """The CLI takes the three modes (one ring position on the CPU)."""
    from repro_torch.launch import train as port_train

    state = port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "16", "--device",
                             "cpu", "--comm-mode", mode,
                             "--compressor", "q8_block"])
    out = capsys.readouterr().out
    assert f"comm={mode}" in out and "workers=1" in out
    rule = "efbv" if mode == "efbv_overlap" else "diana"
    assert f"rule={rule}" in out
    assert state.step == 2 and state.bits.item() > 0
    assert state.noise.round == 2
    assert all(torch.isfinite(p).all() for p in state.params.values())
