"""Port parity for the production layout of the ring: the ``pod`` tree
stage and the ``model``-sharded rings (``dist.collectives``'s
``q8_ring_tree_mean`` with ``pod_axis`` and ``wspecs``), and the
shared-pattern Rand-K mean (``randk_shared_mean``, the ``randk_shared``
comm mode).

* DIANA's round through ``MeshChannel`` in ``q8_ring`` and
  ``q8_ring_fused`` mode with the worker-stacked specs of
  ``dist.sharding``: the reference's round jitted on 8 fake devices,
  mesh ``(pod, data, model) = (2, 2, 2)``, in a subprocess, against the
  port's on ``HostMesh(pod=2, data=2, model=2)``, 8 workers at the smoke
  qwen3-0.6b leaf shapes, the reference's uniforms replayed by ADDRESS:
  ``g_bar``, ``h``, ``h_bar`` and ``bits`` bitwise.  The reference hands
  every device of its ``shard_map`` the same key, so every pod and every
  model shard of a leaf draws the SAME uniforms, and the replay hands
  each draw out once: the port must reuse it, not draw again.
* ``randk_shared_mean`` bitwise against the reference's, jitted, at
  W = 3, 4 and 5 (the mean is XLA's sum times f32(1/W)), and the DIANA
  round in ``randk_shared`` mode bitwise against the reference's jitted
  round (not against the reference's own lowering test, a known
  failure).
* ``HostMesh(pod=1, data=4)`` runs the ring of ``HostMesh(data=4)``
  bitwise; a mesh of one model shard ignores the specs.
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
from repro_torch.comm.channel import MeshChannel, make_channel
from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_smoke_config
from repro_torch.core.compressors import Int8Stochastic, make_compressor
from repro_torch.core.shift_rules import make_shift_rule
from repro_torch.dist.collectives import q8_ring_tree_mean, randk_shared_mean
from repro_torch.dist.sharding import PSpec, worker_stacked_pspecs
from repro_torch.kernels.q8ring.ops import FusedQ8
from repro_torch.launch.mesh import HostMesh
from repro_torch.launch.train import params_like


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent
W, ALPHA = 8, 0.125
#: the messages' codec: its decode is a kernel in the reference, so XLA
#: cannot fuse it into the local sums (``Int8Stochastic``'s it does, and
#: the port sums those as XLA does:
#: ``test_int8_messages_sum_as_xla_fuses_them``)
MSG_CODEC = "q8_block"


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


class KeyedReplay:
    """Replays the reference's draws by ADDRESS: message uniforms by
    ``(leaf, worker, part)``, ring uniforms by ``(leaf, hop)``, the pod
    stage's by leaf, Rand-K patterns by leaf.  Each draw may be taken
    once; ``done`` says whether all were."""

    def __init__(self, msg=(), ring=(), pod=(), pattern=()):
        self.msg, self.ring = dict(msg), dict(ring)
        self.pod, self.pattern = dict(pod), dict(pattern)

    @staticmethod
    def _take(table, key, shape, dtype=np.float32):
        u = table.pop(key)
        assert u.shape == tuple(shape), (key, u.shape, shape)
        return torch.from_numpy(np.array(u, dtype))

    def uniform(self, leaf, worker, shape, part=None):
        return self._take(self.msg, (leaf, worker, part), shape)

    def ring_uniform(self, leaf, hop, shape):
        return self._take(self.ring, (leaf, hop), shape)

    def pod_uniform(self, leaf, shape):
        return self._take(self.pod, leaf, shape)

    def shared_permutation(self, leaf, d):
        return self._take(self.pattern, leaf, (d,), np.int64)

    def next_round(self):
        pass

    @property
    def done(self):
        return not (self.msg or self.ring or self.pod or self.pattern)


def _smoke_names():
    """The smoke qwen3-0.6b leaves: the port's paths and shapes, in the
    reference's leaf order."""
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    like = params_like(cfg)
    ref = jax.eval_shape(
        lambda k: JM.init_params(k, jax_smoke("qwen3-0.6b").with_(
            dtype="float32")), jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref)] == [
        v.shape for v in like.values()]
    return like


def _inputs(like, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i, (k, v) in enumerate(like.items()):
        g = (rng.standard_normal((W, *v.shape)) * 0.02).astype(np.float32)
        h = (0.5 * g[::-1] + rng.standard_normal(g.shape) * 1e-3).astype(
            np.float32)
        out[f"g/{i:02d}"], out[f"h/{i:02d}"] = g, h
        out[f"hb/{i:02d}"] = h.mean(axis=0).astype(np.float32)
    return out


# The reference's DIANA round through MeshChannel(mode, mesh, wspecs) on 8
# fake devices (pod, data, model) = (2, 2, 2), jitted on unsharded inputs,
# with the worker-stacked specs of its build_channel, and its draws along
# its key chain: k_msg, k_aux, k_agg = split(key, 3); a message draw is
# fold_in(k_msg, leaf), DIANA's split (the Q half), split per worker; the
# ring's fold_in(fold_in(k_agg, leaf), 0) (the data axis), then fold_in
# of the hop (n + 1 for the all-gather), at the shard's chunk layout; the
# pod stage's fold_in(fold_in(k_agg, leaf), 101), at the shard's shape.
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.comm.channel import MeshChannel
    from repro.core.compressors import make_compressor
    from repro.core.shift_rules import make_shift_rule
    from repro.dist.sharding import (params_pspecs, validate_pspecs,
                                     worker_stacked_pspec)
    from repro.kernels.q8ring.ops import q8_layout, ring_chunk_layout

    src, dst, mode, codecs = sys.argv[1:5]
    data = dict(np.load(src))
    names = sorted(k[2:] for k in data if k.startswith("g/"))
    tree = lambda p: [jnp.asarray(data[p + k]) for k in names]
    n, w = 2, data["g/" + names[0]].shape[0]
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    shapes = [jax.ShapeDtypeStruct(data["hb/" + k].shape, jnp.float32)
              for k in names]
    # the reference's rules match parameter names: the leaves carry them
    paths = [p.split("/") for p in str(data["paths"]).split(",")]
    def nest(leaves):
        out = {}
        for path, leaf in zip(paths, leaves):
            d = out
            for part in path[:-1]:
                d = d.setdefault(part, {})
            d[path[-1]] = leaf
        return out
    inner = validate_pspecs(nest(shapes), params_pspecs(nest(shapes)), mesh)
    wspecs = jax.tree_util.tree_map(
        lambda sp: worker_stacked_pspec(mesh, sp), inner,
        is_leaf=lambda x: isinstance(x, P))
    wspecs = validate_pspecs(
        nest([jax.ShapeDtypeStruct((w, *s.shape), s.dtype) for s in shapes]),
        wspecs, mesh)
    flat_specs = jax.tree_util.tree_leaves(
        wspecs, is_leaf=lambda x: isinstance(x, P))
    rule = make_shift_rule("diana", alpha=float(data["alpha"]))
    key = jax.random.PRNGKey(int(data["seed"]))
    ch = MeshChannel(mode, mesh, wspecs=wspecs)
    out = {}
    k_msg, _, k_agg = jax.random.split(key, 3)
    for codec in codecs.split(","):     # each message codec's round
        q = make_compressor(codec)
        g_bar, h, h_bar, bits = jax.jit(lambda k, g, h, hb: rule.round(
            q, k, g, h, hb, ch))(key, nest(tree("g/")), nest(tree("h/")),
                                 nest(tree("hb/")))
        out[codec + ":bits"] = np.asarray(bits)
        for name, t in (("g_bar", g_bar), ("h", h), ("h_bar", h_bar)):
            for k, v in zip(names, jax.tree_util.tree_leaves(t)):
                out[f"{codec}:{name}/{k}"] = np.asarray(v)
        for i, k in enumerate(names):
            shape = data["hb/" + k].shape
            d = int(np.prod(shape))
            _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
            mshape = (q8_layout(d)[2], 128) if codec == "q8_block" else shape
            for j, wk in enumerate(jax.random.split(kq, w)):
                out[f"{codec}:m/{i}/{j}"] = np.asarray(
                    jax.random.uniform(wk, mshape))
    for i, k in enumerate(names):
        shape = data["hb/" + k].shape
        sp = tuple(flat_specs[i])[1:]
        shard = tuple(s // 2 if a == "model" else s
                      for s, a in zip(shape, sp + (None,) * len(shape)))
        ds = int(np.prod(shard))
        out[f"s/{i}"] = np.asarray(shard)
        lk = jax.random.fold_in(k_agg, i)
        for hop in range(n):
            hk = jax.random.fold_in(jax.random.fold_in(lk, 0),
                                    hop if hop < n - 1 else n + 1)
            rshape = ((ring_chunk_layout(ds, n)[0], 128) if mode ==
                      "q8_ring_fused" else (1, -(-ds // n)))
            out[f"r/{i}/{hop}"] = np.asarray(jax.random.uniform(hk, rshape))
        pshape = ((q8_layout(ds)[2], 128) if mode == "q8_ring_fused"
                  else shard)
        out[f"p/{i}"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(lk, 101), pshape))
    np.savez(dst, **out)
    print("REFERENCE_OK")
""")


def _run_reference(tmp_path, inputs, *argv):
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(src), str(dst),
                        *argv], capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(dst))


def _pod_inputs(keys, like):
    return {"seed": np.int64(17), "alpha": np.float64(ALPHA),
            "paths": np.asarray(",".join(keys)), **_inputs(like, 5)}


@pytest.fixture(scope="module")
def pod_reference(tmp_path_factory):
    """``get(mode)``: the reference's outputs and draws for ``mode``, both
    message codecs (``MSG_CODEC`` and ``int8``) from one subprocess,
    made once a mode."""
    cache = {}

    def get(mode):
        if mode not in cache:
            like = _smoke_names()
            cache[mode] = _run_reference(
                tmp_path_factory.mktemp(mode), _pod_inputs(list(like), like),
                mode, f"{MSG_CODEC},int8")
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", ["q8_ring", "q8_ring_fused"])
def test_pod_model_round_bitwise_vs_reference(mode, pod_reference):
    _pod_model_round(mode, MSG_CODEC, pod_reference(mode))


@pytest.mark.parametrize("mode", ["q8_ring", "q8_ring_fused"])
def test_pod_model_round_int8_messages_bitwise_vs_reference(mode,
                                                            pod_reference):
    """The same round with ``Int8Stochastic`` messages, whose decode the
    reference's local sums (2 rows a position) fuse in: one fma a
    worker (``dist.collectives.with_payload_rows``)."""
    _pod_model_round(mode, "int8", pod_reference(mode))


def _pod_model_round(mode, msg_codec, ref):
    like = _smoke_names()
    keys = list(like)
    inputs = _pod_inputs(keys, like)
    # the codec's round and message draws; the aggregation's draws and
    # the shard shapes are the codec's too (one key chain)
    out = {**ref, **{k[len(msg_codec) + 1:]: v for k, v in ref.items()
                     if k.startswith(msg_codec + ":")}}
    n_leaves = len(keys)
    noise = KeyedReplay(
        msg={(i, j, "q"): out[f"m/{i}/{j}"] for i in range(n_leaves)
             for j in range(W)},
        ring={(i, hop): out[f"r/{i}/{hop}"] for i in range(n_leaves)
              for hop in range(2)},
        pod={i: out[f"p/{i}"] for i in range(n_leaves)})
    mesh = HostMesh(pod=2, data=2, model=2)
    wspecs = worker_stacked_pspecs(mesh, like, W)
    # the replayed shard shapes are the ones the port cuts
    sharded = 0
    for i, k in enumerate(keys):
        dims = [j for j, a in enumerate(wspecs[k][1:]) if a == "model"]
        want = list(like[k].shape)
        for j in dims:
            want[j] //= 2
        assert tuple(out[f"s/{i}"]) == tuple(want), k
        sharded += bool(dims)
    assert 0 < sharded < n_leaves      # sharded and replicated leaves both

    def port(prefix):
        return {k: torch.from_numpy(inputs[f"{prefix}{i:02d}"].copy())
                for i, k in enumerate(keys)}

    g_bar, h, h_bar, bits = make_shift_rule("diana", alpha=ALPHA).round(
        make_compressor(msg_codec), noise, port("g/"), port("h/"),
        port("hb/"), MeshChannel(mode=mode, mesh=mesh, wspecs=wspecs))
    assert noise.done
    assert bits.dtype == torch.float32 and bits.item() == float(out["bits"])
    for name, got in [("g_bar", g_bar), ("h", h), ("h_bar", h_bar)]:
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(
                _bits(got[k].numpy()), _bits(out[f"{name}/{i:02d}"]),
                err_msg=f"{name}[{k}]")


def _ring_tree(seed, w=4):
    rng = np.random.default_rng(seed)
    shapes = {"a": (40,), "b": (6, 8), "c": (), "d": (2, 700), "e": (4, 3)}
    return {k: torch.from_numpy((rng.standard_normal((w, *s)) * 0.1).astype(
        np.float32)) for k, s in shapes.items()}


@pytest.mark.parametrize("codec", [Int8Stochastic(), FusedQ8(block_rows=2)])
def test_one_pod_is_the_data_ring(codec):
    """``HostMesh(pod=1, data=4)`` (and the pod axis named) reduces
    bitwise as ``HostMesh(data=4)``; specs on a mesh of one model shard
    change nothing; two model shards of a leaf replicated over ``model``
    change nothing either."""
    g = _ring_tree(3)
    want = q8_ring_tree_mean(AddressedNoise(2, "cpu"), g, HostMesh(data=4),
                             codec=codec)
    specs = {k: PSpec("data", *(["model"] + [None] * (v.dim() - 2))[
        :v.dim() - 1]) for k, v in g.items()}
    for mesh, kw in ((HostMesh(pod=1, data=4), {"pod_axis": "pod"}),
                     (HostMesh(data=4), {"wspecs": specs}),
                     (HostMesh(data=4, model=2),
                      {"wspecs": {k: PSpec("data") for k in g}})):
        got = q8_ring_tree_mean(AddressedNoise(2, "cpu"), g, mesh,
                                codec=codec, **kw)
        for k in want:
            assert torch.equal(got[k].view(torch.int32),
                               want[k].view(torch.int32)), (kw, k)


def test_model_shards_reduce_their_slices():
    """With two model shards each shard's ring reduces its slice of the
    sharded dim: with the same draws for both shards (addressed noise),
    a leaf whose halves are equal reduces to equal halves; the pod
    stage sums the pods' rings; the mean tracks the exact mean within
    the quantization error."""
    g = _ring_tree(4, w=8)
    g["b"] = torch.cat([g["b"][:, :3]] * 2, dim=1)     # equal halves
    specs = {"a": PSpec("data", "model"), "b": PSpec("data", "model", None),
             "c": PSpec("data"), "d": PSpec("data", None, "model"),
             "e": PSpec("data", None, None)}
    mesh = HostMesh(pod=2, data=2, model=2)
    for codec in (Int8Stochastic(), FusedQ8(block_rows=2)):
        got = q8_ring_tree_mean(AddressedNoise(9, "cpu"), g, mesh,
                                codec=codec, pod_axis="pod", wspecs=specs)
        assert torch.equal(got["b"][:3], got["b"][3:])
        for k, x in g.items():
            exact = x.mean(0)
            assert got[k].shape == exact.shape
            tol = 4 * x.abs().max().item() / 127
            assert (got[k] - exact).abs().max().item() <= tol, k


def test_ring_stage_errors():
    mesh = HostMesh(pod=2, data=2, model=2)
    g = {"a": torch.zeros((4, 8))}
    with pytest.raises(ValueError, match="worker positions"):
        q8_ring_tree_mean(None, {"a": torch.zeros((6, 8))}, mesh,
                          pod_axis="pod")
    with pytest.raises(ValueError, match="axis of the mesh"):
        q8_ring_tree_mean(None, g, HostMesh(data=2), pod_axis="pod")
    with pytest.raises(ValueError, match="only 'model'"):
        q8_ring_tree_mean(None, g, mesh, wspecs={"a": PSpec("data", "pod")})
    with pytest.raises(ValueError, match="wspecs"):
        q8_ring_tree_mean(None, g, mesh, wspecs={"b": PSpec("data")})


# -- shared-pattern Rand-K ----------------------------------------------------


_RANDK = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.dist.collectives import randk_shared_mean
    from repro.comm.channel import MeshChannel
    from repro.core.compressors import make_compressor
    from repro.core.shift_rules import make_shift_rule

    src, dst = sys.argv[1:3]
    data = dict(np.load(src))
    names = sorted(k[2:] for k in data if k.startswith("g/"))
    tree = lambda p: {k: jnp.asarray(data[p + k]) for k in names}
    q, key = float(data["q"]), jax.random.PRNGKey(int(data["seed"]))
    out = {}
    mean = jax.jit(lambda k, t: randk_shared_mean(k, t, q))(key, tree("g/"))
    for k in names:
        out["mean/" + k] = np.asarray(mean[k])
    rule = make_shift_rule("diana", alpha=0.125)
    ch = MeshChannel("randk_shared", None, randk_q=q)
    g_bar, h, h_bar, bits = jax.jit(lambda k, g, h, hb: rule.round(
        make_compressor("int8"), k, g, h, hb, ch))(
        key, tree("g/"), tree("h/"), tree("hb/"))
    out["bits"] = np.asarray(bits)
    for name, t in (("g_bar", g_bar), ("h", h), ("h_bar", h_bar)):
        for k in names:
            out[name + "/" + k] = np.asarray(t[k])
    k_msg, _, k_agg = jax.random.split(key, 3)
    w = data["g/" + names[0]].shape[0]
    for i, k in enumerate(names):
        d = int(np.prod(data["hb/" + k].shape))
        out[f"pm/{i}"] = np.asarray(jax.random.permutation(
            jax.random.fold_in(key, i), d))
        out[f"pr/{i}"] = np.asarray(jax.random.permutation(
            jax.random.fold_in(k_agg, i), d))
        _, kq = jax.random.split(jax.random.fold_in(k_msg, i))
        for j, wk in enumerate(jax.random.split(kq, w)):
            out[f"m/{i}/{j}"] = np.asarray(jax.random.uniform(
                wk, data["hb/" + k].shape))
    np.savez(dst, **out)
    print("REFERENCE_OK")
""")


@pytest.mark.parametrize("w", [3, 4, 5])
def test_randk_shared_bitwise_vs_reference(w, tmp_path):
    """``randk_shared_mean`` with the reference's per-leaf pattern, and
    DIANA + int8 through ``MeshChannel("randk_shared")`` with its
    message uniforms and aggregation patterns replayed: bitwise."""
    rng = np.random.default_rng(w)
    shapes = {"a": (40,), "b": (6, 9), "c": (), "d": (3, 1000)}
    inputs = {"seed": np.int64(21 + w), "q": np.float64(0.25)}
    for k, s in shapes.items():
        g = (rng.standard_normal((w, *s)) * 0.02).astype(np.float32)
        h = (0.5 * g[::-1] + rng.standard_normal(g.shape) * 1e-3).astype(
            np.float32)
        inputs["g/" + k], inputs["h/" + k] = g, h
        inputs["hb/" + k] = np.asarray(h.mean(axis=0), np.float32)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", _RANDK, str(src), str(dst)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    out = dict(np.load(dst))
    names = sorted(shapes)

    def port(prefix):
        return {k: torch.from_numpy(inputs[prefix + k].copy()) for k in names}

    noise = KeyedReplay(pattern={i: out[f"pm/{i}"]
                                 for i in range(len(names))})
    mean = randk_shared_mean(noise, port("g/"), 0.25)
    assert noise.done
    for k in names:
        np.testing.assert_array_equal(_bits(mean[k].numpy()),
                                      _bits(out["mean/" + k]), err_msg=k)
    noise = KeyedReplay(
        msg={(i, j, "q"): out[f"m/{i}/{j}"] for i in range(len(names))
             for j in range(w)},
        pattern={i: out[f"pr/{i}"] for i in range(len(names))})
    g_bar, h, h_bar, bits = make_shift_rule("diana", alpha=0.125).round(
        make_compressor("int8"), noise, port("g/"), port("h/"),
        port("hb/"), make_channel("randk_shared", None, randk_q=0.25))
    assert noise.done
    assert bits.item() == float(out["bits"])
    for name, got in [("g_bar", g_bar), ("h", h), ("h_bar", h_bar)]:
        for k in names:
            np.testing.assert_array_equal(_bits(got[k].numpy()),
                                          _bits(out[f"{name}/{k}"]),
                                          err_msg=f"{name}[{k}]")


def test_randk_shared_mean_contract():
    """Exactly K = round(q d) coordinates can survive, the same for every
    worker; the kept values are the workers' mean times d / K (against
    f64, within f32 rounding); bf16 rows come back in bf16."""
    g = _ring_tree(6)
    g["f"] = torch.randn((4, 50), dtype=torch.bfloat16)
    out = randk_shared_mean(AddressedNoise(1, "cpu"), g, 0.2)
    for k, x in g.items():
        d = x[0].numel()
        kk = max(1, round(0.2 * d))
        flat = out[k].reshape(-1)
        assert out[k].dtype == x.dtype
        nz = torch.nonzero(flat).squeeze(1)
        assert nz.numel() <= kk
        mean = x.to(torch.float64).reshape(4, -1).mean(0)[nz] * (d / kk)
        scale = x.abs().max().item() * d / kk
        tol = scale * (1e-2 if x.dtype == torch.bfloat16 else 1e-6)
        torch.testing.assert_close(flat[nz].to(torch.float64), mean,
                                   rtol=0, atol=tol)


def _int8_round(w, channel, seed=0):
    """DIANA with ``Int8Stochastic`` messages over ``w`` workers, the
    reference's round jitted through ``channel`` (its SimChannel or its
    dense MeshChannel) against the port's through the same channel,
    the reference's message uniforms replayed by address.  Returns
    ``(reference outputs, port outputs, replayed uniforms, inputs)``."""
    from repro.comm.channel import MeshChannel as JaxMesh
    from repro.comm.channel import SimChannel as JaxSim
    from repro.core.compressors import Int8Stochastic as JaxInt8
    from repro.core.shift_rules import make_shift_rule as jax_rule
    from repro_torch.comm.channel import SimChannel

    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((w, 2, 32)) * 0.02).astype(np.float32)
    h = (0.5 * g[::-1] + rng.standard_normal(g.shape) * 1e-3).astype(
        np.float32)
    hb = h.mean(0)
    key = jax.random.PRNGKey(1)
    jch, tch = ((JaxSim(), SimChannel()) if channel == "sim" else
                (JaxMesh(mode="dense"), MeshChannel(mode="dense",
                                                    mesh=HostMesh())))
    ref = jax.jit(lambda k, g, h, hb: jax_rule("diana", alpha=ALPHA).round(
        JaxInt8(), k, {"a": g}, {"a": h}, {"a": hb}, jch))(key, g, h, hb)
    k_msg = jax.random.split(key, 3)[0]
    _, kq = jax.random.split(jax.random.fold_in(k_msg, 0))
    msg = {(0, j, "q"): np.asarray(jax.random.uniform(wk, (2, 32)))
           for j, wk in enumerate(jax.random.split(kq, w))}

    def t(a):
        return {"a": torch.from_numpy(a.copy())}

    noise = KeyedReplay(msg=msg)
    got = make_shift_rule("diana", alpha=ALPHA).round(
        Int8Stochastic(), noise, t(g), t(h), t(hb), tch)
    assert noise.done
    return ref, got, msg, (g, h, hb)


def test_int8_messages_sum_as_xla_fuses_them():
    """DIANA with ``Int8Stochastic`` messages, jitted, sums the workers'
    messages as XLA fuses the decode into the reduction -- ``acc =
    fma(q_j, scale_j, acc)``, worker by worker -- and so does the port's
    channel (the messages carry their payloads,
    ``dist.collectives.with_payload_rows``): ``g_bar``, ``h`` and
    ``h_bar`` bitwise, and an fma chain over the payloads is the
    reference's ``h_bar``."""
    from repro_torch.kernels.q8ring.ref import fma_f32

    ref, (g_bar, h1, hb1, _), msg, (g, h, hb) = _int8_round(8, "sim")
    for got, want in ((g_bar, ref[0]), (h1, ref[1]), (hb1, ref[2])):
        assert np.array_equal(_bits(got["a"].numpy()), _bits(want["a"]))
    want = _bits(ref[2]["a"])
    acc = None
    for j in range(8):
        p, _ = Int8Stochastic().encode(
            lambda s, j=j: torch.from_numpy(msg[(0, j, "q")].copy()),
            torch.from_numpy(g[j] - h[j]))
        acc = (p["q"].to(torch.float32) * p["scale"] if acc is None
               else fma_f32(p["q"], p["scale"], acc))
    fused = torch.from_numpy(hb) + ALPHA * (acc * np.float32(1 / 8))
    assert np.array_equal(_bits(fused.numpy()), want)


@pytest.mark.parametrize("channel", ["sim", "mesh"])
@pytest.mark.parametrize("w", [2, 8, 33])
def test_int8_messages_mean_bitwise_vs_reference(w, channel):
    """The worker mean of ``Int8Stochastic`` messages through the
    parameter server and the dense ``MeshChannel``, bitwise the
    reference's jitted round at W = 2, 8 and 33.  Up to 32 rows XLA
    fuses the decode into the sum (one fma a worker); at 33 it sums the
    rounded decodes in its windows of 32, and the port does the same."""
    ref, got, _, _ = _int8_round(w, channel, seed=w)
    for name, a, b in zip(("g_bar", "h", "h_bar"), got[:3], ref[:3]):
        np.testing.assert_array_equal(_bits(a["a"].numpy()),
                                      _bits(b["a"]), err_msg=name)
    assert got[3].item() == float(ref[3])
