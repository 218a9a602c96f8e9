"""Port parity for the q8 ring all-reduce (``repro_torch.dist.collectives``)
and its send-side kernel ``q8_quantize_chunk_3d``, against the reference.

The reference's ring runs over its mesh's ``data`` axis, one position
per device; it runs here in a subprocess on fake CPU devices
(``--xla_force_host_platform_device_count``, as ``tests/test_dist.py``
does), jitted, and writes its outputs and the uniforms it drew, replayed
along its own key chain, to an ``.npz``.  The port runs every position
in this process on a ``HostMesh`` (its wrappers run their plain
versions on the CPU), from the same inputs and the replayed uniforms.
Everything here is held BITWISE: the chunk quantize, both rings, and the
final division by W, which XLA compiles to a product with f32(1/W).
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

from repro.core.compressors import Int8Stochastic as JaxInt8
from repro.dist.collectives import q8_ring_tree_mean as jax_ring_mean
from repro.kernels.q8ring import kernel as JK
from repro.kernels.q8ring import ops as JO
from repro.kernels.q8ring.ops import FusedQ8 as JaxQ8
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro_torch.core.compressors import Int8Stochastic
from repro_torch.dist.collectives import q8_ring_tree_mean
from repro_torch.kernels.q8ring import kernel as TK
from repro_torch.kernels.q8ring import ops as TO
from repro_torch.kernels.q8ring.ops import FusedQ8
from repro_torch.launch.mesh import HostMesh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent
LEAVES = {"a": (1000,), "b": (33,), "c": (3, 64, 40)}   # none a multiple of n*128
#: (n, W, codec): both codecs at n = 2, 4, 5 with W = 2n, and the main
#: path's W = n = 4 for the fused ring
CASES = [(n, 2 * n, c) for n in (2, 4, 5) for c in ("fused", "int8")] + [
    (4, 4, "fused")]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


class ReplayNoise:
    """Replays the reference's ring uniforms, checking that the port asks
    for them in its (leaf, hop) order and shapes."""

    def __init__(self, draws):
        self.draws = list(draws)

    def ring_uniform(self, leaf, hop, shape):
        l, h, u = self.draws.pop(0)
        assert (l, h) == (leaf, hop) and u.shape == tuple(shape)
        return torch.from_numpy(u.copy())


# The reference, on 5 fake devices: every case of CASES, jitted, with the
# uniforms of its key chain -- leaf key fold_in(key, leaf), the data axis
# fold_in(., 0), hop t < n-1 fold_in(., t), the all-gather fold_in(., n+1).
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=5"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core.compressors import Int8Stochastic
    from repro.dist.collectives import q8_ring_tree_mean
    from repro.kernels.q8ring.ops import FusedQ8, ring_chunk_layout

    src, dst = sys.argv[1], sys.argv[2]
    data = dict(np.load(src))
    out = {}
    key = jax.random.PRNGKey(int(data["seed"]))
    for n, w, name in data["cases"].tolist():
        n, w = int(n), int(w)
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1),
                    ("data", "model"))
        codec = FusedQ8() if name == "fused" else Int8Stochastic()
        tag = f"{n}_{w}_{name}"
        tree = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in data.items()
                if k.startswith(f"in_{tag}/")}
        res = jax.jit(lambda k, t: q8_ring_tree_mean(
            k, t, mesh, worker_axes=("data",), codec=codec))(key, tree)
        for i, (leaf, x) in enumerate(sorted(tree.items())):
            out[f"out_{tag}/{leaf}"] = np.asarray(res[leaf])
            d = int(np.prod(x.shape[1:]))
            if name == "fused":
                shape = (ring_chunk_layout(d, n)[0], 128)
            else:
                shape = (1, -(-d // n))
            lk = jax.random.fold_in(jax.random.fold_in(key, i), 0)
            for hop in range(n):
                hk = jax.random.fold_in(lk, hop if hop < n - 1 else n + 1)
                out[f"u_{tag}/{i}/{hop}"] = np.asarray(
                    jax.random.uniform(hk, shape))
    np.savez(dst, **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Inputs made from a numpy seed, and the reference's outputs and
    uniforms for every case."""
    rng = np.random.default_rng(0)
    inputs = {"seed": np.int64(7)}
    for n, w, name in CASES:
        for leaf, shape in LEAVES.items():
            inputs[f"in_{n}_{w}_{name}/{leaf}"] = rng.standard_normal(
                (w, *shape)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("ring")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs, cases=np.array(CASES))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(src), str(dst)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    return inputs, dict(np.load(dst))


@pytest.mark.parametrize("n,w,name", CASES, ids=[f"n{n}-w{w}-{c}"
                                                  for n, w, c in CASES])
def test_ring_mean_bitwise_vs_reference(reference, n, w, name):
    """``q8_ring_tree_mean`` on a ``HostMesh(data=n)`` from the same
    inputs and uniforms: every output element bitwise equal."""
    inputs, out = reference
    tag = f"{n}_{w}_{name}"
    leaves = sorted(LEAVES)
    tree = {k: torch.from_numpy(inputs[f"in_{tag}/{k}"]) for k in leaves}
    draws = [(i, hop, out[f"u_{tag}/{i}/{hop}"])
             for i in range(len(leaves)) for hop in range(n)]
    noise = ReplayNoise(draws)
    codec = FusedQ8() if name == "fused" else Int8Stochastic()
    got = q8_ring_tree_mean(noise, tree, HostMesh(data=n), codec=codec)
    assert not noise.draws                 # every uniform was consumed
    for k in leaves:
        ref = out[f"out_{tag}/{k}"]
        assert tuple(got[k].shape) == ref.shape and got[k].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(ref),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["fused", "int8"])
def test_one_position_matches_reference(name):
    """One position (the reference on its single device, in-process):
    the ring is the identity, so the mean is the f32 sum over W times
    f32(1/W), and nothing is drawn."""
    assert len(jax.devices()) == 1
    rng = np.random.default_rng(3)
    tree = {k: rng.standard_normal((5, *s)).astype(np.float32)
            for k, s in LEAVES.items()}
    jcodec, tcodec = (JaxQ8(), FusedQ8()) if name == "fused" else (
        JaxInt8(), Int8Stochastic())
    ref = jax.jit(lambda k, t: jax_ring_mean(
        k, t, jax_host_mesh(), worker_axes=("data",), codec=jcodec))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in tree.items()})
    noise = ReplayNoise([])
    got = q8_ring_tree_mean(noise, {k: torch.from_numpy(v)
                                    for k, v in tree.items()},
                            HostMesh(data=1), codec=tcodec)
    for k in tree:
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n", [2, 4, 5])
@pytest.mark.parametrize("rows,block", [(7, 7), (128, 64)])
def test_chunk_quantize_bitwise_vs_reference_kernel(n, rows, block):
    """The plain version of ``q8_quantize_chunk_3d`` (what the wrapper
    runs on the CPU) against the reference's interpreted kernel, every
    chunk id, at a short tile (7 rows: the norm leaves' chunks) and at
    full 64-row tiles; chunk 1 holds an all-zero tile."""
    rng = np.random.default_rng(100 * n + rows)
    chunks = (rng.standard_normal((n, rows, 128)) * 3.0).astype(np.float32)
    chunks[1, :block] = 0.0
    u = rng.random((rows, 128), dtype=np.float32)
    for cid in range(n):
        qj, sj = JK.q8_quantize_chunk_3d(jnp.asarray(chunks), jnp.asarray(u),
                                         cid, block_rows=block)
        qt, st = TK.q8_quantize_chunk_3d(
            torch.from_numpy(chunks), torch.from_numpy(u),
            torch.tensor([cid], dtype=torch.int32), block_rows=block)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
        # and it is the 2-d quantize of that chunk
        q2, s2 = TK.q8_quantize_2d(torch.from_numpy(chunks[cid]),
                                   torch.from_numpy(u), block_rows=block)
        assert torch.equal(qt, q2) and torch.equal(st, s2)


def test_chunk_quantize_checks_its_inputs():
    chunks, u = torch.zeros((3, 8, 128)), torch.zeros((8, 128))
    with pytest.raises(IndexError):
        TK.q8_quantize_chunk_3d(chunks, u, torch.tensor([3], dtype=torch.int32),
                                block_rows=8)
    with pytest.raises(TypeError):
        TK.q8_quantize_chunk_3d(chunks, u, torch.tensor([0]), block_rows=8)
    with pytest.raises(ValueError):
        TK.q8_quantize_chunk_3d(chunks, u[:4], torch.tensor(
            [0], dtype=torch.int32), block_rows=4)
    before = TK.q8_quantize_chunk_3d.launches
    TK.q8_quantize_chunk_3d(chunks, u, torch.tensor([2], dtype=torch.int32),
                            block_rows=8)
    assert TK.q8_quantize_chunk_3d.launches == before   # the CPU launches none


@pytest.mark.parametrize("shape", [(1, 250), (33,), (3, 64, 40)])
def test_int8_codec_matches_reference(shape):
    """``Int8Stochastic`` (registry ``int8``) against the reference's
    jitted encode/decode from the same uniforms: payload, decode and the
    ring receive's one-rounding ``decode_add`` bitwise; wire bits equal."""
    from repro.core.compressors import make_compressor as jax_codec
    from repro_torch.core.compressors import ShapeDtype, make_compressor

    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    acc = rng.standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jc, tc = jax_codec("int8"), make_compressor("int8")
    sds = jax.ShapeDtypeStruct(shape, jnp.float32)

    @jax.jit
    def ref(k, x, acc):
        p, _ = jc.encode(k, x)
        return p, jc.decode(p, {}, sds), acc + jc.decode(p, {}, sds)

    pj, dj, aj = ref(key, jnp.asarray(x), jnp.asarray(acc))
    u = np.asarray(jax.random.uniform(key, shape))
    pt, meta = tc.encode(lambda sh: torch.from_numpy(u.copy()),
                         torch.from_numpy(x))
    like = ShapeDtype(shape, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(pt["q"].numpy(), np.asarray(pj["q"]))
    np.testing.assert_array_equal(_bits(pt["scale"].numpy()),
                                  _bits(pj["scale"]))
    np.testing.assert_array_equal(_bits(tc.decode(pt, meta, like).numpy()),
                                  _bits(dj))
    np.testing.assert_array_equal(
        _bits(tc.decode_add(pt, meta, torch.from_numpy(acc), like).numpy()),
        _bits(aj))
    assert tc.wire_bits(pt) == jc.wire_bits(pj)


@pytest.mark.parametrize("block_rows", [1, 8, 64])
def test_ring_chunk_layout_matches_reference(block_rows):
    for d in [1, 33, 128, 1000, 3 * 64 * 40, 8193, 100_003, 151936 * 1024]:
        for n in (1, 2, 4, 5, 8):
            assert TO.ring_chunk_layout(d, n, block_rows) == \
                JO.ring_chunk_layout(d, n, block_rows), (d, n)


def test_leaf_indices_pin_each_leafs_draws():
    """``leaf_indices`` names the leaf of each ring draw (a leaf's global
    tree position when a tree is reduced in parts); the arithmetic is the
    same as for the default 0, 1, ... from the same uniforms."""
    n, rng = 2, np.random.default_rng(7)
    tree = {k: torch.from_numpy(rng.standard_normal((n, *LEAVES[k]))
                                .astype(np.float32)) for k in ("a", "b")}
    uniforms = {k: [rng.random((1, -(-tree[k][0].numel() // n)),
                               dtype=np.float32) for _ in range(n)]
                for k in tree}

    def draws(ids):
        return [(i, hop, uniforms[k][hop]) for i, k in zip(ids, tree)
                for hop in range(n)]

    base = q8_ring_tree_mean(ReplayNoise(draws((0, 1))), tree, HostMesh(data=n))
    noise = ReplayNoise(draws((3, 7)))
    got = q8_ring_tree_mean(noise, tree, HostMesh(data=n), leaf_indices=(3, 7))
    assert not noise.draws
    for k in tree:
        assert torch.equal(got[k], base[k])
    with pytest.raises(ValueError, match="leaf_indices"):
        q8_ring_tree_mean(ReplayNoise([]), tree, HostMesh(data=n),
                          leaf_indices=(3,))
