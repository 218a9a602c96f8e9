"""Port parity for the RandK codec (``repro_torch.core.compressors.RandK``)
against the reference's ``repro.core.compressors.RandK``: the same numpy
inputs, the reference's permutation (``jax.random.permutation`` of the
worker key) replayed through the port's draw object.  Payload values,
indices, decode and ``wire_bits`` are compared BITWISE (values as int32
bit patterns), shared and not shared, at d = 1, 7, 80 and 1000 with q
giving K = 1, K = round(q d) and K = d; and the W-stacked uplink
(``comm.wire.encode_decode_workers``, RandK's ``encode_decode_stacked``)
against the reference's vmapped one, with ``worker_keys``' rule: one
draw for every worker when the pattern is shared.
"""

import jax
import numpy as np
import pytest
import torch

from repro.comm.wire import encode_decode_workers as jax_enc_dec
from repro.comm.wire import worker_keys
from repro.core import compressors as JC
from repro_torch.comm.wire import GeneratorNoise, LeafNoise, encode_decode_workers
from repro_torch.core import compressors as TC


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32


class Perm:
    """A draw object that hands out one fixed permutation."""

    def __init__(self, perm):
        self.perm = np.asarray(perm)

    def permutation(self, d):
        assert d == self.perm.shape[0]
        return torch.from_numpy(self.perm.astype(np.int64))

    def __call__(self, shape):
        raise AssertionError("RandK draws no uniforms")


class LeafReplay:
    """Noise source replaying per-worker permutations for one leaf,
    checking the (leaf, worker) order the port asks in."""

    def __init__(self, draws):
        self.draws = list(draws)

    def permutation(self, leaf, worker, d, part=None):
        l, w, p = self.draws.pop(0)
        assert (l, w, part) == (leaf, worker, None) and p.shape == (d,)
        return torch.from_numpy(np.asarray(p).astype(np.int64))


def bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, F32))
    b = np.ascontiguousarray(np.asarray(b, F32))
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _x(d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(F32) * F32(10.0) ** rng.uniform(
        -20, 20, d).astype(F32)
    if d > 3:
        x[:3] = (0.0, -0.0, 1e-40)       # zeros and a subnormal
    return x


CASES = [(d, q) for d in (1, 7, 80, 1000) for q in (1e-4, 0.25, 1.0)]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("d,q", CASES)
def test_randk_encode_decode_bitwise(d, q, shared):
    x = _x(d, d)
    key = jax.random.PRNGKey(d + int(q * 1000))
    ref = JC.RandK(q=q, shared_pattern=shared)
    port = TC.RandK(q=q, shared_pattern=shared)
    pay, meta = ref.encode(key, x)
    tpay, tmeta = port.encode(Perm(jax.random.permutation(key, d)),
                              torch.from_numpy(x))
    k = TC._k_of(q, d)
    assert tpay["values"].shape == (k,)
    assert bits_equal(pay["values"], tpay["values"])
    idx = meta["indices"] if shared else pay["indices"].data
    tidx = tmeta["indices"] if shared else tpay["indices"].data
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(idx), tidx.numpy())
    assert set(tpay) == set(pay)
    assert port.wire_bits(tpay) == float(ref.wire_bits(pay))
    if not shared:
        assert tpay["indices"].width == pay["indices"].width
    out = ref.decode(pay, meta, jax.ShapeDtypeStruct((d,), np.float32))
    tout = port.decode(tpay, tmeta, TC.ShapeDtype((d,), torch.float32,
                                                  torch.device("cpu")))
    assert bits_equal(out, tout)
    assert port.omega(d) == ref.omega(d)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("d,q", [(7, 0.25), (80, 0.25), (1000, 0.1),
                                 (1, 0.5), (80, 1.0)])
def test_randk_stacked_uplink_bitwise(d, q, shared):
    """W = 5 workers of one leaf (at global position 3): the stacked
    encode and decode against the reference's vmapped one, bits equal,
    the draws asked for in worker order (once, worker None, shared)."""
    w, leaf = 5, 3
    rng = np.random.default_rng(d)
    x = rng.standard_normal((w, d)).astype(F32)
    key = jax.random.fold_in(jax.random.PRNGKey(7), leaf)
    ref = JC.RandK(q=q, shared_pattern=shared)
    port = TC.RandK(q=q, shared_pattern=shared)
    pay, out = jax_enc_dec(ref, key, x)
    wkeys = worker_keys(ref, key, w)
    if shared:
        draws = [(leaf, None, jax.random.permutation(wkeys[0], d))]
    else:
        draws = [(leaf, j, jax.random.permutation(wk, d))
                 for j, wk in enumerate(wkeys)]
    noise = LeafReplay(draws)
    tpays, tout = encode_decode_workers(port, LeafNoise(noise, leaf),
                                        torch.from_numpy(x))
    assert not noise.draws
    assert bits_equal(out, tout)
    assert port.wire_bits(tpays) == float(ref.wire_bits(pay))


def test_randk_stacked_equals_rows():
    """``encode_decode_stacked`` is bit for bit the rows' own ``encode``
    and ``decode`` one by one, on one stream of draws."""
    w, d = 4, 33
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (w, d)).astype(F32))
    codec = TC.RandK(q=0.3)
    a = LeafNoise(GeneratorNoise(5, "cpu"), 0)
    b = LeafNoise(GeneratorNoise(5, "cpu"), 0)
    pay, out = codec.encode_decode_stacked([a.worker(j) for j in range(w)], x)
    like = TC.ShapeDtype((d,), torch.float32, torch.device("cpu"))
    rows = [codec.encode(b.worker(j), x[j]) for j in range(w)]
    for j, (p, m) in enumerate(rows):
        assert bits_equal(out[j], codec.decode(p, m, like))
        assert torch.equal(pay["indices"].data[j], p["indices"].data)
    assert codec.wire_bits(pay) == codec.wire_bits([p for p, _ in rows])


def test_generator_permutation_is_a_permutation():
    noise = GeneratorNoise(0, "cpu")
    for d in (1, 7, 80):
        p = noise.permutation(0, 0, d)
        assert p.dtype == torch.int64
        assert sorted(p.tolist()) == list(range(d))


def test_randk_unbiased_on_generator_draws():
    """E RandK(x) = x: the mean of many draws is within 5 sigma."""
    d, n = 20, 4000
    x = torch.linspace(-1.0, 1.0, d)
    codec = TC.RandK(q=0.25)
    leaf = LeafNoise(GeneratorNoise(3, "cpu"), 0)
    _, out = codec.encode_decode_stacked([leaf.worker(j) for j in range(n)],
                                         x.expand(n, d).contiguous())
    var = codec.omega(d) * x**2
    assert ((out.mean(0) - x).abs() <= 5 * (var / n).sqrt() + 1e-6).all()
