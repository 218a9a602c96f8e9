"""The natural codec's DIANA message as one kernel a worker and leaf
(``kernels.natural.kernel.natural_message``, launched by
``NaturalCompression.shifted_round_trip`` on the card, which
``comm.wire.shifted_message_workers`` and ``shifted_message_row`` call).

On the CPU:

* the codec's ``shifted_round_trip`` off the card is its own round trip
  ``decode(encode(g - h))`` a row and counts no launch; the wrapper
  takes CUDA tensors only; its checks;
* a NumPy transliteration of the kernel's element function
  (``natural.cu``: ``diff_f32``/``diff_bf16`` then ``message_one``)
  against the codec, bit for bit, on the special cases the source writes
  out: +-0, subnormal g, h and g - h, NaN, +-inf, |g - h| at and just
  below every power of two and near 2^127, u = 0 and u just under 1;
* the helper's plain path, and its kernel route through the seam
  (``compressors._message_kernel`` hands the CPU tensors a stand-in that
  makes the wrapper's checks and computes the codec's round trip),
  against the parent's path (``g - h`` through
  ``encode_decode_workers``): the same messages and the same f32 bit
  counter, for W-stacked leaves of several shapes under
  ``AddressedNoise`` and ``GeneratorNoise``;
* ``message_leaf_worker`` is row j of ``message_leaf`` on both routes;
* non-contiguous rows still reach the kernel, made contiguous; a dtype
  the kernel cannot take raises there;
* a ``q8_block`` leaf, a stateless rule (no shift) and the other codecs
  never reach the kernel;
* the codec's shape-only ``payload_like`` (the route's bits) is its
  ``encode``'s payload on meta tensors.

On the card (``card`` marker, skipped where there is no CUDA device):
the kernel bitwise the codec on the edge sets, in f32 and bf16, at n =
1, 3, 127, 129 and 4,096, through a worker row at an unaligned offset
of a W-stacked leaf; and ``DianaShift.message`` over qwen3's leaves at
the smoke size against the plain ``encode_decode_workers`` on ``g -
h``: messages and bits equal, one launch a leaf and worker.  On the
card::

    PYTHONPATH=src python -m pytest -m card tests/test_torch_natural_message.py
"""

import numpy as np
import pytest
import torch

from repro_torch.comm import wire
from repro_torch.comm.wire import (AddressedNoise, GeneratorNoise, LeafNoise,
                                   encode_decode_workers, worker_draws)
from repro_torch.core import compressors
from repro_torch.core.compressors import (NaturalCompression, ShapeDtype,
                                          f32_bits, make_compressor)
from repro_torch.core.shift_rules import (DianaShift, FixedShift,
                                          make_shift_rule)
from repro_torch.kernels.natural import kernel as K
from repro_torch.kernels.natural.kernel import natural_message
from repro_torch.spans import SpanRecorder, recording

F32 = np.float32
TINY = F32(2.0 ** -126)
NAT = NaturalCompression()


@pytest.fixture(scope="module")
def _bounded_jit_cache():
    """Overrides the suite's fixture, which clears JAX's caches after each
    module: this module compiles nothing with JAX, and the card's machine
    has none."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small work: one intra-op thread, so that test processes running
    side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of an f32 or bf16 tensor, on the CPU."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# -- the edge set ------------------------------------------------------------


def edge_set(seed=0):
    """(g, h, u) f32 NumPy arrays: the special values against each other;
    g - h at, one and two ulps below every power of two of a normal f32
    and near 2^127, both signs, h = 0 and h subnormal; u = 0, u just
    under 1 and uniform draws over every pair."""
    special = np.array([0.0, -0.0, 1e-39, -1e-39, 1e-38, -3e-38, TINY,
                        -TINY, np.nan, np.inf, -np.inf, 1.0, -2.5, 3.0e38,
                        -3.4e38, 2.0 ** 127], F32)
    gs, hs = (a.ravel() for a in np.meshgrid(special, special))
    p2 = np.ldexp(F32(1), np.arange(-126, 128)).astype(F32)
    below1 = np.nextafter(p2, F32(0))
    near_max = np.array([1.5 * 2.0 ** 127, np.finfo(F32).max,
                         1.0000001 * 2.0 ** 127], F32)
    lat = np.concatenate([p2, below1, np.nextafter(below1, F32(0)), near_max])
    lat = np.concatenate([lat, -lat])
    lat_g = np.concatenate([lat, lat])
    lat_h = np.concatenate([np.zeros_like(lat), np.full_like(lat, 1e-39)])
    g = np.concatenate([gs, lat_g])
    h = np.concatenate([hs, lat_h])
    rng = np.random.default_rng(seed)
    u = rng.random(g.size, dtype=F32)
    u[::3] = 0.0
    u[1::3] = np.nextafter(F32(1), F32(0))
    # every point again with the other draws
    g, h = np.concatenate([g, g]), np.concatenate([h, h])
    u = np.concatenate([u, rng.random(u.size, dtype=F32)])
    return g, h, u


def _kernel_model(g, h, u, bf16: bool):
    """``natural.cu``'s element function in NumPy: ``diff_f32`` (one f32
    subtraction, nothing flushed before it) or ``diff_bf16`` (the f32
    difference of the widened inputs rounded to nearest even to bf16),
    then ``message_one``.  g, h: f32 arrays (bf16 values widened)."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = (g - h).astype(F32)
        if bf16:
            d = torch.from_numpy(d).to(torch.bfloat16).float().numpy()
        x = np.where(np.abs(d) < TINY, d * F32(0), d).astype(F32)  # ftz
        a = np.maximum(np.abs(x), TINY).astype(F32)
        bits = a.view(np.uint32)
        e = (bits >> 23).astype(np.int64) - 127
        p_hi = ((bits & 0x7FFFFF) | 0x3F800000).view(F32) - F32(1)
        code = e + (u < p_hi)
        mag = np.where(code > 127, np.uint32(0x7F800000),
                       ((np.clip(code, -126, 127) + 127) << 23)
                       .astype(np.uint32)).view(F32)
        out = np.copysign(mag, x).astype(F32)
        out = np.where(np.isinf(x), x, out)
        out = np.where(np.isnan(x) | (x == 0), F32(0), out)
    return out.astype(F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_element_function_is_the_codec(dtype):
    """The kernel's element function, transliterated, equals the codec's
    round trip bit for bit on the edge set."""
    g, h, u = edge_set()
    gt = torch.from_numpy(g).to(dtype)
    ht = torch.from_numpy(h).to(dtype)
    want = NAT(lambda shape: torch.from_numpy(u), gt - ht)
    got = _kernel_model(gt.float().numpy(), ht.float().numpy(), u,
                        dtype == torch.bfloat16)
    assert _same(torch.from_numpy(got).to(dtype), want)
    # the cases the source writes out, by name
    x = (gt - ht).float()
    w = want.float()
    zero = (x.abs() < float(TINY)) | x.isnan()
    assert torch.equal(_bits(w[zero]), torch.zeros(int(zero.sum()),
                                                   dtype=torch.int32))
    inf = x.isinf()
    assert torch.equal(w[inf], x[inf])
    up_to_inf = (~inf) & (x.abs() >= 2.0 ** 127) & w.isinf()
    assert int(up_to_inf.sum()) > 0


@pytest.mark.parametrize("n", [1, 3, 127, 129, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_round_trip_off_the_card(n, dtype):
    """Off the card ``shifted_round_trip`` is the codec's own round trip
    on each worker's ``g - h`` with that worker's draw, and counts no
    launch; the wrapper itself takes CUDA tensors only."""
    gen = torch.Generator().manual_seed(n)
    g = torch.randn(3, n, generator=gen).to(dtype)
    h = torch.randn(3, n, generator=gen).to(dtype)
    u = torch.rand(3, n, generator=gen)
    before = natural_message.launches
    draws = [lambda shape, j=j: u[j] for j in range(3)]
    got = NAT.shifted_round_trip(draws, g, h)
    assert compressors._message_kernel(g) is None
    for j in range(3):
        assert _same(got[j], NAT(draws[j], g[j] - h[j]))
    assert natural_message.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        natural_message(g[0], h[0], u[0])


def test_wrapper_checks():
    g = torch.zeros(8)
    with pytest.raises(TypeError):
        natural_message(g, g.bfloat16(), torch.zeros(8))
    with pytest.raises(TypeError):
        natural_message(g.double(), g.double(), torch.zeros(8))
    with pytest.raises(TypeError):
        natural_message(g, g, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        natural_message(g, torch.zeros(9), torch.zeros(8))
    with pytest.raises(ValueError):
        natural_message(g, g, torch.zeros(8), out=torch.zeros(4))
    with pytest.raises(ValueError):
        natural_message(torch.zeros(4, 4).t(), torch.zeros(4, 4),
                        torch.zeros(4, 4))


# -- the helper against the parent's path -------------------------------------

SHAPES = [(4, 37, 5), (2, 128), (3, 1), (4, 3, 4, 9), (5,), (1, 64, 2)]
NOISES = {"addressed": lambda: AddressedNoise(11, "cpu"),
          "generator": lambda: GeneratorNoise(11, "cpu")}


def _tree(shapes, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = {f"l{i}": torch.randn(s, generator=gen).to(dtype)
         for i, s in enumerate(shapes)}
    h = {k: (torch.randn(v.shape, generator=gen) * 0.5).to(dtype)
         for k, v in g.items()}
    return g, h


def parent_message(rule, q, noise, wgrads, h):
    """The parent's ``rule.message``: each leaf's ``g - h`` through
    ``encode_decode_workers`` (DIANA's draws under part ``"q"``), its
    payloads' structural bits added to the f32 counter leaf by leaf."""
    out, bits = {}, f32_bits()
    for i, (k, g) in enumerate(wgrads.items()):
        noise_i = LeafNoise(noise, i)
        if isinstance(rule, DianaShift):
            noise_i = noise_i.with_part("q")
        diff = g if h is None else g - h[k]
        payloads, out[k] = encode_decode_workers(q, noise_i, diff)
        bits = bits + f32_bits(q.wire_bits(payloads))
    return out, bits


def _pretend_card(monkeypatch):
    """The seam: the codec's route hands CPU tensors a stand-in for the
    kernel, which makes the wrapper's checks (dtypes, shapes,
    contiguity) and writes the codec's round trip into ``out``; returns
    the list the stand-in appends each row's shape to."""
    calls = []

    def stand_in(g, h, u, *, out):
        shape = tuple(g.shape)
        K._check("g", g, K._DTYPES, shape, g.device, aligned=False)
        K._check("h", h, (g.dtype,), shape, g.device, aligned=False)
        K._check("u", u, (torch.float32,), shape, g.device, aligned=False)
        K._check("out", out, (g.dtype,), shape, g.device, aligned=False)
        calls.append(shape)
        return out.copy_(NAT(lambda s: u, g - h))

    monkeypatch.setattr(compressors, "_message_kernel", lambda t: stand_in)
    return calls


def _same_tree(a, b):
    return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)


@pytest.mark.parametrize("noise", sorted(NOISES))
@pytest.mark.parametrize("rule", ["diana", "ef21", "efbv"])
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_message_matches_the_parents_path(monkeypatch, route, rule, noise):
    """``rule.message`` of the natural codec equals the parent's path,
    messages bit for bit and the f32 bit counter exactly, on the CPU's
    plain path and on the kernel route (one kernel call a leaf and
    worker, the uniforms drawn in the parent's order)."""
    r = make_shift_rule(rule)
    g, h = _tree(SHAPES)
    calls = _pretend_card(monkeypatch) if route == "kernel" else []
    got, bits = r.message(NAT, NOISES[noise](), g, h)
    want, want_bits = parent_message(r, NAT, NOISES[noise](), g, h)
    assert _same_tree(got, want)
    assert bits.dtype == torch.float32 and torch.equal(bits, want_bits)
    if route == "kernel":
        assert calls == [s[1:] for s in SHAPES for _ in range(s[0])]
    else:
        assert calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise", sorted(NOISES))
def test_kernel_route_on_the_edge_set(monkeypatch, noise, dtype):
    """The kernel route on W-stacked rows of the edge set, against the
    parent's path: the same messages and bits."""
    g, h, _ = edge_set()
    n = g.size - g.size % 3
    gt = torch.from_numpy(g[:n]).to(dtype).reshape(3, -1)
    ht = torch.from_numpy(h[:n]).to(dtype).reshape(3, -1)
    calls = _pretend_card(monkeypatch)
    got, bits = DianaShift().message(NAT, NOISES[noise](), {"a": gt},
                                     {"a": ht})
    want, want_bits = parent_message(DianaShift(), NAT, NOISES[noise](),
                                     {"a": gt}, {"a": ht})
    assert _same_tree(got, want) and torch.equal(bits, want_bits)
    assert len(calls) == 3


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("rule", ["diana", "ef21"])
def test_message_leaf_worker_is_row_j(monkeypatch, route, rule):
    """``message_leaf_worker`` with worker j's draw is row j of
    ``message_leaf``, bit for bit (the fused backward encode's promise)."""
    r = make_shift_rule(rule)
    g, h = _tree(SHAPES, seed=3)
    if route == "kernel":
        _pretend_card(monkeypatch)
    noise = AddressedNoise(5, "cpu")
    for i, k in enumerate(g):
        m, _ = r.message_leaf(NAT, LeafNoise(noise, i), g[k], h[k])
        draws = r.message_draws(NAT, LeafNoise(noise, i), g[k].shape[0])
        for j, d in enumerate(draws):
            row = r.message_leaf_worker(NAT, d, g[k][j], h[k][j])
            assert _same(row, m[j]), (k, j)


@pytest.mark.parametrize("codec", ["q8_block", "int8", "topk", "randk",
                                   "natural_dithering",
                                   "induced_topk_natural"])
def test_other_codecs_never_reach_the_kernel(monkeypatch, codec):
    """With the leaves read as on the card, a codec other than the plain
    natural one takes the parent's path: the kernel is never called and
    the messages and bits are the parent's."""
    def no_kernel(*args, **kw):
        raise AssertionError("the natural kernel was called")

    monkeypatch.setattr(compressors, "_message_kernel",
                        lambda t: no_kernel)
    q = make_compressor(codec)
    g, h = _tree([(2, 256), (2, 64, 4)], seed=1)
    got, bits = DianaShift().message(q, AddressedNoise(2, "cpu"), g, h)
    want, want_bits = parent_message(DianaShift(), q, AddressedNoise(2, "cpu"),
                                     g, h)
    assert _same_tree(got, want) and torch.equal(bits, want_bits)
    draw = worker_draws(q, LeafNoise(AddressedNoise(2, "cpu"), 0)
                        .with_part("q"), 2)[0]
    DianaShift().message_leaf_worker(q, {"q": draw}, g["l0"][0], h["l0"][0])


def test_no_shift_never_reaches_the_kernel(monkeypatch):
    """A stateless rule (no shift: ``Q(g)``) takes the codec's path."""
    def no_kernel(*args, **kw):
        raise AssertionError("the natural kernel was called")

    monkeypatch.setattr(compressors, "_message_kernel",
                        lambda t: no_kernel)
    g, _ = _tree(SHAPES[:3])
    got, bits = FixedShift().message(NAT, AddressedNoise(4, "cpu"), g, None)
    want, want_bits = parent_message(FixedShift(), NAT,
                                     AddressedNoise(4, "cpu"), g, None)
    assert _same_tree(got, want) and torch.equal(bits, want_bits)


def test_route_by_codec_shift_and_device():
    """The route reads the codec, the shift and the device, nothing else:
    the natural codec with a shift runs its ``shifted_round_trip``, no
    shift or another codec the codec's own path; the CPU and meta tensors
    (the step's cost pass) never take the kernel."""
    g = torch.zeros(2, 8)
    assert wire._shifted_round_trip(NAT, g)
    assert not wire._shifted_round_trip(NAT, None)
    assert not wire._shifted_round_trip(make_compressor("q8_block"), g)
    assert compressors._message_kernel(g) is None
    assert compressors._message_kernel(
        torch.empty(2, 8, device="meta")) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise", sorted(NOISES))
def test_non_contiguous_rows_reach_the_kernel(monkeypatch, noise, dtype):
    """Rows that are not contiguous -- a transposed W-stacked leaf, and
    its rows handed to ``message_leaf_worker`` one at a time -- still
    reach the kernel, made contiguous, and give the parent's messages
    and bits."""
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(3, 9, 5, generator=gen).to(dtype).transpose(1, 2)
    h = (torch.randn(3, 9, 5, generator=gen) * 0.5).to(dtype).transpose(1, 2)
    assert not g[0].is_contiguous()
    calls = _pretend_card(monkeypatch)
    got, bits = DianaShift().message(NAT, NOISES[noise](), {"a": g},
                                     {"a": h})
    want, want_bits = parent_message(DianaShift(), NAT, NOISES[noise](),
                                     {"a": g}, {"a": h})
    assert _same_tree(got, want) and torch.equal(bits, want_bits)
    assert calls == [(5, 9)] * 3
    draws = DianaShift().message_draws(NAT, LeafNoise(NOISES[noise](), 0), 3)
    for j, d in enumerate(draws):
        row = DianaShift().message_leaf_worker(NAT, d, g[j], h[j])
        assert _same(row, want["a"][j]), j
    assert calls == [(5, 9)] * 6


def test_kernel_route_raises_on_a_dtype_it_cannot_take(monkeypatch):
    """On the card a dtype the kernel cannot take raises rather than
    falling back to the plain path."""
    _pretend_card(monkeypatch)
    g = torch.zeros(2, 8, dtype=torch.float64)
    with pytest.raises(TypeError):
        DianaShift().message(NAT, AddressedNoise(1, "cpu"), {"a": g},
                             {"a": g})
    with pytest.raises(TypeError):
        DianaShift().message(NAT, AddressedNoise(1, "cpu"), {"a": g.float()},
                             {"a": g.bfloat16()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 3, 4)])
def test_payload_like_is_encodes_payload(shape, dtype):
    """The natural codec's shape-only ``payload_like`` (the kernel route's
    bits) is ``encode``'s payload on meta tensors: the same keys, widths,
    shapes and container dtypes, so the same structural bits."""
    from repro_torch.core.compressors import Compressor

    like = ShapeDtype(shape, dtype, torch.device("meta"))
    got, want = NAT.payload_like(like), Compressor.payload_like(NAT, like)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k].width, got[k].data.shape, got[k].data.dtype) == (
            want[k].width, want[k].data.shape, want[k].data.dtype)
    assert NAT.wire_bits(got) == NAT.wire_bits(want)


# -- on the card ---------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bitwise_the_codec_on_the_card(card, dtype):
    """The kernel against the codec's round trip on the card, with the
    same uniforms: the edge set whole and cut to n = 1, 3, 127, 129 and
    4,096 elements (heads, tails and vectors), and through every worker
    row of W-stacked leaves whose rows start unaligned."""
    g, h, u = (torch.from_numpy(a) for a in edge_set())
    g, h, u = g.to(card, dtype), h.to(card, dtype), u.to(card)
    before = natural_message.launches
    runs = 0
    for n in (g.numel(), 1, 3, 127, 129, 4096):
        for start in (0, 1, 2, 3, 5):
            sl = slice(start, start + n)
            if sl.stop > g.numel():
                continue
            gs, hs = g[sl].clone(), h[sl].clone()
            us = u[sl].clone()
            got = natural_message(gs, hs, us)
            assert _same(got, NAT(lambda s: us, gs - hs)), (n, start)
            # the same rows at an offset: g, h and out misaligned, u not
            pad = torch.zeros(start + n, device=card, dtype=dtype)
            pad[start:] = gs
            hpad = torch.zeros_like(pad)
            hpad[start:] = hs
            out = torch.zeros_like(pad)
            natural_message(pad[start:], hpad[start:], us, out=out[start:])
            assert _same(out[start:], got), (n, start, "offset")
            runs += 2
    for w, n in ((3, 129), (4, 127), (2, 4097), (3, 1)):
        gw = torch.randn(w, n, device=card).to(dtype) * 1e-3
        hw = torch.randn(w, n, device=card).to(dtype) * 1e-3
        out = torch.empty_like(gw)
        for j in range(w):
            uj = torch.rand(n, device=card)
            natural_message(gw[j], hw[j], uj, out=out[j])
            assert _same(out[j], NAT(lambda s: uj, gw[j] - hw[j])), (
                w, n, j)
            runs += 1
    torch.cuda.synchronize()
    assert natural_message.launches - before == runs


@pytest.mark.card
def test_diana_message_on_the_card(card):
    """``DianaShift.message`` on the card over qwen3's leaves at the smoke
    size, W = 4, against the plain ``encode_decode_workers`` on ``g -
    h``: messages bit for bit, the bits equal, one launch a leaf and
    worker (the launch counter and the span counter)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import param_specs

    w = 4
    gen = torch.Generator(device=card).manual_seed(0)
    g = {k: torch.randn((w, *s), generator=gen, device=card) * 1e-2
         for k, s, _ in param_specs(get_smoke_config("qwen3-0.6b"))}
    h = {k: torch.randn(v.shape, generator=gen, device=card) * 1e-2
         for k, v in g.items()}
    before = natural_message.launches
    rec = SpanRecorder()
    with recording(rec):
        got, bits = DianaShift().message(NAT, AddressedNoise(9, card), g, h)
    launched = natural_message.launches - before
    want, want_bits = parent_message(DianaShift(), NAT,
                                     AddressedNoise(9, card), g, h)
    torch.cuda.synchronize()
    assert _same_tree(got, want)
    assert torch.equal(bits, want_bits)
    assert launched == len(g) * w
    assert rec.snapshot()["round/natural_message"]["count"] == len(g) * w
