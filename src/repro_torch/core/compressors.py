"""Compression operators as wire codecs -- the subset of the reference's
``repro/core/compressors.py`` this slice of the port runs.

The protocol is the reference's, with the PRNG key replaced by a draw
function:

  ``encode(rand, x) -> (payload, meta)``
        ``rand(shape)`` returns f32 uniforms in [0, 1) on ``x``'s device
        and ``rand.permutation(d)`` a random permutation of ``range(d)``
        (see ``repro_torch.comm.wire`` for where they come from);
        deterministic codecs never call it.  ``payload`` is a dict of
        tensors with honest wire dtypes, ``meta`` side information the
        receiver derives from shared state (never charged).
  ``decode(payload, meta, like) -> x_hat``
        ``like`` is a ``ShapeDtype`` of the original tensor.
  ``decode_add(payload, meta, acc, like)``
        ``acc + decode(...)``: the receive side of a ring hop.  A codec
        whose decode ends in a product overrides it with ONE rounding
        (``fma_f32``), since XLA contracts the reference's
        ``acc + q * scale`` into a fused multiply-add.
  ``__call__(rand, x)``
        the dense round trip, derived as ``decode(encode(rand, x))``.
  ``wire_bits(payload)``
        structural bits of a payload, or of a list of per-worker
        payloads: ``numel * dtype bits`` summed over tensor leaves, and
        ``numel * width`` over ``PackedBits`` leaves.
  ``payload_like(like)``
        one worker's payload for an input like ``like``, as meta tensors:
        its shapes alone (no data, no draw), for the structural bits of
        a message that was never encoded here (``comm.fused_vjp``).
  ``omega(d)`` / ``delta(d)``
        variance constants of the classes U(omega) and B(delta).

A two-part codec (``Induced``) draws its parts from ``rand.part_of("c")``
and ``rand.part_of("q")``: two parts of the one address.
``aot_wire_bits`` (and ``tree_bits``) quote the bits of one message
ahead of time from ``payload_like``; ``BernoulliP``, whose payload size
is itself random, charges live payloads what they carry and quotes the
expectation on meta tensors.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.kernels.natural.ref import TINY, ftz
from repro_torch.kernels.q8ring.ref import fma_f32

class ShapeDtype(NamedTuple):
    """Shape, dtype and device of a tensor (the reference's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    @classmethod
    def of(cls, x: torch.Tensor) -> "ShapeDtype":
        return cls(tuple(x.shape), x.dtype, x.device)


def _numel(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _k_of(q: float, d: int) -> int:
    """Number of kept coordinates for a sparsifier with keep-fraction q."""
    return max(1, int(round(q * d)))


def _index_bits(d: int) -> int:
    """Bits to address one of d coordinates on the wire."""
    return math.ceil(math.log2(max(d, 2)))


class PackedBits:
    """Payload leaf whose true wire width is ``width`` bits per element:
    a field stored in a wider container dtype (1-bit signs in int8,
    ceil(log2 d)-bit indices in int32); ``wire_bits`` charges ``numel *
    width`` for it instead of the container's width."""

    __slots__ = ("data", "width")

    def __init__(self, data: torch.Tensor, width: int):
        self.data = data
        self.width = int(width)

    def __repr__(self):
        return f"PackedBits({self.data!r}, width={self.width})"


def _tensor_leaves(payload):
    if isinstance(payload, (torch.Tensor, PackedBits)):
        yield payload
    elif isinstance(payload, dict):
        for k in sorted(payload):
            yield from _tensor_leaves(payload[k])
    elif isinstance(payload, (list, tuple)):
        for p in payload:
            yield from _tensor_leaves(p)
    elif payload is not None:
        raise TypeError(f"unexpected payload leaf {type(payload).__name__}")


def wire_bits(payload) -> float:
    """Structural wire size of a payload (dict, list of per-worker
    payloads, or tensor), in bits: ``numel * dtype bits`` per tensor,
    ``numel * width`` per ``PackedBits``."""
    total = 0
    for leaf in _tensor_leaves(payload):
        if isinstance(leaf, PackedBits):
            total += _numel(leaf.data.shape) * leaf.width
        else:
            total += _numel(leaf.shape) * leaf.element_size() * 8
    return float(total)


def f32_bits(bits=0.0) -> torch.Tensor:
    """An f32 bit counter: 0-d, on the CPU when the count is structural
    (computed from shapes, never touching the device); a count that is a
    tensor (``BernoulliP``'s, which depends on its draws) stays where it
    is.  Adding leaf counts to it one by one rounds as the reference's
    f32 counter does."""
    if isinstance(bits, torch.Tensor):
        return bits.to(torch.float32)
    return torch.tensor(bits, dtype=torch.float32)


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


class _MetaDraw:
    """A draw object whose draws are meta tensors: shapes, no values."""

    def __call__(self, shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def permutation(self, d: int):
        return torch.empty(d, dtype=torch.int64, device="meta")

    def part_of(self, name: str) -> "_MetaDraw":
        return self


def _is_meta(t) -> bool:
    return getattr(getattr(t, "data", t), "device", None) == torch.device(
        "meta")


@dataclass(frozen=True)
class Compressor:
    """Base codec: subclasses implement ``encode``/``decode``; the dense
    round trip and the accounting are derived here."""

    def encode(self, rand, x: torch.Tensor) -> Tuple[Any, Any]:
        raise NotImplementedError

    def decode(self, payload, meta, like: ShapeDtype) -> torch.Tensor:
        raise NotImplementedError

    def decode_add(self, payload, meta, acc: torch.Tensor,
                   like: ShapeDtype) -> torch.Tensor:
        return acc + self.decode(payload, meta, like)

    def __call__(self, rand, x: torch.Tensor) -> torch.Tensor:
        payload, meta = self.encode(rand, x)
        return self.decode(payload, meta, ShapeDtype.of(x))

    def wire_bits(self, payload) -> float:
        return wire_bits(payload)

    def payload_like(self, like: ShapeDtype):
        """``encode``'s payload for an input like ``like``, run on meta
        tensors (a codec whose encode reads values overrides this)."""
        x = torch.empty(like.shape, dtype=like.dtype, device="meta")
        return self.encode(_MetaDraw(), x)[0]

    @property
    def stochastic(self) -> bool:
        return True


@dataclass(frozen=True)
class Unbiased(Compressor):
    """Marker base for the class U(omega)."""

    def omega(self, d: int) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class Contractive(Compressor):
    """Marker base for the class B(delta)."""

    def delta(self, d: int) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class Identity(Unbiased, Contractive):
    """I in U(0) and B(1): full-precision message."""

    def encode(self, rand, x):
        return {"values": x}, {}

    def decode(self, payload, meta, like):
        return payload["values"].reshape(like.shape).to(like.dtype)

    def omega(self, d):
        return 0.0

    def delta(self, d):
        return 1.0

    @property
    def stochastic(self):
        return False


@dataclass(frozen=True)
class Zero(Compressor):
    """O -- maps everything to zero; the C of classic DIANA.  The payload
    is empty: zero wire cost by construction."""

    def encode(self, rand, x):
        return {}, {}

    def decode(self, payload, meta, like):
        return torch.zeros(like.shape, dtype=like.dtype, device=like.device)

    def encode_decode_stacked(self, draws, x):
        """Every worker row at once: an empty payload, zeros."""
        return {}, torch.zeros_like(x)

    def delta(self, d):
        return 0.0

    @property
    def stochastic(self):
        return False


@dataclass(frozen=True)
class Int8Stochastic(Unbiased):
    """Linear int8 quantization with a per-tensor max-scale and
    stochastic rounding (unbiased).  The codec of the generic ``q8_ring``
    all-reduce, which forwards exactly this payload (int8 block + f32
    scale) hop by hop.  Plain PyTorch: the reference has no kernel for
    it.  Its arithmetic is what XLA compiles the reference's to: the
    scale is ``max(max|x|, 1e-30) * f32(1/levels)`` (division by a
    constant becomes a product with its reciprocal), ``x / scale`` an
    IEEE division, and the int8 convert saturates and maps NaN to 0.
    ``sum_fuses_decode``: the reference's jitted round sums up to 32
    workers' messages with this decode fused in, ``acc = fma(q_j,
    scale_j, acc)``; ``comm.wire.encode_decode_workers`` marks the
    decoded rows with their payloads so the port's sums do the same
    (``dist.collectives.with_payload_rows``).
    """

    levels: int = 127
    sum_fuses_decode = True

    def encode(self, rand, x):
        xf = x.to(torch.float32)
        inv = torch.tensor(1.0 / self.levels, dtype=torch.float32)
        scale = torch.clamp_min(xf.abs().amax(), 1e-30) * inv
        y = xf / scale
        lo = torch.floor(y)
        up = (rand(tuple(x.shape)) < (y - lo)).to(torch.float32)
        q = (lo + up).nan_to_num_(nan=0.0).clamp_(-128.0, 127.0)
        return {"q": q.to(torch.int8), "scale": scale}, {}

    def decode(self, payload, meta, like):
        out = payload["q"].to(torch.float32) * payload["scale"]
        return out.reshape(like.shape).to(like.dtype)

    def decode_add(self, payload, meta, acc, like):
        return fma_f32(payload["q"].reshape(like.shape), payload["scale"], acc)

    def omega(self, d):
        # ||C(x)-x||^2 <= d*scale^2/4 <= d * ||x||^2/(4*levels^2)
        return d / (4.0 * self.levels**2)


_MANT = 0x7FFFFF


@dataclass(frozen=True)
class NaturalCompression(Unbiased):
    """C_nat -- stochastic rounding to the nearest powers of two.
    omega = 1/8; 9 bits per coordinate on the wire (1-bit sign + 8-bit
    exponent; zero is signalled by sign 0).  Elementwise and
    shape-preserving.

    Plain PyTorch, as the reference's is plain jnp (the fused
    ``kernels/natural`` kernel computes the shifted estimator with its own
    floor).  A shift rule's message ``decode(encode(g - h))`` is
    ``shifted_round_trip``, which on the card runs as the
    ``natural_message`` kernel, bit for bit this codec, which is its plain
    version.  ``e = floor(log2(max(|x|, 2^-126)))`` and ``2^e`` are read
    from the float's bits, exactly; XLA on the CPU flushes a subnormal x
    to zero before the codec sees it, so the port does too (sign 0).  The
    exponent codes span [-126, 128] (255 codes -> 8 wire bits); a NaN
    encodes as sign 0 and an infinity as code 32767, as XLA's saturating
    int16 convert gives them.  Decode builds ``2^code`` from bits (code
    128 and above: inf).
    """

    def encode(self, rand, x):
        xf = ftz(x.to(torch.float32))
        a = torch.clamp_min(xf.abs(), TINY)
        bits = a.view(torch.int32)
        e = ((bits >> 23) - 127).to(torch.float32)
        e = torch.where(torch.isfinite(a), e, a)            # inf, NaN as is
        p_hi = ((bits & _MANT) | 0x3F800000).view(torch.float32) - 1.0
        up = rand(tuple(x.shape)) < p_hi
        e_out = (e + up.to(torch.float32)).nan_to_num(nan=0.0)
        e_out = e_out.clamp(-32768.0, 32767.0).to(torch.int16)
        sign = torch.sign(xf).nan_to_num(nan=0.0).to(torch.int8)
        return {"exp": PackedBits(e_out, 8), "sign": PackedBits(sign, 1)}, {}

    def payload_like(self, like):
        """``encode``'s payload for an input like ``like``, built from its
        shape alone: running ``encode`` on meta tensors would load
        PyTorch's Python meta kernels, seconds at a process's first
        call.  It must stay in step with ``encode``: the same keys,
        widths and container dtypes (``shifted_round_trip``'s bits are
        counted from it)."""
        return {"exp": PackedBits(torch.empty(like.shape, dtype=torch.int16,
                                              device="meta"), 8),
                "sign": PackedBits(torch.empty(like.shape, dtype=torch.int8,
                                               device="meta"), 1)}

    def decode(self, payload, meta, like):
        code = payload["exp"].data.to(torch.int32).clamp(-126, 128)
        mag = torch.where(code > 127, float("inf"),
                          ((code + 127) << 23).view(torch.float32))
        out = payload["sign"].data.to(torch.float32) * mag
        return out.reshape(like.shape).to(like.dtype)

    def shifted_round_trip(self, draws, g, h):
        """A shift rule's message: the decoded ``(W, ...)`` round trips
        ``decode(encode(g[j] - h[j]))`` of the worker-stacked ``g`` and
        ``h``, worker j's uniforms drawn by ``draws[j]`` as ``encode``
        draws them, in worker order (``comm.wire.shifted_message_workers``
        finds it with ``hasattr``).  On the card each row is one
        ``natural_message`` kernel, its g and h made contiguous; elsewhere
        (the CPU, meta) this codec's own ``encode`` and ``decode``.  The
        same bits either way; ``g - h`` is never built whole."""
        kernel = _message_kernel(g)
        out = torch.empty(g.shape, dtype=torch.result_type(g, h),
                          device=g.device)
        for j, draw in enumerate(draws):
            if kernel is None:
                out[j] = self(draw, g[j] - h[j])
            else:
                kernel(g[j].contiguous(), h[j].contiguous(),
                       draw(tuple(g.shape[1:])), out=out[j])
        return out

    def omega(self, d):
        return 0.125


def _message_kernel(t: torch.Tensor):
    """``NaturalCompression.shifted_round_trip``'s route, by device alone:
    the ``natural_message`` kernel for a CUDA tensor, else None."""
    if t.device.type != "cuda":
        return None
    from repro_torch.kernels.natural.kernel import natural_message

    return natural_message


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest magnitudes of the 1-D ``x``, int64, in
    ``lax.top_k``'s order: magnitude descending, ties by ascending index
    (``torch.topk`` promises no order among ties, so it only finds the
    k-th magnitude).  Magnitudes are compared as the bit patterns of
    ``|x|`` in f32, a total order in which NaN ranks above inf."""
    key = x.to(torch.float32).abs().view(torch.int32)
    kth = torch.topk(key, k, sorted=False).values.min()
    above = key > kth
    at = key == kth
    need = k - int(above.sum())
    take = above | (at & (torch.cumsum(at, 0, dtype=torch.int32) <= need))
    idx = torch.nonzero(take).squeeze(1)                # ascending
    order = torch.sort(key[idx], descending=True, stable=True).indices
    return idx[order]


def _row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Running count of True along each row of a 2-D bool ``mask``,
    taken as ONE scan of the flattened mask less the count before each
    row: on the GPU a scan along the rows runs a block a row, far slower
    for a few long rows."""
    flat = torch.cumsum(mask.reshape(-1), 0,
                        dtype=torch.int32 if mask.numel() < 2**31
                        else torch.int64).reshape(mask.shape)
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - before[:, None]


@dataclass(frozen=True)
class TopK(Contractive):
    """Greedy sparsification: keep the K = round(q*d) largest-magnitude
    coordinates.  TopK in B(K/d).

    Exactly K coordinates survive, in ``lax.top_k``'s order with its tie
    rule (``topk_indices``).  Payload: K values (input dtype) + K indices
    packed to ceil(log2 d) bits (int32 container).
    """

    q: float = 0.1

    def encode(self, rand, x):
        xf = x.reshape(-1)
        d = xf.numel()
        idx = topk_indices(xf, _k_of(self.q, d))
        return ({"values": xf[idx],
                 "indices": PackedBits(idx.to(torch.int32), _index_bits(d))},
                {})

    def decode(self, payload, meta, like):
        out = torch.zeros(_numel(like.shape), dtype=like.dtype,
                          device=like.device)
        out[payload["indices"].data.long()] = payload["values"].to(like.dtype)
        return out.reshape(like.shape)

    def payload_like(self, like):
        d = _numel(like.shape)
        k = _k_of(self.q, d)
        return {"values": torch.empty(k, dtype=like.dtype, device="meta"),
                "indices": PackedBits(torch.empty(k, dtype=torch.int32,
                                                  device="meta"),
                                      _index_bits(d))}

    def encode_decode_stacked(self, draws, x):
        """Every worker row of the W-stacked ``x`` at once:
        ``(stacked payload, decoded (W, ...))``, bit for bit the rows'
        ``encode``/``decode`` one by one (the same k-th magnitude and tie
        rule as ``topk_indices``, row by row); the payload's entries come
        in index order."""
        w = x.shape[0]
        xf = x.reshape(w, -1)
        d = xf.shape[1]
        k = _k_of(self.q, d)
        key = xf.to(torch.float32).abs().view(torch.int32)
        kth = torch.topk(key, k, dim=1, sorted=False).values.amin(
            dim=1, keepdim=True)
        above = key > kth
        at = key == kth
        need = k - above.sum(dim=1, keepdim=True, dtype=torch.int64)
        take = above.logical_or_(at.logical_and_(_row_cumsum(at) <= need))
        del key, at
        idx = torch.nonzero(take)[:, 1].reshape(w, k).to(torch.int32)
        payload = {"values": xf[take].reshape(w, k),
                   "indices": PackedBits(idx, _index_bits(d))}
        out = torch.where(take, xf, torch.zeros((), dtype=xf.dtype,
                                                device=xf.device))
        return payload, out.reshape(x.shape)

    def delta(self, d):
        return _k_of(self.q, d) / d

    @property
    def stochastic(self):
        return False


@dataclass(frozen=True)
class RandK(Unbiased):
    """Random sparsification (eq. 2): keep a uniformly random K-subset,
    scale by d/K.  RandK(q) keeps K = round(q*d) coords; omega = d/K - 1.

    The K-subset is the prefix of a random permutation
    (``rand.permutation(d)``), so exactly K coordinates survive.  Payload:
    K values (input dtype, times f32(d/K)) + K indices packed to
    ceil(log2 d) bits (int32 container).  With ``shared_pattern`` every
    worker draws the same permutation (``comm.wire.worker_draws``): the
    indices move to ``meta`` and are not charged to the wire.  Decode
    scatters the values into zeros.  Plain PyTorch: the reference has no
    kernel for it.
    """

    q: float = 0.1
    shared_pattern: bool = False

    def _pack(self, values, idx, d):
        if self.shared_pattern:
            return {"values": values}, {"indices": idx}
        return ({"values": values,
                 "indices": PackedBits(idx, _index_bits(d))}, {})

    def encode(self, rand, x):
        xf = x.reshape(-1)
        d = xf.numel()
        idx = rand.permutation(d)[:_k_of(self.q, d)].to(torch.int32)
        return self._pack(xf[idx.long()] * (d / idx.numel()), idx, d)

    def decode(self, payload, meta, like):
        idx = (meta["indices"] if self.shared_pattern
               else payload["indices"].data)
        out = torch.zeros(_numel(like.shape), dtype=like.dtype,
                          device=like.device)
        out[idx.long()] = payload["values"].to(like.dtype)
        return out.reshape(like.shape)

    def encode_decode_stacked(self, draws, x):
        """Every worker row of the W-stacked ``x`` at once, ``draws[j]``
        worker j's draw object: ``(stacked payload, decoded (W, ...))``,
        bit for bit the rows' ``encode``/``decode`` one by one."""
        w = x.shape[0]
        xf = x.reshape(w, -1)
        d = xf.shape[1]
        k = _k_of(self.q, d)
        idx = torch.stack([r.permutation(d) for r in draws])[:, :k]
        values = torch.gather(xf, 1, idx) * (d / k)
        out = torch.zeros_like(xf).scatter_(1, idx, values)
        return self._pack(values, idx.to(torch.int32), d)[0], out.reshape(
            x.shape)

    def omega(self, d):
        return d / _k_of(self.q, d) - 1.0


@dataclass(frozen=True)
class BernoulliP(Unbiased):
    """B_p -- the full vector scaled 1/p with probability p, else 0;
    omega = 1/p - 1.  The C_i of Rand-DIANA (Table 2).

    The payload is a flag (``sent``, one draw ``rand(())`` < p, the
    reference's Bernoulli) and the values, zeros when the flag is off.
    ``x / p`` is the product with f32(1 / f32(p)), as XLA compiles the
    reference's division by a constant.  Its size is a random variable,
    so ``wire_bits`` charges a live payload what it carries (a traced
    count, on the payload's device) and quotes the expectation for a
    payload of meta tensors (``payload_like``, ``aot_wire_bits``)."""

    p: float = 0.1

    def encode(self, rand, x):
        keep = rand(()) < self.p
        values = torch.where(keep, x * _f32(1.0 / _f32(self.p)),
                             torch.zeros((), dtype=x.dtype, device=x.device))
        return {"sent": keep, "values": values}, {}

    def decode(self, payload, meta, like):
        return payload["values"].reshape(like.shape).to(like.dtype)

    def wire_bits(self, payload):
        """Flag bits always, the full vector for each message that was
        sent: ``sum(sent) * bits_per_msg + n_msg`` in f32 (one rounding,
        as XLA contracts the reference's), for one payload or a list of
        per-worker payloads; the expectation ``p * bits_per_msg * n_msg
        + n_msg`` (a float) on meta tensors."""
        if isinstance(payload, (list, tuple)):
            sent = [p["sent"] for p in payload]
            n_msg = len(payload)
            one = payload[0]["values"]
        else:
            sent = [payload["sent"]]
            n_msg = _numel(payload["sent"].shape)
            one = payload["values"]
        per_msg = (one.element_size() * 8 * _numel(one.shape)
                   // (1 if isinstance(payload, (list, tuple)) else n_msg))
        if _is_meta(sent[0]):
            return self.p * per_msg * n_msg + float(n_msg)
        count = sum(s.reshape(-1).to(torch.float32).sum() for s in sent)
        return fma_f32(count, torch.tensor(_f32(per_msg), dtype=torch.float32,
                                           device=count.device),
                       torch.tensor(float(n_msg), dtype=torch.float32,
                                    device=count.device))

    def omega(self, d):
        return 1.0 / self.p - 1.0


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e (f32) for integer-valued ``e`` in [-126, 127], from bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@dataclass(frozen=True)
class NaturalDithering(Unbiased):
    """Natural dithering with s levels w.r.t. the l2 norm (Horvath et
    al., 2019a) -- the "ND" compressor of the paper's Fig. 1.

    Levels are the exponent lattice {2^0, 2^-1, ..., 2^-(s-1), 0} applied
    to |x| / ||x||_2, with unbiased stochastic rounding between
    neighbouring levels; omega <= 1/8 + 2^(1-s) min(sqrt(d), 2^(1-s) d).
    Payload per coordinate: a packed ceil(log2(s+1))-bit level code (0 =
    the zero level, c >= 1 = 2^-(c-1)) and a 1-bit sign, plus one f32
    norm per message.

    The norm is an f32 sum of squares over every element, whose order
    differs from XLA's (a few ulps).  The level index ``floor(-log2 y)``
    and the levels are read from the float's bits, exactly (the
    reference's ``log2`` and ``exp2`` on XLA's CPU are not: ROADMAP
    queue 3, items 4-5); subnormal inputs are flushed to zero, as XLA's
    CPU does; NaN codes and signs are 0, as XLA's int8 convert gives
    them.  Plain PyTorch, as the reference's is plain jnp."""

    s: int = 8

    def encode(self, rand, x):
        xf = ftz(x.to(torch.float32))
        return self.encode_with_norm(rand, x, torch.sqrt(torch.sum(xf * xf)))

    def encode_with_norm(self, rand, x, norm: torch.Tensor):
        """``encode`` with the f32 norm given (the parity tests hand it
        the reference's, whose summation order is XLA's)."""
        xf = ftz(x.to(torch.float32))
        safe = torch.clamp_min(norm, TINY)
        y = ftz(xf.abs() / safe)                       # in [0, 1]
        bits = y.view(torch.int32)
        j = -((bits >> 23) - 127) - ((bits & _MANT) != 0).to(torch.int32)
        j = j.clamp(0, self.s - 1)                     # floor(-log2 y)
        top = j >= self.s - 1
        hi = _pow2(-j)
        lo = torch.where(top, 0.0, _pow2(-j - 1))
        take_hi = rand(tuple(x.shape)) < (y - lo) / (hi - lo)
        code = torch.where(take_hi, j + 1, torch.where(top, 0, j + 2))
        code = torch.where((y == 0) | torch.isnan(y), 0, code)
        sign = torch.sign(xf).nan_to_num_(nan=0.0).to(torch.int8)
        return ({"code": PackedBits(code.to(torch.int8),
                                    _index_bits(self.s + 1)),
                 "sign": PackedBits(sign, 1), "norm": norm}, {})

    def decode(self, payload, meta, like):
        code = payload["code"].data.to(torch.int32)
        lvl = torch.where(code > 0, _pow2(1 - code.clamp_min(1)), 0.0)
        out = payload["sign"].data.to(torch.float32) * payload["norm"] * lvl
        return out.reshape(like.shape).to(like.dtype)

    def omega(self, d):
        t = 2.0 ** (1 - self.s)
        return 0.125 + t * min(math.sqrt(d), t * d)


@dataclass(frozen=True)
class TernGrad(Unbiased):
    """Ternary quantization (Wen et al., 2017): sign(x) ||x||_inf
    Bern(|x| / ||x||_inf).  Unbiased; omega is data dependent, bounded by
    sqrt(d) in the worst case.  Payload: one packed 2-bit ternary digit
    per coordinate and an f32 scale (the max magnitude, at least the
    smallest normal f32).  Subnormal inputs are flushed to zero, as XLA's
    CPU does; a NaN digit is 0.  Plain PyTorch."""

    def encode(self, rand, x):
        xf = ftz(x.to(torch.float32))
        a = xf.abs()
        m = torch.clamp_min(a.amax(), TINY)
        b = rand(tuple(x.shape)) < a / m
        t = (torch.sign(xf) * b.to(torch.float32)).nan_to_num_(nan=0.0)
        return {"tern": PackedBits(t.to(torch.int8), 2), "scale": m}, {}

    def decode(self, payload, meta, like):
        out = payload["tern"].data.to(torch.float32) * payload["scale"]
        return out.reshape(like.shape).to(like.dtype)

    def omega(self, d):
        return math.sqrt(d)  # worst-case bound


@dataclass(frozen=True)
class ScaledSign(Contractive):
    """(||x||_1 / d) * sign(x) (Karimireddy et al.), in B(||x||_1^2 /
    (d ||x||_2^2)); worst-case delta = 1/d.  The model wire's ``sign``
    flag.

    Payload: one sign bit per coordinate (int8 container) and an f32
    scale, the mean of |x| in f32.  An exact zero keeps sign 0, and a NaN
    too (XLA's int8 convert maps the reference's NaN sign to 0).
    Deterministic.  Plain PyTorch, as the reference's is plain jnp.
    """

    def encode(self, rand, x):
        xf = x.to(torch.float32)
        sign = torch.sign(xf).nan_to_num_(nan=0.0).to(torch.int8)
        return {"sign": PackedBits(sign, 1), "scale": xf.abs().mean()}, {}

    def decode(self, payload, meta, like):
        out = payload["sign"].data.to(torch.float32) * payload["scale"]
        return out.reshape(like.shape).to(like.dtype)

    def delta(self, d):
        return 1.0 / d

    @property
    def stochastic(self):
        return False


@dataclass(frozen=True)
class Induced(Unbiased):
    """C_ind(x) = C(x) + Q(x - C(x)) in U(omega (1 - delta)) for C in
    B(delta), Q in U(omega) (Def. 4 / Lemma 3; Horvath & Richtarik, 2021):
    a biased operator made unbiased with less variance than Q alone.
    The wire message is both payloads; decode sums the two decoded
    parts.  C draws from part ``"c"`` of the draw, Q from part ``"q"``
    (``part_of``), the reference's split of one key."""

    c: Contractive = dataclasses.field(default_factory=lambda: TopK(0.1))
    q: Unbiased = dataclasses.field(default_factory=lambda: RandK(0.1))

    def encode(self, rand, x):
        cp, cm = self.c.encode(rand.part_of("c"), x)
        cx = self.c.decode(cp, cm, ShapeDtype.of(x))
        qp, qm = self.q.encode(rand.part_of("q"), x - cx)
        return {"c": cp, "q": qp}, {"c": cm, "q": qm}

    def decode(self, payload, meta, like):
        return (self.c.decode(payload["c"], meta["c"], like)
                + self.q.decode(payload["q"], meta["q"], like))

    def wire_bits(self, payload):
        """The two parts' ``wire_bits``, each the part's own (a nested
        ``BernoulliP`` charges what it carries)."""
        if isinstance(payload, (list, tuple)):
            return (self.c.wire_bits([p["c"] for p in payload])
                    + self.q.wire_bits([p["q"] for p in payload]))
        return self.c.wire_bits(payload["c"]) + self.q.wire_bits(payload["q"])

    def payload_like(self, like):
        return {"c": self.c.payload_like(like), "q": self.q.payload_like(like)}

    def omega(self, d):
        return self.q.omega(d) * (1.0 - self.c.delta(d))


# --------------------------------------------------------------------------
# Shifted compression and tree helpers
# --------------------------------------------------------------------------


def shifted(q: Compressor, h: torch.Tensor, rand, x: torch.Tensor
            ) -> torch.Tensor:
    """Q_h(x) = h + Q(x - h): the shifted compressor of Definition 3 (if
    Q is in U(omega; 0), Q_h is in U(omega; h): Lemma 1 with v = h)."""
    return h + q(rand, x - h)


def leaf_keys(noise, tree) -> list:
    """The per-leaf draw objects of a tree (the reference folds the leaf
    index into its key): leaf i's draws at address ``(leaf=i,
    worker=None)`` of ``noise``."""
    from repro_torch.comm.wire import LeafNoise

    return [LeafNoise(noise, i).worker(None) for i in range(len(tree))]


def tree_compress(q: Compressor, noise, tree):
    """A compressor applied leaf-wise to a tree ``{path: tensor}``, each
    leaf with its own draws (``leaf_keys``)."""
    return {k: q(rand, x)
            for rand, (k, x) in zip(leaf_keys(noise, tree), tree.items())}


def tree_shifted_compress(q: Compressor, noise, tree, shift_tree):
    """Leaf-wise ``h + Q(x - h)`` over two trees of the same structure."""
    if list(tree) != list(shift_tree):
        raise ValueError(
            "tree_shifted_compress: shift_tree structure does not match "
            f"tree (shifts would mis-pair with leaves): tree={list(tree)}, "
            f"shift_tree={list(shift_tree)}")
    return {k: shifted(q, shift_tree[k], rand, x)
            for rand, (k, x) in zip(leaf_keys(noise, tree), tree.items())}


def aot_wire_bits(q: Compressor, shape, dtype=torch.float32) -> float:
    """Structural wire bits of ONE compressed message, ahead of time: the
    codec's own encode on meta tensors (``payload_like``), no data, no
    draw.  ``shape`` is an int d (a flat d-vector) or a shape tuple.
    ``BernoulliP`` quotes its expectation."""
    if isinstance(shape, int):
        shape = (shape,)
    like = ShapeDtype(tuple(shape), dtype, torch.device("meta"))
    return float(q.wire_bits(q.payload_like(like)))


def tree_bits(q: Compressor, tree) -> float:
    """``aot_wire_bits`` summed over a tree's leaves, each a flat f32
    message of its size (anything with ``.shape``)."""
    return float(sum(aot_wire_bits(q, _numel(leaf.shape))
                     for leaf in tree.values()))


def tree_size(tree) -> int:
    """Elements in a tree's leaves (anything with ``.shape``)."""
    return int(sum(_numel(leaf.shape) for leaf in tree.values()))


def _induced_topk_randk(q: float = 0.1) -> Induced:
    return Induced(c=TopK(q), q=RandK(q))


def _induced_topk_natural(q: float = 0.1) -> Induced:
    return Induced(c=TopK(q), q=NaturalCompression())


def _fused_q8(**kw) -> Compressor:
    # the CUDA-fused blockwise-int8 codec lives with its kernel
    from repro_torch.kernels.q8ring.ops import FusedQ8

    return FusedQ8(**kw)


#: every name the reference's registry accepts
_REGISTRY = {
    "identity": Identity,
    "zero": Zero,
    "randk": RandK,
    "bernoulli": BernoulliP,
    "natural_dithering": NaturalDithering,
    "natural": NaturalCompression,
    "terngrad": TernGrad,
    "int8": Int8Stochastic,
    "q8_block": _fused_q8,
    "topk": TopK,
    "sign": ScaledSign,
    "induced": Induced,
    # the induced compressor (Lemma 3) of biased TopK made unbiased by
    # RandK or natural compression; plain signatures, so unknown
    # arguments raise as the dataclass constructors do
    "induced_topk_randk": _induced_topk_randk,
    "induced_topk_natural": _induced_topk_natural,
}


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
