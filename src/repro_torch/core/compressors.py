"""Compression operators as wire codecs -- the subset of the reference's
``repro/core/compressors.py`` this slice of the port runs.

The protocol is the reference's, with the PRNG key replaced by a draw
function:

  ``encode(rand, x) -> (payload, meta)``
        ``rand(shape)`` returns f32 uniforms in [0, 1) on ``x``'s device
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
        payloads: ``numel * dtype bits`` summed over tensor leaves.

Codecs still to be ported (RandK, BernoulliP, NaturalDithering,
NaturalCompression, TernGrad, TopK, ScaledSign, Induced) raise
``NotImplementedError`` from ``make_compressor``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.kernels.q8ring.ref import fma_f32

#: ROADMAP item that ports the remaining codecs
_CODECS_ITEM = "ROADMAP queue 1, item 2 (codecs)"


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


def _tensor_leaves(payload):
    if isinstance(payload, torch.Tensor):
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
    payloads, or tensor), in bits: ``numel * dtype bits`` per tensor."""
    total = 0
    for leaf in _tensor_leaves(payload):
        total += _numel(leaf.shape) * leaf.element_size() * 8
    return float(total)


def f32_bits(bits: float = 0.0) -> torch.Tensor:
    """An f32 bit counter: 0-d, on the CPU (it is structural, computed
    from shapes, and never touches the device).  Adding leaf counts to
    it one by one rounds as the reference's f32 counter does."""
    return torch.tensor(bits, dtype=torch.float32)


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

    @property
    def stochastic(self) -> bool:
        return True


@dataclass(frozen=True)
class Unbiased(Compressor):
    """Marker base for the class U(omega)."""

    def omega(self, d: int) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class Identity(Unbiased):
    """I in U(0): full-precision message."""

    def encode(self, rand, x):
        return {"values": x}, {}

    def decode(self, payload, meta, like):
        return payload["values"].reshape(like.shape).to(like.dtype)

    def omega(self, d):
        return 0.0

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
    """

    levels: int = 127

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


def _fused_q8(**kw) -> Compressor:
    # the CUDA-fused blockwise-int8 codec lives with its kernel
    from repro_torch.kernels.q8ring.ops import FusedQ8

    return FusedQ8(**kw)


#: every name the reference's registry accepts; the port builds these
_PORTED = {
    "identity": Identity,
    "zero": Zero,
    "int8": Int8Stochastic,
    "q8_block": _fused_q8,
}
_NOT_PORTED = ("randk", "bernoulli", "natural_dithering", "natural",
               "terngrad", "topk", "sign", "induced",
               "induced_topk_randk", "induced_topk_natural")


def make_compressor(name: str, **kw) -> Compressor:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet: {_CODECS_ITEM}"
        )
    if name not in _PORTED:
        raise ValueError(
            f"unknown compressor {name!r}; have "
            f"{sorted(_PORTED) + sorted(_NOT_PORTED)}"
        )
    return _PORTED[name](**kw)
