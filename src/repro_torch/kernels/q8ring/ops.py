"""Layout helpers for the q8 kernels + the ``FusedQ8`` codec.

``FusedQ8`` is the port of the reference's ``FusedQ8``
(``repro/kernels/q8ring/ops.py``): int8 stochastic quantization with one
f32 scale per (block_rows, 128) tile of the flattened leaf, encoded by
the ``q8_quantize_2d`` kernel and decoded by ``q8_dequant_add_2d``.  The
tile grid is part of the wire format -- ``_tile_rows`` is the one rule
for it, as in the reference -- so a leaf must be encoded whole (stacked
layers included) for its scales, payload and ``wire_bits`` to match.
The ring chunks (``ring_chunk_layout``) follow the same rule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.compressors import ShapeDtype, Unbiased
from repro_torch.kernels.q8ring.kernel import (
    DEFAULT_BLOCK_ROWS,
    LANE,
    LEVELS,
    SCALE_FLOOR,
    q8_dequant_add_2d,
    q8_quantize_2d,
)

__all__ = ["DEFAULT_BLOCK_ROWS", "LANE", "LEVELS", "SCALE_FLOOR", "FusedQ8",
           "q8_dequant", "q8_layout", "ring_chunk_layout", "to_lanes"]


def _tile_rows(rows: int, block_rows: int):
    """THE tile rule: clamp the block to the row count (scalar and
    sub-tile inputs still get exactly one scale) and pad rows to a block
    multiple."""
    block = min(block_rows, rows)
    return -(-rows // block) * block, block


def q8_layout(d: int, block_rows: int = DEFAULT_BLOCK_ROWS):
    """(rows, block, rows_pad) for a d-element vector laid out (rows, 128)."""
    rows = max(1, -(-d // LANE))
    rows_pad, block = _tile_rows(rows, block_rows)
    return rows, block, rows_pad


def ring_chunk_layout(d: int, n: int, block_rows: int = DEFAULT_BLOCK_ROWS):
    """(rows_c, block) for an n-chunk ring over a d-element vector: the
    lane rows split n ways, each chunk padded to the same tile grid as
    ``q8_layout`` (one rule -- see ``_tile_rows``)."""
    rows = max(1, -(-d // LANE))
    return _tile_rows(-(-rows // n), block_rows)


def to_lanes(x: torch.Tensor, rows_pad: int) -> torch.Tensor:
    """Flatten + zero-pad a tensor to the (rows_pad, 128) kernel layout (a
    view when no padding is needed and ``x`` is contiguous f32)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = rows_pad * LANE - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(rows_pad, LANE)


def q8_dequant(q: torch.Tensor, scales: torch.Tensor, *, block: int):
    """Dequantize a (R, 128) int8 block with per-tile scales: the
    dequant-add kernel with no accumulator (the reference adds a zero
    buffer; skipping its read computes the same values)."""
    return q8_dequant_add_2d(q, scales, None, block_rows=block)


@dataclass(frozen=True)
class FusedQ8(Unbiased):
    """Blockwise-scale int8 stochastic quantization, CUDA-fused.

    Payload: int8 lanes block (padded to the tile grid) + one f32 scale
    per tile -- both travel, so ``wire_bits`` is structural.  Meta-free.
    Unbiased (stochastic rounding): omega <= d / (4 * LEVELS^2).
    """

    block_rows: int = DEFAULT_BLOCK_ROWS

    #: ``q8_ring_tree_mean`` takes the chunk-fused ring on this flag
    fused_ring = True

    def encode(self, rand, x):
        rows, block, rows_pad = q8_layout(x.numel(), self.block_rows)
        x2 = to_lanes(x, rows_pad)
        u = rand((rows_pad, LANE))
        q, scales = q8_quantize_2d(x2, u, block_rows=block)
        return {"q": q, "scale": scales}, {}

    def payload_like(self, like: ShapeDtype):
        _, block, rows_pad = q8_layout(math.prod(like.shape),
                                       self.block_rows)
        return {"q": torch.empty((rows_pad, LANE), dtype=torch.int8,
                                 device="meta"),
                "scale": torch.empty((rows_pad // block, 1),
                                     dtype=torch.float32, device="meta")}

    def decode(self, payload, meta, like: ShapeDtype):
        d = 1
        for s in like.shape:
            d *= s
        nb = payload["scale"].shape[0]
        block = payload["q"].shape[0] // nb
        out = q8_dequant(payload["q"], payload["scale"], block=block)
        return out.reshape(-1)[:d].reshape(like.shape).to(like.dtype)

    def omega(self, d):
        return d / (4.0 * LEVELS**2)
