"""Public wrapper: fused shifted natural compression on tensors of any
shape (flatten -> pad to (rows, 128) -> kernel -> unpad), the port of the
reference's ``repro/kernels/natural/ops.py:shifted_natural``.

The reference draws its uniforms from a PRNG key; here they come from a
draw function ``rand(shape)`` (the port's noise protocol,
``repro_torch.comm.wire``), called once for the padded (rows_pad, 128)
block, as the reference draws them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.natural.kernel import (DEFAULT_BLOCK_ROWS, LANE,
                                                shifted_natural_2d)

__all__ = ["natural_layout", "shifted_natural"]


def natural_layout(n: int):
    """(rows, block, rows_pad) of an n-element tensor in the kernel's
    (rows_pad, 128) layout: the reference's tile rule, the block clamped
    to the row count."""
    rows = -(-n // LANE)
    block = min(DEFAULT_BLOCK_ROWS, rows)
    return rows, block, -(-rows // block) * block


def _lanes(x: torch.Tensor, rows_pad: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = rows_pad * LANE - flat.numel()
    return (F.pad(flat, (0, pad)) if pad else flat).reshape(rows_pad, LANE)


def shifted_natural(rand, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``h + C_nat(g - h)`` for ``g``, ``h`` of one shape and dtype (f32 or
    bf16); ``rand(shape)`` returns f32 uniforms in [0, 1) on their
    device."""
    if g.shape != h.shape or g.dtype != h.dtype:
        raise ValueError(f"g and h differ: {tuple(g.shape)} {g.dtype} vs "
                         f"{tuple(h.shape)} {h.dtype}")
    n = g.numel()
    _, block, rows_pad = natural_layout(n)
    u = rand((rows_pad, LANE))
    out = shifted_natural_2d(_lanes(g.contiguous(), rows_pad),
                             _lanes(h.contiguous(), rows_pad), u,
                             block_rows=block)
    return out.reshape(-1)[:n].reshape(g.shape).to(g.dtype)
