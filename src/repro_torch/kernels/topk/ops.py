"""Public wrapper: block Top-K sparsification with keep-fraction ``q`` on
tensors of any shape, the port of the reference's
``repro/kernels/topk/ops.py:block_topk``.  The tensor is flattened and
zero-padded to (rows_pad, 128); the padding zeros take part in the last
block's count, as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.topk.kernel import (DEFAULT_BLOCK_ROWS, LANE,
                                             block_topk_2d)

__all__ = ["block_topk", "topk_layout"]


def topk_layout(n: int, q: float = 0.1,
                block_rows: int = DEFAULT_BLOCK_ROWS):
    """(block, rows_pad, k) for an n-element tensor: the block clamped to
    the row count, rows padded to a block multiple, and k = max(1,
    round(q * block * 128)) with Python's half-to-even ``round``, as the
    reference computes it."""
    rows = -(-n // LANE)
    block = min(block_rows, rows)
    return block, -(-rows // block) * block, max(1, int(round(q * block
                                                              * LANE)))


def block_topk(x: torch.Tensor, *, q: float = 0.1,
               block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Keep ~q of each (block_rows x 128)-element block by magnitude (the
    B(q) operator); same shape and dtype as ``x``."""
    n = x.numel()
    block, rows_pad, k = topk_layout(n, q, block_rows)
    flat = x.contiguous().reshape(-1)
    pad = rows_pad * LANE - n
    xf = (F.pad(flat, (0, pad)) if pad else flat).reshape(rows_pad, LANE)
    out = block_topk_2d(xf, k=k, block_rows=block)
    return out.reshape(-1)[:n].reshape(x.shape)
