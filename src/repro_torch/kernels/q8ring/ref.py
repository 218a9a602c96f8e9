"""Plain PyTorch versions of the q8 codec kernels: per-tile max-scale
int8 stochastic rounding and dequant-accumulate, one scale per
(block, 128) row block, exactly as the CUDA kernels compute them.

These are what a CPU tensor runs through, what the CPU tests hold
against the reference's Pallas kernels, and what ``chip_smoke.py``
holds the CUDA kernels against on the card.  Three rounding rules are
part of the function and are matched bit for bit on both sides:

* the scale is ``max(max|x|, 1e-30) * f32(1/127)``: the reference writes
  ``/ 127``, and XLA's algebraic simplifier compiles division by that
  constant into multiplication by its f32 reciprocal, so that product is
  what the reference computes (in its kernel and in its jitted step);
  ``y = x / scale`` stays an IEEE division;
* the int8 conversion saturates to [-128, 127] and maps NaN to 0, as
  XLA's float-to-int8 convert does (``x / scale`` can land a hair above
  127 when the scale rounds down, and the stochastic round may then
  give 128);
* dequant-add rounds once, ``fma(q, scale, acc)``: the reference's
  interpreted kernel on the CPU contracts ``acc + q * scale`` into one
  fused multiply-add, and the CUDA kernel uses ``__fmaf_rn``.
"""

from __future__ import annotations

from typing import Optional

import torch

LANE = 128
DEFAULT_BLOCK_ROWS = 64   # 64*128 f32 = 32 KiB per operand tile
LEVELS = 127              # int8 quantization lattice [-127, 127]
SCALE_FLOOR = 1e-30       # well above subnormal: tiny/LEVELS must not flush
INV_LEVELS = 1.0 / LEVELS  # as f32: 0.00787401572, XLA's folded reciprocal


def fma_f32(q: torch.Tensor, scale: torch.Tensor,
            acc: torch.Tensor) -> torch.Tensor:
    """``q * scale + acc`` rounded ONCE to f32 -- a correctly rounded
    fma -- for int8-valued ``q`` and f32 ``scale`` (broadcast against
    ``q``) and ``acc``.  ``q * scale`` is exact in f64 (8 x 24
    significant bits).  TwoSum gives the exact rounding error e of
    ``t = acc + q * scale``; nudging t one f64 ulp toward e keeps it on
    the exact sum's side of every f32 tie, so the final f64 -> f32
    conversion is the single rounding of the exact value."""
    p = q.to(torch.float64) * scale.to(torch.float64)
    a = acc.to(torch.float64)
    t = a + p
    bp = t - a
    e = (a - (t - bp)) + (p - bp)
    toward = torch.where(e > 0, float("inf"), float("-inf")).to(torch.float64)
    t = torch.where(e != 0, torch.nextafter(t, toward), t)
    return t.to(torch.float32)


def _check_tiles(r: int, lane: int, block: int):
    if lane != LANE or block < 1 or r % block:
        raise ValueError(
            f"expected (R, {LANE}) with R % block == 0; got ({r}, {lane}) "
            f"and block {block}"
        )


def q8_quantize_ref(x: torch.Tensor, u: torch.Tensor, *, block: int):
    """x, u: (R, 128); returns (q int8 (R, 128), scales f32 (R//block, 1))."""
    r, lane = x.shape
    _check_tiles(r, lane, block)
    nb = r // block
    xb = x.to(torch.float32).reshape(nb, block * lane)
    scales = torch.clamp_min(xb.abs().amax(dim=1), SCALE_FLOOR) * INV_LEVELS
    y = xb / scales[:, None]
    lo = torch.floor(y)
    up = (u.reshape(nb, block * lane) < (y - lo)).to(torch.float32)
    q = (lo + up).nan_to_num_(nan=0.0).clamp_(-128.0, 127.0)
    return q.to(torch.int8).reshape(r, lane), scales[:, None]


def q8_quantize_chunk_ref(chunks: torch.Tensor, u: torch.Tensor,
                          chunk_id: int, *, block: int):
    """The quantize of chunk ``chunk_id`` of an (n, R, 128) ring buffer:
    ``q8_quantize_ref(chunks[chunk_id], u)``, the id checked to lie in
    [0, n)."""
    n = chunks.shape[0]
    chunk_id = int(chunk_id)
    if not 0 <= chunk_id < n:
        raise IndexError(f"chunk_id {chunk_id} outside [0, {n})")
    return q8_quantize_ref(chunks[chunk_id], u, block=block)


def q8_dequant_add_ref(q: torch.Tensor, scales: torch.Tensor,
                       acc: Optional[torch.Tensor], *, block: int):
    """``fma(q, scale, acc)`` with one scale per (block, 128) row block,
    rounded once to f32.  ``acc=None`` is a zero accumulator (plain
    decode), which is the single rounding of ``q * scale``."""
    r, lane = q.shape
    _check_tiles(r, lane, block)
    nb = r // block
    qb = q.reshape(nb, block * lane)
    if acc is None:
        return (qb.to(torch.float32) * scales.reshape(nb, 1)).reshape(r, lane)
    return fma_f32(qb, scales.reshape(nb, 1), acc.reshape(nb, block * lane)
                   ).reshape(r, lane)
