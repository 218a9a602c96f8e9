"""Plain PyTorch versions of block Top-K sparsification: each
(block, 128) row block of an (R, 128) array keeps its largest-magnitude
entries and zeroes the rest.

Three forms: two as in the reference, and the kernel's own:

* ``block_topk_bisect_ref`` is the function the TPU kernel computes
  (``repro/kernels/topk/kernel.py:_block_topk_kernel``): the threshold
  ``lo`` comes from 32 bisection steps on ``count(|x| >= mid) >= k``,
  from ``lo = 0``, ``hi = max|x|``, with ``mid = 0.5 * (lo + hi)`` in
  f32, and the block keeps ``|x| >= lo`` -- at least k entries, more on
  ties.  This is what a CPU tensor runs through and what the CUDA kernel
  is held against, bit for bit.  As in the reference, ``max|x|``
  propagates NaN: a block holding a NaN never raises ``lo`` above 0, so
  it keeps every finite entry and writes 0 at the NaN.  Subnormal
  magnitudes and midpoints count as zero, as XLA on the CPU flushes them
  when it runs the reference.
* ``block_topk_kth_ref`` computes the same function the way the CUDA
  kernel does: for ``mid >= 0``, ``count(a >= mid) >= k`` holds exactly
  when ``kth >= mid``, ``kth`` the k-th largest of ``a = ftz(|x|)``, so
  the 32 steps are replayed on ``(kth, max a)`` alone (``kth`` here from
  ``torch.topk``, in the kernel from a radix select).  It is the plain
  model of the kernel's algorithm, held bitwise against the bisection by
  the tests.
* ``block_topk_ref`` is the reference's oracle
  (``repro/kernels/topk/ref.py``): the exact k-th magnitude per block,
  keeping ``|x| >= kth``.  On data without ties across the threshold it
  agrees with the bisection.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.natural.ref import ftz

LANE = 128
DEFAULT_BLOCK_ROWS = 64     # 64 * 128 = 8192 elements per block
BISECT_ITERS = 32


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    r, lane = x.shape
    if lane != LANE or block < 1 or r % block:
        raise ValueError(f"expected (R, {LANE}) with R % block == 0; got "
                         f"({r}, {lane}) and block {block}")
    return x.reshape(r // block, block * LANE)


def block_topk_bisect_ref(x: torch.Tensor, *, k: int,
                          block: int) -> torch.Tensor:
    """x: (R, 128) f32 or bf16; keeps ``|x| >= lo`` per (block, 128) row
    block, ``lo`` from the bisection.  Output in ``x.dtype``."""
    xb = _blocks(x, block).to(torch.float32)
    a = ftz(xb.abs())
    hi = a.amax(dim=1)                      # propagates NaN, as jnp.max
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = ftz((lo + hi) * 0.5)
        raise_lo = (a >= mid[:, None]).sum(dim=1) >= k
        lo = torch.where(raise_lo, mid, lo)
        hi = torch.where(raise_lo, hi, mid)
    out = torch.where(a >= lo[:, None], xb, torch.zeros_like(xb))
    return out.reshape(x.shape).to(x.dtype)


def block_topk_kth_ref(x: torch.Tensor, *, k: int,
                       block: int) -> torch.Tensor:
    """``block_topk_bisect_ref``'s function from the k-th magnitude: the
    bisection replayed on ``(kth, max a)`` with no count over the block.
    ``k <= 0`` raises ``lo`` at every step and ``k`` above the block's
    size never does, as the counts would."""
    xb = _blocks(x, block).to(torch.float32)
    a = ftz(xb.abs())
    hi = a.amax(dim=1)                      # propagates NaN, as jnp.max
    lo = torch.zeros_like(hi)
    if 1 <= k <= a.shape[1]:
        kth = torch.topk(a, k, dim=1).values[:, -1]
    for _ in range(BISECT_ITERS):
        mid = ftz((lo + hi) * 0.5)
        if 1 <= k <= a.shape[1]:
            raise_lo = mid <= kth
        else:
            raise_lo = torch.full_like(mid, k <= 0, dtype=torch.bool)
        lo = torch.where(raise_lo, mid, lo)
        hi = torch.where(raise_lo, hi, mid)
    out = torch.where(a >= lo[:, None], xb, torch.zeros_like(xb))
    return out.reshape(x.shape).to(x.dtype)


def block_topk_ref(x: torch.Tensor, *, k: int, block: int) -> torch.Tensor:
    """The exact form: keep ``|x| >= kth``, ``kth`` the k-th largest
    magnitude of each (block, 128) row block."""
    xb = _blocks(x, block)
    a = xb.to(torch.float32).abs()
    kth = torch.topk(a, k, dim=1).values[:, -1]
    out = torch.where(a >= kth[:, None], xb, torch.zeros_like(xb))
    return out.reshape(x.shape)
