"""Plain PyTorch version of the shifted natural-compression kernel:
``out = h + C_nat(g - h)`` (the paper's shifted estimator, eq. 3), with
C_nat the stochastic rounding of each element to the power of two below
or above it (Horvath et al. 2019a).

This is what a CPU tensor runs through, what the CPU tests hold against
the reference's Pallas kernel (``repro/kernels/natural/kernel.py``,
interpreted), and what ``chip_smoke.py`` holds the CUDA kernel against
on the card, bit for bit.  The function, element by element:

* compute in f32 (bf16 inputs are widened exactly) and cast the output
  to ``g``'s dtype;
* flush subnormal inputs, the difference ``g - h`` and the output to
  (signed) zero, as XLA on the CPU does when it runs the reference
  (flush-to-zero and denormals-are-zero);
* ``a = |g - h|``; ``e = floor(log2 a)`` and ``2^e`` are read from the
  float's exponent field, exactly.  The reference computes
  ``floor(log2(max(a, 1e-38)))`` and ``exp2(e)``; on a normal ``a``
  that is the same function, and its floor (1e-38, itself subnormal and
  flushed) never applies;
* ``p_up = a / 2^e - 1``, the mantissa's fraction, exact; the element
  rounds up to ``2^(e+1)`` when ``u < p_up`` and down to ``2^e``
  otherwise; a zero difference stays zero; the sign is ``g - h``'s;
* NaN and +-inf propagate as in the reference: NaN -> NaN, +-inf ->
  +-inf (``2^(e+1)`` past the largest float is inf, as in the
  reference).

Known differences from the reference as XLA runs it on the CPU (pinned
by ``tests/test_torch_natural.py``): XLA's ``floor(log2(.))`` is off by
one just below some powers of two, and its ``exp2`` of an integer is up
to 67 ulps off ``2^e`` at most exponents.  Both are XLA's
approximations, not the function; the port's levels are exact powers
of two.
"""

from __future__ import annotations

import torch

LANE = 128
DEFAULT_BLOCK_ROWS = 256
TINY = 2.0 ** -126          # smallest normal f32

_MANT = 0x7FFFFF
_ONE = 0x3F800000           # bits of 1.0f


def ftz(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its subnormal elements replaced by zero of their sign
    (NaN and inf kept)."""
    return torch.where(t.abs() < TINY, t * 0.0, t)


def shifted_natural_ref(g: torch.Tensor, h: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """``h + C_nat(g - h)`` elementwise with the given uniforms ``u``
    (f32 in [0, 1)); any shape, ``g`` and ``h`` alike, output in
    ``g.dtype``."""
    gf = ftz(g.to(torch.float32))
    hf = ftz(h.to(torch.float32))
    x = ftz(gf - hf)
    a = x.abs()
    bits = a.view(torch.int32)
    lo = (bits & ~_MANT).view(torch.float32)             # 2^e for normal a
    p_up = ((bits & _MANT) | _ONE).view(torch.float32) - 1.0
    q = torch.where(u.to(torch.float32) < p_up, lo * 2.0, lo)
    q = torch.where(torch.isfinite(a), q, a)             # inf, NaN as is
    q = torch.where(a == 0, torch.zeros_like(q), q).copysign(x)
    return ftz(hf + q).to(g.dtype)
