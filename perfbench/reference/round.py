"""The plain reference of one communication round and of the optimizer:
the workers' messages, their aggregation, DIANA's shifts and AdamW.

A round over the worker-stacked gradients ``g`` (W, ...) of each leaf:
worker j sends ``m_j = Q(g_j - h_j)``; the master forms the mean of the
messages ``m_bar``, either exactly (``dense``) or by a ring all-reduce
whose hops carry int8 chunks (``q8_ring``); then

    g_bar = h_bar + m_bar,   h_j += alpha m_j,   h_bar += alpha m_bar,

and AdamW steps on ``g_bar``.  The codecs:

* ``natural``: each element rounded at random to one of the two powers
  of two around it, unbiased; subnormals go to zero;
* ``q8_block``: the leaf flattened to rows of 128, padded to whole tiles
  of ``block`` rows (``block`` = min(64, rows)), each tile scaled by its
  ``max|x| / 127`` and rounded at random to int8.

Each message and each ring hop draws its uniforms from the round's
draws (``inputs.SeedDraws``) at the addresses the measured program
asks for: a message at ``(leaf, worker, part "q")``, a hop at ``(leaf,
hop)``, leaves numbered in their sorted order.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
LANE = 128
BLOCK_ROWS = 64
INV_127 = float(np.float32(1.0 / 127))
TINY = 2.0 ** -126


# --------------------------------------------------------------------------
# Codecs
# --------------------------------------------------------------------------


def natural(x: Tensor, u: Tensor) -> Tensor:
    """Natural compression: |x| in [2^e, 2^(e+1)) goes to 2^(e+1) with
    probability |x| / 2^e - 1, else to 2^e."""
    x = torch.where(x.abs() < TINY, torch.zeros_like(x), x)
    a = torch.clamp_min(x.abs(), TINY)
    mant, exp = torch.frexp(a)            # a = mant 2^exp, mant in [0.5, 1)
    e = exp - 1
    up = (u < 2.0 * mant - 1.0).to(e.dtype)
    return torch.sign(x) * torch.ldexp(torch.ones_like(a), e + up)


def tiles(d: int, block_rows: int = BLOCK_ROWS) -> Tuple[int, int]:
    """(rows_pad, block) of a d-element vector laid out in rows of 128."""
    rows = max(1, -(-d // LANE))
    block = min(block_rows, rows)
    return -(-rows // block) * block, block


def q8_roundtrip(x2: Tensor, u: Tensor, block: int) -> Tensor:
    """Int8 stochastic rounding of (R, 128) rows with one scale per tile of
    ``block`` rows, decoded."""
    r = x2.shape[0]
    xb = x2.reshape(r // block, block * LANE)
    scale = torch.clamp_min(xb.abs().amax(1, keepdim=True), 1e-30) * INV_127
    y = xb / scale
    lo = torch.floor(y)
    q = (lo + (u.reshape(xb.shape) < y - lo).to(torch.float32)).clamp(
        -128.0, 127.0)
    return (q * scale).reshape(r, LANE)


def q8_block(x: Tensor, u_of, block_rows: int = BLOCK_ROWS) -> Tensor:
    d = x.numel()
    rows_pad, block = tiles(d, block_rows)
    x2 = torch.zeros(rows_pad * LANE, dtype=torch.float32, device=x.device)
    x2[:d] = x.reshape(-1)
    out = q8_roundtrip(x2.view(rows_pad, LANE), u_of((rows_pad, LANE)), block)
    return out.reshape(-1)[:d].reshape(x.shape)


def message_bits(codec: str, d: int, block_rows: int = BLOCK_ROWS) -> int:
    """Wire bits of one worker's message of a d-element leaf: natural 8
    exponent bits and a sign bit an element; q8 an int8 an element of the
    padded tiles and an f32 scale a tile."""
    if codec == "natural":
        return 9 * d
    rows_pad, block = tiles(d, block_rows)
    return rows_pad * LANE * 8 + (rows_pad // block) * 32


# --------------------------------------------------------------------------
# Aggregation
# --------------------------------------------------------------------------


def ring_mean(msgs: Tensor, draws, leaf: int, block_rows: int = BLOCK_ROWS
              ) -> Tensor:
    """The mean of W messages (one per ring position) by a ring all-reduce:
    each position's message flattened and cut into W chunks of whole
    tiles; in hop t < W-1 position p sends its chunk (p - t) mod W,
    quantized, and the next position adds the decode into its copy of
    that chunk; then each position quantizes the one chunk it holds
    summed, (p + 1) mod W, once for everyone.  Hop t's uniforms are one
    draw shared by every position."""
    n = msgs.shape[0]
    d = msgs[0].numel()
    rows = max(1, -(-d // LANE))
    rows_c = -(-rows // n)
    block = min(block_rows, rows_c)
    rows_c = -(-rows_c // block) * block
    buf = torch.zeros(n, n * rows_c * LANE, dtype=torch.float32,
                      device=msgs.device)
    buf[:, :d] = msgs.reshape(n, d)
    buf = buf.view(n, n, rows_c, LANE)
    for t in range(n - 1):
        u = draws.ring_uniform(leaf, t, (rows_c, LANE))
        sent = [q8_roundtrip(buf[p, (p - t) % n], u, block) for p in range(n)]
        for p in range(n):
            buf[p, (p - t - 1) % n] += sent[(p - 1) % n]
    u = draws.ring_uniform(leaf, n - 1, (rows_c, LANE))
    total = torch.empty(n, rows_c, LANE, dtype=torch.float32,
                        device=msgs.device)
    for p in range(n):
        total[(p + 1) % n] = q8_roundtrip(buf[p, (p + 1) % n], u, block)
    return total.reshape(-1)[:d].reshape(msgs.shape[1:]) / n


def diana_round(grads: Dict[str, Tensor], h: Dict[str, Tensor],
                h_bar: Dict[str, Tensor], draws, *, codec: str,
                aggregation: str, alpha: float) -> Tuple[Dict[str, Tensor], int]:
    """One DIANA round over worker-stacked gradients; updates ``h`` and
    ``h_bar`` in place and returns ``(g_bar, bits)``."""
    g_bar, bits = {}, np.float32(0)
    for leaf, (k, g) in enumerate(grads.items()):
        w = g.shape[0]
        msgs = torch.empty_like(g)
        for j in range(w):
            diff = g[j] - h[k][j]
            if codec == "natural":
                u = draws.uniform(leaf, j, tuple(diff.shape), part="q")
                msgs[j] = natural(diff, u)
            else:
                msgs[j] = q8_block(diff, lambda s, j=j: draws.uniform(
                    leaf, j, s, part="q"))
        bits = np.float32(bits + np.float32(w * message_bits(codec,
                                                             g[0].numel())))
        if aggregation == "dense":
            mean = msgs.sum(0) / w
        else:
            mean = ring_mean(msgs, draws, leaf)
        g_bar[k] = h_bar[k] + mean
        h[k] += alpha * msgs
        h_bar[k] += alpha * mean
    return g_bar, bits


# --------------------------------------------------------------------------
# AdamW on a cosine schedule
# --------------------------------------------------------------------------


def learning_rate(step: int, base: float, warmup: int, total: int,
                  final: float = 0.1) -> float:
    """Linear warm-up to ``base`` over ``warmup`` steps, then a cosine to
    ``final * base`` at ``total``."""
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (final + (1 - final) * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw(params, grads, m, v, step: int, *, lr: float, beta1: float,
          beta2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step (decay on every leaf), in place."""
    bc1, bc2 = 1 - beta1 ** step, 1 - beta2 ** step
    for k, p in params.items():
        g = grads[k]
        m[k].mul_(beta1).add_(g, alpha=1 - beta1)
        v[k].mul_(beta2).add_(g * g, alpha=1 - beta2)
        update = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
        p.sub_(lr * (update + weight_decay * p))
