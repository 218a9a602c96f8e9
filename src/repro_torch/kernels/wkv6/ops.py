"""WKV6 on the model layout, with its gradient.

``wkv6(r, k, v, w, u)`` is the port of the reference's
``repro/kernels/wkv6/ops.py:wkv6``: r, k, w (B, T, H, K), v (B, T, H, V),
u (H, K); returns ``(y (B, T, H, V) f32, s_final (B, H, K, V) f32)``,
the recurrence from a zero state -- what ``models.rwkv6.wkv_scan``
computes in training.

It is a ``torch.autograd.Function`` whose forward and backward are the
two kernel wrappers: when a gradient is wanted the forward saves the
states the backward starts from (no recompute of the forward), and the
backward takes f32 inputs only.  The wrappers choose by the tensors'
device and nothing else: CUDA tensors launch the kernels, CPU tensors
run their plain versions (``ref.py``); there is no fallback.  ``u`` is
broadcast over the batch before the kernels, so its gradient (one row
per (batch, head) from the kernel) is summed over the batch by autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_backward, wkv6_forward

__all__ = ["wkv6"]


class _WKV6(torch.autograd.Function):
    """(BH, T, K)-layout recurrence through the forward and backward
    kernels."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        y, s, ckpt = wkv6_forward(r, k, v, w, u,
                                  checkpoints=any(ctx.needs_input_grad))
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds_fin):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(v) if dy is None else dy.contiguous()
        return wkv6_backward(r, k, v, w, u, ckpt, dy,
                             None if ds_fin is None else ds_fin.contiguous())


def wkv6(r, k, v, w, u):
    """Model-layout WKV6 from a zero state.  r, k, w: (B, T, H, K); v:
    (B, T, H, V); u: (H, K); mixed dtypes are widened to f32.  Returns
    ``(y (B, T, H, V) f32, s_final (B, H, K, V) f32)``."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if len({x.dtype for x in (r, k, v, w)}) > 1:
        # a bf16 model's r, k, v beside its f32 decay: the kernels take
        # one dtype, and widening to f32 is exact (the recurrence runs in
        # f32 either way)
        r, k, v, w = (x.to(torch.float32) for x in (r, k, v, w))

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, t, x.shape[-1]).contiguous()

    rb, kb, vb, wb = map(to_bh, (r, k, v, w))
    ub = u.to(torch.float32).expand(b, h, dk).reshape(b * h, dk).contiguous()
    y, s = _WKV6.apply(rb, kb, vb, wb, ub)
    return (y.reshape(b, h, t, dv).permute(0, 2, 1, 3),
            s.reshape(b, h, dk, dv))
