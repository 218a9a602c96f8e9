"""Plain PyTorch versions of the WKV6 kernels.

Per (batch * head) row, with the K x V state S (zero before t = 0):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_ref`` is the sequential recurrence of the reference's
``repro/kernels/wkv6/ref.py`` (its autograd is the plain gradient);
``wkv6_fwd_ref`` adds the states the forward kernel saves;
``wkv6_bwd_ref`` is the explicit reverse recurrence that the backward
kernel computes.  Every state and output is f32; inputs may be bf16.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

#: steps between the states the forward kernel saves for the backward
CKPT_EVERY = 8


def _f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def _states(r, k, v, w, u, *, save_every: int = 0):
    """Run the recurrence; returns ``(y, s_final, saved)`` where ``saved``
    lists S_{t-1} for every t with t % save_every == 0 (none for 0)."""
    bh, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w, u = _f32(r, k, v, w, u)
    s = r.new_zeros((bh, dk, dv))
    ys: List[torch.Tensor] = []
    saved: List[torch.Tensor] = []
    for i in range(t):
        if save_every and i % save_every == 0:
            saved.append(s)
        kv = k[:, i, :, None] * v[:, i, None, :]             # (BH, K, V)
        ys.append(torch.einsum("bk,bkv->bv", r[:, i], s + u[:, :, None] * kv))
        s = w[:, i, :, None] * s + kv
    return torch.stack(ys, dim=1), s, saved


def wkv6_ref(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K).  Returns
    (y (BH, T, V) f32, s_final (BH, K, V) f32)."""
    y, s, _ = _states(r, k, v, w, u)
    return y, s


def wkv6_fwd_ref(r, k, v, w, u, *, checkpoints: bool = False):
    """What the forward kernel computes: ``(y, s_final, ckpt)`` as
    ``wkv6_ref`` in one pass, with ``ckpt`` the states it saves when
    ``checkpoints`` is set -- S_{t-1} at t = 0, CKPT_EVERY, 2 CKPT_EVERY,
    ...; (BH, ceil(T / CKPT_EVERY), K, V) f32 -- else ``None``."""
    y, s, saved = _states(r, k, v, w, u,
                          save_every=CKPT_EVERY if checkpoints else 0)
    return y, s, torch.stack(saved, dim=1) if checkpoints else None


def wkv6_bwd_ref(r, k, v, w, u, dy, ds_fin: Optional[torch.Tensor] = None):
    """Gradients of the recurrence, as the reverse recurrence in the state
    gradient dS_t = dL/dS_t (``ds_fin`` at t = T, zero when ``None``):

        dr_t[i] = sum_j dy_t[j] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
        dk_t[i] = sum_j dS_t[i,j] v_t[j] + u_i r_t[i] (dy_t . v_t)
        dv_t[j] = sum_i dS_t[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
        dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
        du[i]  += r_t[i] k_t[i] (dy_t . v_t)
        dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T

    dy: (BH, T, V).  Returns (dr, dk, dv, dw: like r, k, v, w; du: (BH,
    K)), all f32; ``du`` is per row, summed over the batch by the caller.
    """
    bh, t, dk_ = r.shape
    dv_ = v.shape[-1]
    r, k, v, w, u, dy = _f32(r, k, v, w, u, dy)
    prev = []                                   # S_{t-1} for every t
    s = r.new_zeros((bh, dk_, dv_))
    for i in range(t):
        prev.append(s)
        s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
    ds = (torch.zeros_like(s) if ds_fin is None
          else ds_fin.to(r.dtype).clone())
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.zeros_like(u)
    for i in reversed(range(t)):
        rt, kt, vt, wt, dyt = r[:, i], k[:, i], v[:, i], w[:, i], dy[:, i]
        dyv = (dyt * vt).sum(-1, keepdim=True)                 # (BH, 1)
        dr[:, i] = (torch.einsum("bv,bkv->bk", dyt, prev[i])
                    + u * kt * dyv)
        dk[:, i] = torch.einsum("bkv,bv->bk", ds, vt) + u * rt * dyv
        dv[:, i] = (torch.einsum("bkv,bk->bv", ds, kt)
                    + (rt * u * kt).sum(-1, keepdim=True) * dyt)
        dw[:, i] = (ds * prev[i]).sum(-1)
        du += rt * kt * dyv
        ds = wt[:, :, None] * ds + rt[:, :, None] * dyt[:, None, :]
    return dr, dk, dv, dw, du
