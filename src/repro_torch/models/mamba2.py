"""Mamba-2 (SSD) block, the state-space backbone of Zamba2
(arXiv:2411.15242; SSD per arXiv:2405.21060) -- the port of the
reference's ``repro/models/mamba2.py``, function by function and in the
same layouts.

Per head with state S in R^{N x P} (N = ssm_state, P = head dim):

    a_t = exp(-exp(A_log) * dt_t)            # scalar decay per head
    S_t = a_t S_{t-1} + B_t (dt_t x_t)^T     # B_t in R^N, x_t in R^P
    y_t = C_t^T S_t + D * x_t

dt is a softplus of a data-dependent projection plus a bias; B and C
come in G = ``cfg.mamba_ngroups`` groups (1, shared by every head, where
the config has no such field: the reference's), head h reading group
``h // (H/G)``, as Zamba2 and transformers do.  A short causal
depthwise conv1d over the (x, B, C) streams comes first.  d_inner = 2
d_model, P = ``rwkv_head_dim``.  The gated norm ``rmsnorm(y *
silu(z))`` is taken over each group's ``d_inner / G`` channels.

The recurrence is plain PyTorch, as the reference's is XLA's (it has no
Pallas kernel): the exact per-step scan ``_ssd_scan`` (a Python loop
where the reference runs ``lax.scan``), or for training and prefill
(``t`` a multiple of 128, no carried state) the chunked matmul form
``_ssd_chunked``, one chunk after another.  Decode carries ``{"conv"
(B, K-1, conv_dim) in the model's dtype, "ssm" (B, H, N, P) f32}``.

Leaves (relative to the layer's ``m2``): ``w_in`` (d, 2 d_inner + 2 G N
+ H), ``conv_w`` (K, conv_dim), ``conv_b`` (conv_dim,), ``a_log``,
``dt_bias``, ``d_skip`` (H,) -- f32 whatever the model's dtype --,
``norm/scale`` (d_inner,), ``w_out`` (d_inner, d).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.spans import count, span

Params = Dict[str, torch.Tensor]

CHUNK = 128     # the chunked form's length, as the reference's


class F32Init(tuple):
    """A deterministic init of a leaf kept in f32 whatever the model's
    dtype: ``("full", value)``, or ``("log_linspace", lo, hi)`` for
    ``log(linspace(lo, hi, n))`` over the leaf's n entries."""


def _dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    p = cfg.rwkv_head_dim            # head dim
    h = d_inner // p                 # heads
    return d_inner, h, p, cfg.ssm_state


def _groups(cfg: ModelConfig) -> int:
    """G, the B/C groups."""
    return getattr(cfg, "mamba_ngroups", 1)


def mamba2_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one Mamba-2 layer, the reference's
    ``init_mamba2``, its B and C G groups wide."""
    d = cfg.d_model
    d_inner, h, _, n = _dims(cfg)
    n = _groups(cfg) * n             # B's (and C's) width
    conv_dim = d_inner + 2 * n
    return [
        # in_proj -> [z (gate), x, B, C, dt]
        ("w_in", (d, 2 * d_inner + 2 * n + h), 0.02),
        ("conv_w", (cfg.conv_kernel, conv_dim), 0.02),
        ("conv_b", (conv_dim,), ("full", 0.0)),
        ("a_log", (h,), F32Init(("log_linspace", 1.0, 16.0))),
        ("dt_bias", (h,), F32Init(("full", -4.6))),   # softplus^-1(0.01)
        ("d_skip", (h,), F32Init(("full", 1.0))),
        ("norm/scale", (d_inner,), ("full", 1.0)),
        ("w_out", (d_inner, d), 0.02 / math.sqrt(2 * cfg.n_layers)),
    ]


def _by_group(t, g: int):
    """A head-leading (B, H, ...) tensor as (B, G, H/G, ...)."""
    return t.unflatten(1, (g, t.shape[1] // g))


def _ssd_scan(x, b_t, c_t, dt_t, a_log, d_skip, s0):
    """The exact recurrence, step by step.  x (B,T,H,P); b_t, c_t
    (B,T,N) for one group or (B,T,G,N) for G; dt_t (B,T,H); s0
    (B,H,N,P).  Returns (y (B,T,H,P), s)."""
    a = -torch.exp(a_log)                                 # (H,)
    g = b_t.shape[2] if b_t.dim() == 4 else 0
    s = s0
    ys = []
    for t in range(x.shape[1]):
        xt, bt, ct, dtt = x[:, t], b_t[:, t], c_t[:, t], dt_t[:, t]
        decay = torch.exp(a[None] * dtt)                  # (B,H)
        xdt = xt * dtt[..., None]
        if g:
            upd = torch.einsum("bgn,bgjp->bgjnp", bt,
                               _by_group(xdt, g)).flatten(1, 2)
        else:
            upd = torch.einsum("bn,bhp->bhnp", bt, xdt)
        s = decay[..., None, None] * s + upd
        if g:
            read = torch.einsum("bgn,bgjnp->bgjp", ct,
                                _by_group(s, g)).flatten(1, 2)
        else:
            read = torch.einsum("bn,bhnp->bhp", ct, s)
        ys.append(read + d_skip[None, :, None] * xt)
    return torch.stack(ys, 1), s


def _ssd_chunked(x, b_t, c_t, dt_t, a_log, d_skip, s0, chunk: int = CHUNK):
    """The chunked (matmul) form of the same recurrence, chunk after
    chunk:

      y_t = C_t P_t S_prev + sum_{s<=t} (C_t.B_s) exp(c_t - c_s) dt_s x_s
      S  <- exp(c_L) S_prev + sum_s exp(c_L - c_s) dt_s B_s x_s^T

    with c_t the intra-chunk cumulative log-decay; every pairwise factor
    is exp of a non-positive number, so no decay rate overflows.  The
    (B, L, L, H) pairwise decay is built inside the chunk loop, never
    for all chunks at once, and the reference's three-operand einsums
    are contracted pairwise, so no (B, L, L, H, P) temporary is made.
    With G groups ``C_t.B_s`` is (B, L, L, G), each group's scores
    scaling its H/G heads' decays.  f32 throughout.  Shapes as
    ``_ssd_scan``'s; ``t`` a multiple of ``chunk``."""
    bsz, t, h, pdim = x.shape
    g = b_t.shape[2] if b_t.dim() == 4 else 0
    assert t % chunk == 0, (t, chunk)
    nc = t // chunk
    count("model/ssd_chunks", nc)
    a = -torch.exp(a_log)                                  # (H,) negative

    xr = (x * dt_t[..., None]).reshape(bsz, nc, chunk, h, pdim)
    br = b_t.reshape(bsz, nc, chunk, *b_t.shape[2:])
    cr = c_t.reshape(bsz, nc, chunk, *c_t.shape[2:])
    # intra-chunk cumulative log decays (B, nc, L, H), non-positive steps
    cum = torch.cumsum((a[None, None] * dt_t).reshape(bsz, nc, chunk, h),
                       dim=2)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    s = s0
    ys = []
    for c in range(nc):
        xr_c, br_c, cr_c, cum_c = xr[:, c], br[:, c], cr[:, c], cum[:, c]
        dmat = cum_c[:, :, None, :] - cum_c[:, None, :, :]     # (B,L,L,H)
        # exp(c_t - c_s) for s <= t, else 0.  The reference takes exp of
        # the whole matrix and then masks it; masking first gives the
        # same values and keeps exp(+large) out of the backward pass
        dmat = torch.exp(dmat.masked_fill(~tril, -math.inf))
        u = torch.exp(cum_c)                                   # (B,L,H) <= 1
        fac = torch.exp(cum_c[:, -1:, :] - cum_c)              # (B,L,H) <= 1
        if g:
            sc = torch.einsum("btgn,bsgn->btsg", cr_c, br_c)   # (B,L,L,G)
            w = (dmat.unflatten(-1, (g, h // g)) * sc[..., None]).flatten(-2)
            y_intra = torch.einsum("btsh,bshp->bthp", w, xr_c)
            y_inter = torch.einsum(
                "btgn,bgjnp->btgjp", cr_c, _by_group(s, g)).flatten(2, 3)
            s_in = torch.einsum(
                "bsgn,bsgjp->bgjnp", br_c,
                (fac[..., None] * xr_c).unflatten(2, (g, h // g))
            ).flatten(1, 2)
        else:
            sc = torch.einsum("btn,bsn->bts", cr_c, br_c)      # (B,L,L)
            y_intra = torch.einsum("btsh,bshp->bthp", sc[..., None] * dmat,
                                   xr_c)
            y_inter = torch.einsum("btn,bhnp->bthp", cr_c, s)
            s_in = torch.einsum("bsn,bshp->bhnp", br_c, fac[..., None] * xr_c)
        # the incoming state's contribution, and S <- exp(c_L) S + s_in
        y_inter = y_inter * u[..., None]
        s = u[:, -1, :, None, None] * s + s_in
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(bsz, t, h, pdim)
    return y + d_skip[None, None, :, None] * x, s


def _causal_conv(u, w, b, tail=None):
    """Depthwise causal conv1d.  u (B,T,C); w (K,C); tail (B,K-1,C).
    Returns (silu(conv + b), the new tail)."""
    kk = w.shape[0]
    if tail is None:
        tail = torch.zeros((u.shape[0], kk - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    up = torch.cat([tail, u], dim=1)
    out = up[:, 0:u.shape[1]] * w[0][None, None]
    for i in range(1, kk):
        out = out + up[:, i:i + u.shape[1]] * w[i][None, None]
    return F.silu(out + b), up[:, -(kk - 1):]


def mamba2_apply(p: Params, x, cfg: ModelConfig, state=None):
    """x (B,T,D).  ``state``: None (training, from zero) or ``{"conv",
    "ssm"}``.  Returns ``(out (B,T,D), {"conv": new tail, "ssm": S})``.
    The chunked form runs when ``t`` is a positive multiple of CHUNK and
    no state is given, the exact scan otherwise, as the reference
    chooses.  Span ``model/mamba``, the scan inside it ``model/ssd``;
    the chunked form counts its chunks (``model/ssd_chunks``)."""
    with span("model/mamba"):
        return _mamba2(p, x, cfg, state)


def _mamba2(p: Params, x, cfg: ModelConfig, state):
    bsz, t, _ = x.shape
    d_inner, h, pdim, n = _dims(cfg)
    g = _groups(cfg)
    proj = x @ p["w_in"]
    z, xs, bs, cs, dts = torch.split(
        proj, [d_inner, d_inner, g * n, g * n, h], dim=-1)
    conv_in = torch.cat([xs, bs, cs], dim=-1)
    tail = None if state is None else state["conv"]
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      tail)
    xs, bs, cs = torch.split(conv_out, [d_inner, g * n, g * n], dim=-1)
    if g > 1:
        bs, cs = bs.unflatten(-1, (g, n)), cs.unflatten(-1, (g, n))

    # jax.nn.softplus is logaddexp(x, 0); torch's is log1p(exp(x)) and
    # the identity above threshold=20, where the f32 softplus rounds to x
    # anyway: the same function, up to the last bit
    dt_t = F.softplus(dts.to(torch.float32) + p["dt_bias"])   # (B,T,H)
    xh = xs.reshape(bsz, t, h, pdim).to(torch.float32)
    s0 = (torch.zeros((bsz, h, n, pdim), dtype=torch.float32,
                      device=x.device)
          if state is None else state["ssm"])
    f32 = torch.float32
    with span("model/ssd"):
        if t >= CHUNK and t % CHUNK == 0 and state is None:
            y, s_fin = _ssd_chunked(xh, bs.to(f32), cs.to(f32), dt_t,
                                    p["a_log"], p["d_skip"], s0, chunk=CHUNK)
        else:
            y, s_fin = _ssd_scan(xh, bs.to(f32), cs.to(f32), dt_t,
                                 p["a_log"], p["d_skip"], s0)
    y = y.reshape(bsz, t, d_inner).to(x.dtype)
    if g > 1:   # the gated norm over each group's channels
        y = rmsnorm(p["norm/scale"].unflatten(-1, (g, -1)),
                    (y * F.silu(z)).unflatten(-1, (g, -1)),
                    cfg.norm_eps).flatten(-2)
    else:
        y = rmsnorm(p["norm/scale"], y * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"], {"conv": new_tail, "ssm": s_fin}


def make_mamba2_state(cfg: ModelConfig, b: int, dtype, device) -> dict:
    """A zero decode state: the conv tail in ``dtype`` (the model's), the
    SSM state in f32."""
    d_inner, h, p, n = _dims(cfg)
    return {
        "conv": torch.zeros((b, cfg.conv_kernel - 1,
                             d_inner + 2 * _groups(cfg) * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((b, h, n, p), dtype=torch.float32, device=device),
    }
