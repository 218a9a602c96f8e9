"""RWKV-6 "Finch" block (arXiv:2404.05892) -- the training half of the
reference's ``repro/models/rwkv6.py``, function by function and in the
same layouts: x (B, T, D); r, k, v, w (B, T, H, K); the per-head bonus u
(H, K).  Parameters are dicts keyed by the reference's names relative to
the layer (``"mu_r"``, ``"w_lora_a"``, ...).

Time-mixing: token-shift lerps feed r/k/v/g projections; the
per-channel decay w_t = exp(-exp(w_base + lora(x))) is data dependent.
The WKV recurrence runs through ``kernels.wkv6.ops.wkv6`` (the CUDA
kernels on the card, the plain recurrence on the CPU).  Channel-mixing:
squared-ReLU MLP gated by a receptance sigmoid.

Training only (zero initial state, ``state=None``); the decode step and
its carried state are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6.ops import wkv6

Params = Dict[str, torch.Tensor]

_LORA_RANK = 32


def wkv_scan(r, k, v, w, u):
    """The WKV recurrence from a zero state.  r, k, w: (B, T, H, K); v:
    (B, T, H, V); u: (H, K).  Returns (y (B, T, H, V), s_final (B, H, K,
    V)), f32."""
    return wkv6(r, k, v, w, u)


# --------------------------------------------------------------------------
# Layer params: (path relative to the layer, shape, init) -- init is a
# normal std, or ("full", value)
# --------------------------------------------------------------------------


def time_mix_specs(cfg: ModelConfig) -> List[Tuple[str, tuple, object]]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    sc = 0.02
    return [
        *((m, (d,), ("full", 0.5))
          for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")),
        ("wr", (d, d), sc),
        ("wk", (d, d), sc),
        ("wv", (d, d), sc),
        ("wg", (d, d), sc),
        ("wo", (d, d), sc / math.sqrt(2 * cfg.n_layers)),
        ("w_base", (d,), ("full", -1.0)),
        ("w_lora_a", (d, _LORA_RANK), sc),
        ("w_lora_b", (_LORA_RANK, d), ("full", 0.0)),
        ("u", (h, hd), sc),
        ("ln_scale", (d,), ("full", 1.0)),
    ]


def channel_mix_specs(cfg: ModelConfig) -> List[Tuple[str, tuple, object]]:
    d, f = cfg.d_model, cfg.d_ff
    return [
        ("mu_k", (d,), ("full", 0.5)),
        ("mu_r", (d,), ("full", 0.5)),
        ("wk", (d, f), 0.02),
        ("wv", (f, d), 0.02 / math.sqrt(2 * cfg.n_layers)),
        ("wr", (d, d), 0.02),
    ]


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _shift(x):
    """Token shift: x_{t-1}, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _decay(p: Params, xw):
    ww = xw @ p["w_lora_a"] @ p["w_lora_b"]
    log_w = -torch.exp(
        torch.clamp((p["w_base"] + ww).to(torch.float32), -20.0, 8.0))
    return torch.exp(log_w)  # in (0, 1)


def _group_norm(x, scale, h: int, eps: float = 1e-5):
    """Per-head layer norm on (B, T, D) viewed as (B, T, H, hd)."""
    b, t, d = x.shape
    xh = x.reshape(b, t, h, d // h).to(torch.float32)
    m = torch.mean(xh, dim=-1, keepdim=True)
    v = torch.mean((xh - m) ** 2, dim=-1, keepdim=True)
    y = (xh - m) * torch.rsqrt(v + eps)
    return (y.reshape(b, t, d) * scale.to(torch.float32)).to(x.dtype)


def time_mix_apply(p: Params, x, cfg: ModelConfig):
    """Training time-mix from a zero state.  Returns ``out`` (B, T, D)."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xs = _shift(x)
    xr, xk, xv, xw, xg = (
        _lerp(x, xs, p[m]) for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = F.silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(b, t, h, hd)

    y, _ = wkv_scan(r, k, v, w, p["u"])
    y = y.reshape(b, t, d).to(x.dtype)
    y = _group_norm(y, p["ln_scale"], h, cfg.norm_eps)
    return (y * g) @ p["wo"]


def channel_mix_apply(p: Params, x):
    """Training channel-mix from a zero state.  Returns ``out`` (B, T, D)."""
    xs = _shift(x)
    xk = _lerp(x, xs, p["mu_k"])
    xr = _lerp(x, xs, p["mu_r"])
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
