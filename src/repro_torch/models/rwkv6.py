"""RWKV-6 "Finch" block (arXiv:2404.05892) -- the port of the
reference's ``repro/models/rwkv6.py``, function by function and in the
same layouts: x (B, T, D); r, k, v, w (B, T, H, K); the per-head bonus u
(H, K).  Parameters are dicts keyed by the reference's names relative to
the layer (``"mu_r"``, ``"w_lora_a"``, ...).

Time-mixing: token-shift lerps feed r/k/v/g projections; the
per-channel decay w_t = exp(-exp(w_base + lora(x))) is data dependent.
Channel-mixing: squared-ReLU MLP gated by a receptance sigmoid.

Training (``state=None``) starts from a zero state and runs the WKV
recurrence through ``kernels.wkv6.ops.wkv6`` (the CUDA kernels on the
card, the plain recurrence on the CPU).  Decode carries a state
(``make_rwkv_state``): the token shift starts from the last token seen,
and the recurrence steps from the carried ``s`` one token at a time
(``wkv_step``, plain PyTorch, as the reference's is plain jnp).
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


def wkv_step(r1, k1, v1, w1, u, s):
    """One decode step: r1, k1, w1 (B, H, K); v1 (B, H, V); s (B, H, K,
    V).  Returns (y (B, H, V), s_new), f32."""
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r1, k1, v1, w1))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf,
                     s + u.to(torch.float32)[None, :, :, None] * kv)
    return y, wf[..., None] * s + kv


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


def _shift(x, last=None):
    """Token shift: x_{t-1}; at t = 0 zeros, or the carried last token
    (B, 1, D)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


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


def time_mix_apply(p: Params, x, cfg: ModelConfig, state=None):
    """Time-mix.  ``state=None``: training from a zero state, returns
    ``out`` (B, T, D).  ``state = (last (B, 1, D), s (B, H, K, V))``:
    decode, the recurrence stepped from ``s`` token by token; returns
    ``(out, (x[:, -1:], s_final))``."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xs = _shift(x, None if state is None else state[0])
    xr, xk, xv, xw, xg = (
        _lerp(x, xs, p[m]) for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = F.silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(b, t, h, hd)

    if state is None:
        y, _ = wkv_scan(r, k, v, w, p["u"])
    else:
        s, ys = state[1], []
        for i in range(t):
            yi, s = wkv_step(r[:, i], k[:, i], v[:, i], w[:, i], p["u"], s)
            ys.append(yi)
        y = torch.stack(ys, dim=1)
    y = y.reshape(b, t, d).to(x.dtype)
    y = _group_norm(y, p["ln_scale"], h, cfg.norm_eps)
    out = (y * g) @ p["wo"]
    return out if state is None else (out, (x[:, -1:], s))


def channel_mix_apply(p: Params, x, state=None):
    """Channel-mix.  ``state=None``: from a zero token shift, returns
    ``out`` (B, T, D); ``state``: the carried last token (B, 1, D),
    returns ``(out, x[:, -1:])``."""
    xs = _shift(x, state)
    xk = _lerp(x, xs, p["mu_k"])
    xr = _lerp(x, xs, p["mu_r"])
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out if state is None else (out, x[:, -1:])


def make_rwkv_state(cfg: ModelConfig, b: int, dtype, device) -> Params:
    """Zero decode state of one block: the two token shifts' last tokens
    and the WKV state (f32)."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return {
        "cm_last": torch.zeros((b, 1, d), dtype=dtype, device=device),
        "tm_last": torch.zeros((b, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((b, d // hd, hd, hd), dtype=torch.float32,
                           device=device),
    }
