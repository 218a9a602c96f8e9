"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) -- the
port of the reference's ``repro/models/mla.py``, function by function
and in the same layouts.

KV activations are compressed into a rank-``kv_lora_rank`` latent c_kv
plus a single shared RoPE key head.  Training runs the expanded form
(the latent projected up to per-head keys and values, then
``layers.chunked_attention`` with q/k width ``dn + dr`` and v width
``dv``).  Decode runs the *absorbed* form: W_uk folds into the query and
W_uv into the attention output, so the cache stores only ``(c_kv,
k_rope)`` and a token attends in latent space.  Plain PyTorch products,
as the reference's are XLA's: there is no kernel here.

Leaves (relative to the layer's ``attn``): ``wq`` (d, H, dn + dr),
``w_dkv`` (d, r), ``kv_norm/scale`` (r,), ``w_ukv`` (r, H, dn + dv),
``w_kr`` (d, dr), ``wo`` (H, dv, d).  The decode cache is ``{"ckv" (B, C,
r), "kpos" (B, C) int32, "kr" (B, C, dr)}``, written IN PLACE at slot
``pos % C`` (the reference returns a new cache).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, chunked_attention, rmsnorm


def mla_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one MLA layer, the reference's
    ``init_mla``."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    sc = 0.02
    return [("wq", (d, h, dn + dr), sc),
            ("w_dkv", (d, r), sc),
            ("kv_norm/scale", (r,), ("full", 1.0)),
            ("w_ukv", (r, h, dn + dv), sc),
            ("w_kr", (d, dr), sc),
            ("wo", (h, dv, d), sc / math.sqrt(2 * cfg.n_layers))]


def _q_proj(p, x, cfg: ModelConfig, positions):
    dn = cfg.qk_nope_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    qn, qr = q[..., :dn], q[..., dn:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _latent(p, x, cfg: ModelConfig, positions):
    """The latent ``c_kv`` (B, S, r) and the shared rope key (B, S, dr)."""
    ckv = rmsnorm(p["kv_norm/scale"], x @ p["w_dkv"], cfg.norm_eps)
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)
    return ckv, kr[:, :, 0, :]


def mla_apply(p, x, cfg: ModelConfig):
    """Full-sequence causal MLA (training math, the expanded form)."""
    b, s, _ = x.shape
    dn = cfg.qk_nope_dim
    positions = torch.arange(s, device=x.device).expand(b, s)
    qn, qr = _q_proj(p, x, cfg, positions)
    ckv, kr = _latent(p, x, cfg, positions)
    kv = torch.einsum("bsr,rhe->bshe", ckv, p["w_ukv"])
    kn, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3],
                                                 kr.shape[-1])], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    out = chunked_attention(q, k, v, causal=True, q_offset=0,
                            k_positions=torch.arange(s, device=x.device),
                            q_chunk=cfg.attn_q_chunk)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def mla_decode(p, x, cfg: ModelConfig, cache, pos: int, window: int = 0):
    """Absorbed one-token decode at absolute position ``pos`` (a host
    int): writes the token's latent, rope key and position into slot
    ``pos % C`` of ``cache`` in place and attends in latent space, each
    row over its own valid slots (``kpos`` >= 0 and <= pos; with
    ``window`` > 0 also > pos - window).  Scores in f32, the
    probabilities cast to the cache's dtype for the context product, as
    the reference.  Returns ``y`` (B, 1, D)."""
    b = x.shape[0]
    dn = cfg.qk_nope_dim
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    qn, qr = _q_proj(p, x, cfg, positions)          # (B,1,H,dn),(B,1,H,dr)
    ckv_t, kr_t = _latent(p, x, cfg, positions)     # (B,1,r),(B,1,dr)

    slot = pos % cache["ckv"].shape[1]
    cache["ckv"][:, slot] = ckv_t[:, 0]
    cache["kr"][:, slot] = kr_t[:, 0]
    cache["kpos"][:, slot] = pos
    ckv_c, kr_c, kpos = cache["ckv"], cache["kr"], cache["kpos"]

    w_uk = p["w_ukv"][..., :dn]                     # (r,H,dn)
    w_uv = p["w_ukv"][..., dn:]                     # (r,H,dv)
    q_abs = torch.einsum("bshe,rhe->bshr", qn, w_uk)
    f32 = torch.float32
    scores = (torch.einsum("bshr,bcr->bhsc", q_abs.to(f32), ckv_c.to(f32))
              + torch.einsum("bshe,bce->bhsc", qr.to(f32), kr_c.to(f32))
              ) / math.sqrt(dn + cfg.qk_rope_dim)
    mask = (kpos >= 0) & (kpos <= pos)              # (B, C)
    if window and window > 0:
        mask &= kpos > (pos - window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhsc,bcr->bshr", probs.to(ckv_c.dtype), ckv_c)
    v = torch.einsum("bshr,rhe->bshe", ctx, w_uv)   # (B,1,H,dv)
    return torch.einsum("bshe,hed->bsd", v, p["wo"])


def make_mla_cache(cfg: ModelConfig, b: int, cache_len: int, dtype,
                   device) -> dict:
    """An empty latent cache: zero ``ckv``/``kr``, every position -1."""
    return {
        "ckv": torch.zeros((b, cache_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kpos": torch.full((b, cache_len), -1, dtype=torch.int32,
                           device=device),
        "kr": torch.zeros((b, cache_len, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
    }
