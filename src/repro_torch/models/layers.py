"""Transformer substrate: norms, RoPE, grouped-query attention,
cross-attention, SwiGLU MLP (and Zamba2's GELU-gated one with its
adapter), embeddings, the tied head, cross-entropy.

The port of the reference's ``repro/models/layers.py`` (but its unused
``attention_prefill`` and ``cross_attention_apply``'s ``enc_valid``,
which no caller sets), function by function and in the same layouts:
x (B, S, D); q (B, S, H, Dh); k/v (B, S, KV, Dh); projection weights 2-D
(d, H*dh).  Parameters are
passed as dicts keyed by the reference's names relative to the layer
(``"wq"``, ``"q_norm/scale"``, ...).  Attention is written out as
matmul + softmax, as the reference writes it.

Decode (``attention_decode``) writes one token a call into a ring cache
of C slots per batch row, ``{"k", "v": (B, C, KV, Dh), "kpos": (B, C)
int32}``, IN PLACE (the reference returns a new cache): the token at
absolute position ``pos`` goes to slot ``pos % C``, and ``kpos`` holds
each slot's position, -1 where the slot is empty or was invalidated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(dh: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                      # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Grouped-query attention with online softmax over key chunks
# --------------------------------------------------------------------------


def chunked_attention(q, k, v, *, causal: bool, q_offset: int,
                      k_positions: torch.Tensor, k_valid=None,
                      window: int = 0, q_chunk: int = 512, scale=None):
    """Grouped-query attention, softmax in f32.  Up to one key chunk
    (``q_chunk`` keys) it is one masked softmax; longer key sequences run
    the flash-attention recurrence over key chunks with running
    (max, sum, out) accumulators, as the reference does.  ``k_valid``:
    None, or a bool (B, Sk) or (Sk,) mask, False where a key is masked
    out.  ``scale``: the scores' factor, ``1 / sqrt(Dh)`` where None."""
    b, sq, h, dh = q.shape
    dv = v.shape[-1]
    kv = k.shape[2]
    g = h // kv
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kv, g, dh)
    kpos = k_positions.to(torch.int64)
    qpos = q_offset + torch.arange(sq, device=q.device)
    if k_valid is not None and k_valid.dim() == 1:
        k_valid = k_valid[None]

    def block(kc_, kpos_c, kvalid_c):
        """One key block: masked scores (B, KV, G, Sq, kc) in f32."""
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc_).to(torch.float32) * scale
        mask = torch.ones((sq, kc_.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos_c[None, :] <= qpos[:, None]
        if window and window > 0:
            mask &= kpos_c[None, :] > (qpos[:, None] - window)
        if kvalid_c is not None:   # (B or 1, kc): per-row validity
            mask = mask & kvalid_c[:, None, None, None, :]
        return torch.where(mask, s, torch.full_like(s, -1e30))

    kc = min(q_chunk, sk)
    if sq == 1 or sk <= kc:
        p = torch.softmax(block(k, kpos, k_valid), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        return o.reshape(b, sq, h, dv)

    pad = (-sk) % kc
    n_chunks = (sk + pad) // kc
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=2**30)
        if k_valid is not None:
            k_valid = F.pad(k_valid, (0, pad), value=False)

    m = torch.full((b, kv, g, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, kv, g, sq, dv), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kc, (c + 1) * kc)
        s = block(k[:, sl], kpos[sl],
                  None if k_valid is None else k_valid[:, sl])
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype), v[:, sl]).to(torch.float32)
        m = m_new
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.to(v.dtype)


def _qkv(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm/scale"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm/scale"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, wo):
    """(B,S,H,dh) x (H*dh, D) -- plain matmul against the 2-D weight."""
    b, s, h, dh = out.shape
    return out.reshape(b, s, h * dh) @ wo


def attention_apply(p, x, cfg: ModelConfig, scale=None):
    """Full-sequence causal self-attention (``scale``: the softmax's, as
    ``chunked_attention``'s)."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos.expand(b, s))
    out = chunked_attention(q, k, v, causal=True, q_offset=0,
                            k_positions=pos, window=cfg.sliding_window,
                            q_chunk=cfg.attn_q_chunk, scale=scale)
    return _out_proj(out, p["wo"])


def attention_decode(p, x, cfg: ModelConfig, cache, pos: int, scale=None):
    """One-token decode at absolute position ``pos`` (a host int: the
    engine's clock lives on the host, so a tick never waits on the
    device for it).  Writes the token's k/v and position into slot ``pos
    % C`` of ``cache`` in place and attends over the ring: ``kpos`` (B,
    C) marks each row's valid slots, and the causal and window masks
    read the shared clock's positions, ``max_B kpos`` (2**30 where no
    row holds the slot).  ``scale`` as ``attention_apply``'s.  Returns
    ``y`` (B, 1, D)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["kpos"][:, slot] = pos
    kpos = cache["kpos"]
    shared_pos = kpos.amax(dim=0)
    out = chunked_attention(
        q, cache["k"], cache["v"], causal=True, q_offset=pos,
        k_positions=torch.where(shared_pos >= 0, shared_pos, 2**30),
        k_valid=kpos >= 0, window=cfg.sliding_window, q_chunk=1,
        scale=scale)
    return _out_proj(out, p["wo"])


def make_attention_cache(cfg: ModelConfig, b: int, cache_len: int, dtype,
                         device) -> dict:
    """An empty ring cache: zero k/v, every slot's position -1."""
    shape = (b, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "kpos": torch.full((b, cache_len), -1, dtype=torch.int32,
                           device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# --------------------------------------------------------------------------


def cross_attention_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one cross-attention layer, the
    reference's ``init_cross_attention``: its ``wo`` std by
    ``cfg.n_layers``, as the reference's."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return [("wq", (d, h * dh), 0.02), ("wk", (d, kv * dh), 0.02),
            ("wv", (d, kv * dh), 0.02),
            ("wo", (h * dh, d), 0.02 / math.sqrt(2 * cfg.n_layers))]


def cross_attention_kv(p, enc_out, cfg: ModelConfig):
    """The encoder output's keys and values, (B, S_src, KV, Dh) each."""
    b, s, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return ((enc_out @ p["wk"]).reshape(b, s, kv, dh),
            (enc_out @ p["wv"]).reshape(b, s, kv, dh))


def cross_attention_apply(p, x, kv_pair, cfg: ModelConfig):
    """Queries of ``x`` over the encoder's ``(k, v)``, not causal; every
    encoder position is attended to."""
    k, v = kv_pair
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    out = chunked_attention(q, k, v, causal=False, q_offset=0,
                            k_positions=torch.arange(k.shape[1],
                                                     device=x.device),
                            q_chunk=cfg.attn_q_chunk)
    return _out_proj(out, p["wo"])


# --------------------------------------------------------------------------
# MLP, embeddings, head, loss
# --------------------------------------------------------------------------


def wire_boundary(wire, draw, x, e):
    """Block-boundary activation compression: ``x`` through a transport
    wire (``comm.transport.Wire.send``: a codec round trip, straight
    through on the backward pass) with the error-feedback shift ``e``
    threaded; ``draw`` is the send's draws.  An indirection, so layer
    code never imports the comm package.  Returns ``(y, e_new)``."""
    return wire.send(draw, x, e)


def mlp_apply(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def gelu_mlp_apply(p, x, adapter=None):
    """The GELU-gated MLP, ``(gelu(x w_gate) * (x w_up)) w_down`` (GELU
    exact, by erf).  ``adapter``: None, or the leaves ``{"a" (D, r),
    "b_gate", "b_up" (r, F)}`` of a rank-r adapter, whose ``(x a) b_gate``
    and ``(x a) b_up`` add to the gate and the up projection."""
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if adapter is not None:
        low = x @ adapter["a"]
        gate = gate + low @ adapter["b_gate"]
        up = up + low @ adapter["b_up"]
    return (F.gelu(gate) * up) @ p["w_down"]


def embed(table: torch.Tensor, tokens: torch.Tensor):
    return table[tokens]


def lm_head(params, x, cfg: ModelConfig):
    """Tied head (x @ embed^T) or an untied ``head/w``."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed/table"])
    return torch.einsum("bsd,dv->bsv", x, params["head/w"])


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor):
    """Mean cross-entropy in f32; the gold logit by gather (no one-hot)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None])[..., 0]
    return torch.mean(lse - gold)
