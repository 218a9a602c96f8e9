"""The plain reference of Zamba2 (``model_type`` ``zamba2``, arXiv:2411.15242;
Hugging Face's ``Zamba2ForCausalLM`` computes the same): Mamba-2 layers and,
at each of ``hybrid_layer_ids``, one of ``num_mem_blocks`` shared
transformer blocks, used in turn.  It takes no wires.

A Mamba-2 layer is ``x + mamba(rmsnorm(x))``: the input projection to the
gate z, x, B and C (``mamba_ngroups`` groups of ``mamba_d_state``) and dt;
a causal depthwise conv of ``mamba_d_conv`` over (x, B, C), then SiLU;
``dt = softplus(dt + dt_bias)``; the SSD scan, head h reading group ``h //
(heads / groups)``, plus ``D x``; the gated norm ``rmsnorm(y * silu(z))``
over each group's channels; the output projection.

The scan is the SSD paper's chunked form (arXiv:2405.21060, its minimal
listing) at the file's ``chunk_size``, a shorter last chunk where the
sequence is not a multiple of it: within a chunk, the masked scores
``C_t.B_s exp(segsum)`` against ``dt x``; each chunk's state from zero;
the states passed between chunks by the segment sums of the chunks'
total decays; each chunk's output from the state before it.

A hybrid layer i (use j) first runs shared block ``j % num_mem_blocks``
over ``concat(x, e)``, e the token embedding: RMSNorm over the 2 d, causal
attention (``num_attention_heads`` heads of ``attention_head_dim``, RoPE
over every dimension by rotate-half, softmax scale ``(head_dim / 2) **
-0.5``), its output d wide; then with no residual RMSNorm and the
GELU-gated MLP, whose gate and up projections add use j's rank
``adapter_rank`` adapter; then use j's ``linear``.  That output is added
to the input of layer i's Mamba-2 layer: ``x + mamba(rmsnorm(x + t))``.

Only the blocks some hybrid layer uses are held (``min(num_mem_blocks,
uses)``).  The head is the tied embedding (assumed, as the published
config sets no ``tie_word_embeddings`` and transformers' default ties).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.counts import flops
from perfbench.reference import common as C
from perfbench.reference.common import ONES, Tensor, rmsnorm, rotate

WIRES = False

#: six layers, hybrid at 1, 3 and 5: both blocks, block 0 used twice; a
#: chunk of 12 so that the smoke sequences end in a shorter chunk
SMOKE = dict(num_hidden_layers=6, hidden_size=64, attention_hidden_size=128,
             attention_head_dim=32, num_attention_heads=4,
             num_key_value_heads=4, kv_channels=16, num_query_groups=4,
             intermediate_size=128, ffn_hidden_size=128, mamba_d_state=16,
             mamba_headdim=16, n_mamba_heads=8, adapter_rank=8,
             vocab_size=512, chunk_size=12, hybrid_layer_ids=[1, 3, 5],
             layers_block_type=["mamba", "hybrid"] * 3)


@dataclass(frozen=True)
class Model(C.Decoder):
    head_dim: int            # the shared attention's
    ids: Tuple[int, ...]     # the hybrid layers
    mem_blocks: int
    groups: int
    d_state: int
    d_conv: int
    d_inner: int
    m_heads: int
    m_head_dim: int
    rank: int
    chunk: int

    @property
    def blocks(self) -> int:
        """The shared blocks held: those some hybrid layer uses."""
        return min(self.mem_blocks, len(self.ids))


def model_of(config: dict) -> Model:
    """The sizes of a configuration file's object, checked against each
    other."""
    c = config
    kinds = c["layers_block_type"]
    ids = tuple(c["hybrid_layer_ids"])
    assert len(kinds) == c["num_hidden_layers"], (len(kinds), c)
    assert ids == tuple(i for i, k in enumerate(kinds) if k == "hybrid"), ids
    d = c["hidden_size"]
    d_inner = c["mamba_expand"] * d
    assert c["n_mamba_heads"] * c["mamba_headdim"] == d_inner
    assert c["attention_hidden_size"] == 2 * d
    assert c["num_attention_heads"] * c["attention_head_dim"] == 2 * d
    assert c["ffn_hidden_size"] == c["intermediate_size"]
    assert not c["add_bias_linear"] and c["use_conv_bias"]
    assert c["use_mem_rope"] and not c["use_long_context"]
    assert not c["use_shared_attention_adapter"]
    assert c["use_shared_mlp_adapter"] and c["hidden_act"] == "gelu"
    return Model(n_layers=c["num_hidden_layers"], d=d,
                 heads=c["num_attention_heads"],
                 kv_heads=c["num_key_value_heads"],
                 d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                 eps=c["rms_norm_eps"], theta=float(c["rope_theta"]),
                 tied=bool(c["assumed"]["tie_word_embeddings"]),
                 head_dim=c["attention_head_dim"], ids=ids,
                 mem_blocks=c["num_mem_blocks"], groups=c["mamba_ngroups"],
                 d_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"],
                 d_inner=d_inner, m_heads=c["n_mamba_heads"],
                 m_head_dim=c["mamba_headdim"], rank=c["adapter_rank"],
                 chunk=c["chunk_size"])


def program_fields(config: dict) -> dict:
    """The program's ``Zamba2Config`` fields."""
    m = model_of(config)
    return dict(n_layers=m.n_layers, d_model=m.d, n_heads=m.heads,
                n_kv_heads=m.kv_heads, head_dim=m.head_dim, d_ff=m.d_ff,
                vocab_size=m.vocab, norm_eps=m.eps, rope_theta=m.theta,
                tie_embeddings=m.tied, ssm_state=m.d_state,
                rwkv_head_dim=m.m_head_dim, conv_kernel=m.d_conv,
                hybrid_layer_ids=m.ids, num_mem_blocks=m.mem_blocks,
                mamba_ngroups=m.groups, adapter_rank=m.rank)


# --------------------------------------------------------------------------
# Parameter layout: every matrix normal(0, 0.02) (transformers'
# ``initializer_range``), norms 1, the conv bias 0, A = 1..heads, D 1, dt's
# bias softplus^-1(0.01)
# --------------------------------------------------------------------------


def param_specs(m: Model):
    d, di, gn, h = m.d, m.d_inner, m.groups * m.d_state, m.m_heads
    conv = di + 2 * gn
    mamba = [("m2/w_in", (d, 2 * di + 2 * gn + h), 0.02),
             ("m2/conv_w", (m.d_conv, conv), 0.02),
             ("m2/conv_b", (conv,), ("full", 0.0)),
             ("m2/a_log", (h,), ("log_linspace", 1.0, float(h))),
             ("m2/dt_bias", (h,), ("full", -4.6)),
             ("m2/d_skip", (h,), ONES),
             ("m2/norm/scale", (di,), ONES),
             ("m2/w_out", (di, d), 0.02),
             ("norm/scale", (d,), ONES)]
    hd = m.heads * m.head_dim
    shared = [("attn/wq", (2 * d, hd), 0.02), ("attn/wk", (2 * d, hd), 0.02),
              ("attn/wv", (2 * d, hd), 0.02), ("attn/wo", (hd, d), 0.02),
              ("attn_norm/scale", (2 * d,), ONES),
              ("mlp/w_gate", (d, m.d_ff), 0.02),
              ("mlp/w_up", (d, m.d_ff), 0.02),
              ("mlp/w_down", (m.d_ff, d), 0.02),
              ("mlp_norm/scale", (d,), ONES)]
    use = [("adapter/a", (d, m.rank), 0.02),
           ("adapter/b_gate", (m.rank, m.d_ff), 0.02),
           ("adapter/b_up", (m.rank, m.d_ff), 0.02),
           ("linear", (d, d), 0.02)]
    specs = [(prefix + name, (n, *shape), init)
             for prefix, n, part in (("blocks/", m.n_layers, mamba),
                                     ("shared_blocks/", m.blocks, shared),
                                     ("hybrid_blocks/", len(m.ids), use))
             for name, shape, init in part]
    return C.leaf_order(specs + C.outer_specs(m))


# --------------------------------------------------------------------------
# The SSD scan
# --------------------------------------------------------------------------


def segsum(a: Tensor) -> Tensor:
    """(..., T) -> (..., T, T): ``sum(a[j+1..i])`` where ``i >= j``, -inf
    above the diagonal."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), -1)
    x = x.masked_fill(~below, 0.0).cumsum(-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, -math.inf)


def ssd(x: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
        chunk: int) -> Tensor:
    """The SSD of x (B, S, H, P) with steps dt (B, S, H), decay rates a
    (H,), and B, C (B, S, G, N): ``y_t = sum_{s<=t} C_t.B_s exp(sum_{s<r<=t}
    a dt_r) dt_s x_s`` (no D skip), chunk by chunk."""
    rep = x.shape[2] // b.shape[2]
    xd = x * dt[..., None]
    ad = (dt * a).transpose(1, 2)                           # (B, H, S)
    bh, ch = b.repeat_interleave(rep, 2), c.repeat_interleave(rep, 2)
    spans = [slice(s0, min(s0 + chunk, x.shape[1]))
             for s0 in range(0, x.shape[1], chunk)]
    y_diag, states, cums = [], [], []
    for sl in spans:
        cum = ad[..., sl].cumsum(-1)                        # (B, H, L)
        scores = torch.einsum("blgn,bsgn->bgls", c[:, sl], b[:, sl])
        mask = scores.repeat_interleave(rep, 1) * torch.exp(segsum(ad[..., sl]))
        y_diag.append(torch.einsum("bhls,bshp->blhp", mask, xd[:, sl]))
        decay = torch.exp(cum[..., -1:] - cum)              # (B, H, L)
        states.append(torch.einsum("blhn,bhl,blhp->bhpn", bh[:, sl], decay,
                                   xd[:, sl]))
        cums.append(cum)
    # the states entering each chunk: from zero, then each chunk's
    # passed on through the later chunks' total decays
    states = torch.stack([torch.zeros_like(states[0])] + states, 1)
    totals = torch.stack([cum[..., -1] for cum in cums], -1)  # (B, H, nc)
    between = torch.exp(segsum(F.pad(totals, (1, 0))))     # (B, H, nc+1, nc+1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", between, states)
    y = []
    for k, sl in enumerate(spans):
        y_off = torch.einsum("blhn,bhpn,bhl->blhp", ch[:, sl],
                             entering[:, k], torch.exp(cums[k]))
        y.append(y_diag[k] + y_off)
    return torch.cat(y, 1)


def mamba(p: Dict[str, Tensor], x: Tensor, m: Model) -> Tensor:
    bsz, s, _ = x.shape
    gn = m.groups * m.d_state
    z, xbc, dt = torch.split(x @ p["w_in"], [m.d_inner, m.d_inner + 2 * gn,
                                             m.m_heads], -1)
    xbc = F.conv1d(xbc.transpose(1, 2), p["conv_w"].T[:, None, :],
                   p["conv_b"], padding=m.d_conv - 1, groups=xbc.shape[-1])
    xbc = F.silu(xbc[..., :s].transpose(1, 2))
    xs, bs, cs = torch.split(xbc, [m.d_inner, gn, gn], -1)
    xs = xs.reshape(bsz, s, m.m_heads, m.m_head_dim)
    y = ssd(xs, F.softplus(dt + p["dt_bias"]), -torch.exp(p["a_log"]),
            bs.reshape(bsz, s, m.groups, m.d_state),
            cs.reshape(bsz, s, m.groups, m.d_state), m.chunk)
    y = (y + p["d_skip"][:, None] * xs).reshape(bsz, s, m.d_inner)
    gated = (y * F.silu(z)).reshape(bsz, s, m.groups, -1)
    y = rmsnorm(gated, p["norm/scale"].reshape(m.groups, -1), m.eps)
    return y.reshape(bsz, s, m.d_inner) @ p["w_out"]


# --------------------------------------------------------------------------
# The shared block
# --------------------------------------------------------------------------


def attention(p, x: Tensor, m: Model) -> Tensor:
    bsz, s, _ = x.shape
    q, k, v = (rotate((x @ p[w]).view(bsz, s, m.heads, m.head_dim), m.theta)
               if w != "wv" else (x @ p[w]).view(bsz, s, m.heads, m.head_dim)
               for w in ("wq", "wk", "wv"))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (m.head_dim / 2) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(bsz, s, -1) @ p["wo"]


def shared_block(p, use, x: Tensor, e: Tensor, m: Model) -> Tensor:
    """Block ``p`` over ``concat(x, e)`` through ``use``'s adapter and
    ``linear``: what is added to the Mamba-2 layer's input."""
    a = attention(C.part(p, "attn/"),
                  rmsnorm(torch.cat([x, e], -1), p["attn_norm/scale"], m.eps),
                  m)
    h = rmsnorm(a, p["mlp_norm/scale"], m.eps)
    low = h @ use["adapter/a"]
    gate = h @ p["mlp/w_gate"] + low @ use["adapter/b_gate"]
    up = h @ p["mlp/w_up"] + low @ use["adapter/b_up"]
    return ((F.gelu(gate) * up) @ p["mlp/w_down"]) @ use["linear"]


def hidden(params: Dict[str, Tensor], m: Model, tokens: Tensor) -> Tensor:
    """The last layer's output (before the final norm) of (B, S) tokens."""
    e = params["embed/table"][tokens]
    x = e
    for i in range(m.n_layers):
        p = C.layer(params, "blocks/", i)
        into = x
        if i in m.ids:
            j = m.ids.index(i)
            into = x + shared_block(
                C.layer(params, "shared_blocks/", j % m.mem_blocks),
                C.layer(params, "hybrid_blocks/", j), x, e, m)
        x = x + mamba(C.part(p, "m2/"), rmsnorm(into, p["norm/scale"], m.eps),
                      m)
    return x


def loss(params: Dict[str, Tensor], m: Model, tokens: Tensor,
         wires: Optional[C.Wires] = None) -> Tuple[Tensor, Tensor]:
    """Next-token cross-entropy of ``tokens`` (B, S): ``(xent, xent)``."""
    xent = C.next_token_xent(params, m, hidden(params, m, tokens), tokens)
    return xent, xent


def logits(params: Dict[str, Tensor], m: Model, tokens: Tensor) -> Tensor:
    x = rmsnorm(hidden(params, m, tokens), params["final_norm/scale"], m.eps)
    return x @ (params["embed/table"].T if m.tied else params["head/w"])


# --------------------------------------------------------------------------
# FLOPs
# --------------------------------------------------------------------------


def on_path(m: Model):
    """A token runs through each shared block once a use of it: the
    ``shared_blocks`` leaves ``uses / blocks`` times."""
    uses = len(m.ids)

    def path(leaf: str, n: int) -> float:
        return n * uses / m.blocks if leaf.startswith("shared_blocks/") else n
    return path


def ssd_flops(m: Model, batch: int, seq: int) -> float:
    """The SSD's products at ``chunk_size``, forward and backward (3x):
    per chunk of L, the scores ``C B^T`` (2 L^2 N a group), the masked
    scores against ``dt x`` (2 L^2 d_inner), the chunk's state and its
    output from the state before it (2 L N d_inner each)."""
    total = 0.0
    for s0 in range(0, seq, m.chunk):
        n = min(m.chunk, seq - s0)
        total += (2 * n * n * m.d_state * m.groups + 2 * n * n * m.d_inner
                  + 4 * n * m.d_state * m.d_inner)
    return 3 * batch * m.n_layers * total


def step_flops(m: Model, batch: int, seq: int) -> float:
    attn = flops.attention_flops(batch, seq, m.heads, m.head_dim, m.head_dim,
                                 len(m.ids))
    return flops.step_flops(
        flops.matrix_params(param_specs(m), m.tied, on_path(m)),
        attn + ssd_flops(m, batch, seq), batch, seq)
