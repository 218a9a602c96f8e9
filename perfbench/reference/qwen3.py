"""The plain reference of Qwen3 (``model_type`` ``qwen3``): RMSNorm,
grouped-query attention with a per-head RMSNorm on queries and keys and
rotary positions, a SwiGLU MLP, the tied embedding as the head.  It
takes no wires."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from perfbench.counts import flops
from perfbench.reference import common as C
from perfbench.reference.common import ONES, Tensor, rmsnorm, rotate

WIRES = False

SMOKE = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, intermediate_size=256,
             vocab_size=512)


@dataclass(frozen=True)
class Model(C.Decoder):
    head_dim: int


def model_of(config: dict) -> Model:
    """The sizes of a configuration file's object."""
    return Model(head_dim=config["head_dim"], **C.decoder_sizes(config))


def program_fields(config: dict) -> dict:
    return C.program_keys(config, {**C.DECODER_KEYS, "head_dim": "head_dim"})


def param_specs(m: Model):
    """Every leaf, each block leaf stacked over the layers."""
    d, h, dh = m.d, m.heads, m.head_dim
    out_std = 0.02 / math.sqrt(2 * m.n_layers)
    block = [("attn/wq", (d, h * dh), 0.02),
             ("attn/wk", (d, m.kv_heads * dh), 0.02),
             ("attn/wv", (d, m.kv_heads * dh), 0.02),
             ("attn/wo", (h * dh, d), out_std),
             ("attn/q_norm/scale", (dh,), ONES),
             ("attn/k_norm/scale", (dh,), ONES),
             ("attn_norm/scale", (d,), ONES), ("mlp_norm/scale", (d,), ONES),
             ("mlp/w_gate", (d, m.d_ff), 0.02), ("mlp/w_up", (d, m.d_ff), 0.02),
             ("mlp/w_down", (m.d_ff, d), out_std)]
    specs = [("blocks/" + n, (m.n_layers, *s), i) for n, s, i in block]
    return C.leaf_order(specs + C.outer_specs(m))


def gqa(p, x: Tensor, m: Model) -> Tensor:
    b, s, _ = x.shape
    dh, g = m.head_dim, m.heads // m.kv_heads
    q = (x @ p["wq"]).view(b, s, m.heads, dh)
    k = (x @ p["wk"]).view(b, s, m.kv_heads, dh)
    v = (x @ p["wv"]).view(b, s, m.kv_heads, dh)
    q = rotate(rmsnorm(q, p["q_norm/scale"], m.eps), m.theta)
    k = rotate(rmsnorm(k, p["k_norm/scale"], m.eps), m.theta)
    # query head i reads key/value head i // g
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    return C.causal_attention(q, k, v).reshape(b, s, -1) @ p["wo"]


def loss(params: Dict[str, Tensor], m: Model, tokens: Tensor,
         wires: Optional[C.Wires] = None) -> Tuple[Tensor, Tensor]:
    """Next-token cross-entropy of ``tokens`` (B, S): ``(xent, xent)``."""
    x = params["embed/table"][tokens]
    for i in range(m.n_layers):
        p = C.layer(params, "blocks/", i)
        x = x + gqa(C.part(p, "attn/"), rmsnorm(x, p["attn_norm/scale"], m.eps),
                    m)
        h = rmsnorm(x, p["mlp_norm/scale"], m.eps)
        x = x + C.swiglu(h, p["mlp/w_gate"], p["mlp/w_up"], p["mlp/w_down"])
    xent = C.next_token_xent(params, m, x, tokens)
    return xent, xent


def step_flops(m: Model, batch: int, seq: int) -> float:
    return flops.step_flops(
        flops.matrix_params(param_specs(m), m.tied),
        flops.attention_flops(batch, seq, m.heads, m.head_dim, m.head_dim,
                              m.n_layers), batch, seq)
