"""The plain reference of DeepSeek-V2 (``model_type`` ``deepseek_v2``):
multi-head latent attention (the latent ``c_kv`` of rank
``kv_lora_rank`` expanded to per-head keys and values, one shared rotary
key head), the first ``first_k_dense_replace`` layers with a dense
SwiGLU MLP, the rest with a routed SwiGLU mixture of
``n_routed_experts`` (softmax router, top-k gates normalised to sum to
one, GShard capacity slots, the load-balance loss) beside the shared
experts; an untied head.

Where the configuration's file names a departure of the measured
program from the published model (its ``departures``), this reference
follows the program, so that it checks what is run.

It takes the moe and act wires: the moe wire carries the (experts,
capacity, d) buffers before and after the experts, the act wire each
block's output.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.counts import flops
from perfbench.reference import common as C
from perfbench.reference.common import ONES, Tensor, rmsnorm, rotate

WIRES = True

SMOKE = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
             num_key_value_heads=2, intermediate_size=256, vocab_size=512,
             kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
             v_head_dim=32, n_routed_experts=4, num_experts_per_tok=2,
             n_shared_experts=1, moe_intermediate_size=64)

#: published key -> the program's config field, besides ``C.DECODER_KEYS``
_KEYS = {"kv_lora_rank": "kv_lora_rank", "qk_rope_head_dim": "qk_rope_dim",
         "qk_nope_head_dim": "qk_nope_dim", "v_head_dim": "v_head_dim",
         "n_routed_experts": "n_experts", "n_shared_experts": "n_shared_experts",
         "num_experts_per_tok": "experts_per_token",
         "moe_intermediate_size": "moe_d_ff",
         "first_k_dense_replace": "first_dense_layers"}
#: sizes the published model leaves open, from the file's ``assumed``
_ASSUMED = ("capacity_factor", "router_aux_coef", "moe_group_size")


@dataclass(frozen=True)
class Model(C.Decoder):
    kv_rank: int
    nope: int
    rope: int
    v_dim: int
    experts: int
    top_k: int
    moe_ff: int
    shared: int
    dense_layers: int
    capacity_factor: float
    aux_coef: float
    group: int


def model_of(config: dict) -> Model:
    """The sizes of a configuration file's object."""
    c, a = config, config["assumed"]
    return Model(kv_rank=c["kv_lora_rank"], nope=c["qk_nope_head_dim"],
                 rope=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
                 experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
                 moe_ff=c["moe_intermediate_size"],
                 shared=c["n_shared_experts"],
                 dense_layers=c["first_k_dense_replace"],
                 capacity_factor=a["capacity_factor"],
                 aux_coef=a["router_aux_coef"], group=a["moe_group_size"],
                 **C.decoder_sizes(c))


def program_fields(config: dict) -> dict:
    kw = C.program_keys(config, {**C.DECODER_KEYS, **_KEYS})
    kw["head_dim"] = config["qk_nope_head_dim"] + config["qk_rope_head_dim"]
    kw.update({k: config["assumed"][k] for k in _ASSUMED
               if k in config.get("assumed", {})})
    return kw


# --------------------------------------------------------------------------
# Parameter layout
# --------------------------------------------------------------------------


def _block_specs(m: Model, routed: bool):
    d, h = m.d, m.heads
    out_std = 0.02 / math.sqrt(2 * m.n_layers)
    specs = [("attn/wq", (d, h, m.nope + m.rope), 0.02),
             ("attn/w_dkv", (d, m.kv_rank), 0.02),
             ("attn/kv_norm/scale", (m.kv_rank,), ONES),
             ("attn/w_ukv", (m.kv_rank, h, m.nope + m.v_dim), 0.02),
             ("attn/w_kr", (d, m.rope), 0.02),
             ("attn/wo", (h, m.v_dim, d), out_std),
             ("attn_norm/scale", (d,), ONES), ("mlp_norm/scale", (d,), ONES)]
    if not routed:
        return specs + [("mlp/w_gate", (d, m.d_ff), 0.02),
                        ("mlp/w_up", (d, m.d_ff), 0.02),
                        ("mlp/w_down", (m.d_ff, d), out_std)]
    e, f, fs = m.experts, m.moe_ff, m.moe_ff * m.shared
    return specs + [("moe/router", (d, e), 0.02),
                    ("moe/w_gate", (e, d, f), 0.02),
                    ("moe/w_up", (e, d, f), 0.02),
                    ("moe/w_down", (e, f, d), out_std),
                    ("moe/shared/w_gate", (d, fs), 0.02),
                    ("moe/shared/w_up", (d, fs), 0.02),
                    ("moe/shared/w_down", (fs, d), out_std)]


def stacks(m: Model) -> List[Tuple[str, int, bool]]:
    """(prefix, layers, routed) of each stack of blocks, in walk order."""
    return [("dense_blocks/", m.dense_layers, False),
            ("moe_blocks/", m.n_layers - m.dense_layers, True)]


def param_specs(m: Model):
    """Every leaf, each block leaf stacked over its stack's layers."""
    specs = [(prefix + n, (layers, *s), i)
             for prefix, layers, routed in stacks(m) if layers
             for n, s, i in _block_specs(m, routed)]
    return C.leaf_order(specs + C.outer_specs(m))


# --------------------------------------------------------------------------
# Attention and the mixture of experts
# --------------------------------------------------------------------------


def mla(p, x: Tensor, m: Model) -> Tensor:
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    qn, qr = q[..., :m.nope], rotate(q[..., m.nope:], m.theta)
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_norm/scale"], m.eps)
    kr = rotate((x @ p["w_kr"])[:, :, None, :], m.theta)
    kv = torch.einsum("bsr,rhe->bshe", ckv, p["w_ukv"])
    kn, v = kv[..., :m.nope], kv[..., m.nope:]
    k = torch.cat([kn, kr.expand(-1, -1, m.heads, -1)], -1)
    out = C.causal_attention(torch.cat([qn, qr], -1), k, v)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def capacity(tokens: int, m: Model) -> int:
    c = math.ceil(m.capacity_factor * tokens * m.top_k / m.experts)
    return max(8, -(-c // 8) * 8)


def moe(p, x: Tensor, m: Model, wires: Optional[C.Wires], layer: int):
    """Routed experts beside the shared ones over x (B, S, D); returns
    ``(y, aux)``.  Tokens route in groups of ``m.group`` (zero rows pad
    the last group and take capacity); within a group each token's k
    choices queue for their experts' C slots in slot-major order (all
    first choices before any second choice), and a choice past its
    expert's C slots is dropped."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    n = xf.shape[0]
    g = min(m.group, n)
    pad = (-n) % g
    xp = F.pad(xf, (0, 0, 0, pad))
    ys, auxs = [], []
    shift = (None, None)          # the wire's residuals, carried group to group
    for gi in range((n + pad) // g):
        y, aux, shift = _moe_group(p, xp[gi * g:(gi + 1) * g], m, wires,
                                   layer, gi, shift)
        ys.append(y)
        auxs.append(aux)
    y = torch.cat(ys)[:n]
    shared = C.swiglu(xf, p["shared/w_gate"], p["shared/w_up"],
                      p["shared/w_down"])
    return (y + shared).reshape(b, s, d), torch.stack(auxs).mean()


def _moe_group(p, x: Tensor, m: Model, wires, layer: int, group: int,
               shift):
    n, d = x.shape
    e, k, c = m.experts, m.top_k, capacity(n, m)
    probs = torch.softmax(x @ p["router"], -1)
    # k largest, ties to the lower expert
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / torch.clamp_min(top[:, :k].sum(-1, keepdim=True),
                                         1e-9)
    idx = idx[:, :k]
    # queue position of choice (token t, slot j) at its expert, slot-major
    expert = idx.T.reshape(-1)                                  # (k n,)
    onehot = F.one_hot(expert, e)
    slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)            # (k n,)
    kept = slot < c
    token = torch.arange(n, device=x.device).repeat(k)
    gate = gates.T.reshape(-1)
    ke, ks, kt, kg = expert[kept], slot[kept], token[kept], gate[kept]

    xe = x.new_zeros(e, c, d).index_put((ke, ks), x[kt])
    e_disp, e_comb = shift
    if wires is not None:
        xe, e_disp = wires.moe_send(xe, e_disp, layer, group, "dispatch")
    ye = torch.bmm(F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(
        xe, p["w_up"]), p["w_down"])
    if wires is not None:
        ye, e_comb = wires.moe_send(ye, e_comb, layer, group, "combine")
    y = x.new_zeros(n, d).index_add(0, kt, ye[ke, ks] * kg[:, None])

    routed = onehot.reshape(k, n, e).sum(0).to(torch.float32).mean(0)
    aux = e * torch.sum(probs.mean(0) * routed) * m.aux_coef
    return y, aux, (e_disp, e_comb)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


def loss(params: Dict[str, Tensor], m: Model, tokens: Tensor,
         wires: Optional[C.Wires] = None) -> Tuple[Tensor, Tensor]:
    """Next-token cross-entropy of ``tokens`` (B, S) plus the routers'
    load-balance loss: ``(xent + aux, xent)``."""
    x = params["embed/table"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = 0
    for prefix, n, routed in stacks(m):
        residual = None           # the act wire's, carried within a stack
        for i in range(n):
            p = C.layer(params, prefix, i)
            x = x + mla(C.part(p, "attn/"),
                        rmsnorm(x, p["attn_norm/scale"], m.eps), m)
            h = rmsnorm(x, p["mlp_norm/scale"], m.eps)
            if routed:
                y, a = moe(C.part(p, "moe/"), h, m, wires, layer)
                aux = aux + a
            else:
                y = C.swiglu(h, p["mlp/w_gate"], p["mlp/w_up"],
                             p["mlp/w_down"])
            x = x + y
            if wires is not None:
                x, residual = wires.act_send(x, residual, layer)
            layer += 1
    xent = C.next_token_xent(params, m, x, tokens)
    return xent + aux, xent


def on_path(m: Model):
    def count(path: str, n: int):
        name = path.split("/")
        if "moe" in name and "shared" not in name and "router" not in name:
            return n * m.top_k / m.experts      # routed experts: k of n
        return n
    return count


def step_flops(m: Model, batch: int, seq: int) -> float:
    return flops.step_flops(
        flops.matrix_params(param_specs(m), m.tied, on_path(m)),
        flops.attention_flops(batch, seq, m.heads, m.nope + m.rope, m.v_dim,
                              m.n_layers), batch, seq)
