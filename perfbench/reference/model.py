"""The plain reference of the benchmarked language models: their parameter
layout, forward pass and loss, in plain PyTorch and float32, with the
moe and act wires' codec where a cell sets them.

Two families, read from a configuration file's published keys:

* dense (Qwen3): RMSNorm, grouped-query attention with a per-head
  RMSNorm on queries and keys and rotary positions, a SwiGLU MLP, the
  tied embedding as the head;
* MoE (DeepSeek-V2): multi-head latent attention (the latent ``c_kv``
  of rank ``kv_lora_rank`` expanded to per-head keys and values, one
  shared rotary key head), the first ``first_k_dense_replace`` layers
  with a dense SwiGLU MLP, the rest with a routed SwiGLU mixture of
  ``n_routed_experts`` (softmax router, top-k gates normalised to sum
  to one, GShard capacity slots, the load-balance loss) beside the
  shared experts; an untied head.

Where the configuration's file names a departure of the measured
program from the published model (its ``departures``), this reference
follows the program, so that it checks what is run.

Attention is written out: scores, the causal mask, softmax.  The moe
wire carries the (experts, capacity, d) buffers before and after the
experts, the act wire each block's output: each through an int8 codec
with one max scale and stochastic rounding, straight through on the
backward pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
ONES = ("full", 1.0)


@dataclass(frozen=True)
class Model:
    """The sizes a forward pass needs, from a configuration's keys."""
    family: str              # "dense" | "moe"
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    theta: float
    tied: bool
    # MLA
    kv_rank: int = 0
    nope: int = 0
    rope: int = 0
    v_dim: int = 0
    # MoE
    experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    shared: int = 0
    dense_layers: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.0
    group: int = 4096


def model_of(config: dict) -> Model:
    """The sizes of a configuration file's object."""
    c, a = config, config.get("assumed", {})
    common = dict(n_layers=c["num_hidden_layers"], d=c["hidden_size"],
                  heads=c["num_attention_heads"],
                  kv_heads=c["num_key_value_heads"],
                  d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                  eps=c["rms_norm_eps"], theta=float(c["rope_theta"]),
                  tied=bool(c["tie_word_embeddings"]))
    if "n_routed_experts" not in c:
        return Model("dense", head_dim=c["head_dim"], **common)
    return Model("moe", head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
                 kv_rank=c["kv_lora_rank"], nope=c["qk_nope_head_dim"],
                 rope=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
                 experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
                 moe_ff=c["moe_intermediate_size"],
                 shared=c["n_shared_experts"],
                 dense_layers=c["first_k_dense_replace"],
                 capacity_factor=a["capacity_factor"],
                 aux_coef=a["router_aux_coef"], group=a["moe_group_size"],
                 **common)


# --------------------------------------------------------------------------
# Parameter layout: (path, shape, init), init a normal std or ("full", v)
# --------------------------------------------------------------------------


def _attn_specs(m: Model):
    d, h = m.d, m.heads
    out_std = 0.02 / math.sqrt(2 * m.n_layers)
    if m.family == "moe":
        return [("wq", (d, h, m.nope + m.rope), 0.02),
                ("w_dkv", (d, m.kv_rank), 0.02),
                ("kv_norm/scale", (m.kv_rank,), ONES),
                ("w_ukv", (m.kv_rank, h, m.nope + m.v_dim), 0.02),
                ("w_kr", (d, m.rope), 0.02),
                ("wo", (h, m.v_dim, d), out_std)]
    dh = m.head_dim
    return [("wq", (d, h * dh), 0.02), ("wk", (d, m.kv_heads * dh), 0.02),
            ("wv", (d, m.kv_heads * dh), 0.02), ("wo", (h * dh, d), out_std),
            ("q_norm/scale", (dh,), ONES), ("k_norm/scale", (dh,), ONES)]


def _block_specs(m: Model, routed: bool):
    d = m.d
    out_std = 0.02 / math.sqrt(2 * m.n_layers)
    specs = [(f"attn/{n}", s, i) for n, s, i in _attn_specs(m)]
    specs += [("attn_norm/scale", (d,), ONES), ("mlp_norm/scale", (d,), ONES)]
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
    if m.family == "dense":
        return [("blocks/", m.n_layers, False)]
    return [("dense_blocks/", m.dense_layers, False),
            ("moe_blocks/", m.n_layers - m.dense_layers, True)]


def param_specs(m: Model):
    """Every leaf, each block leaf stacked over its stack's layers, sorted
    by path component (the order of the leaves on the wire)."""
    specs = [(prefix + n, (layers, *s), i)
             for prefix, layers, routed in stacks(m) if layers
             for n, s, i in _block_specs(m, routed)]
    specs += [("embed/table", (m.vocab, m.d), 0.02),
              ("final_norm/scale", (m.d,), ONES)]
    if not m.tied:
        specs.append(("head/w", (m.d, m.vocab), 0.02))
    return sorted(specs, key=lambda s: s[0].split("/"))


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rotate(x: Tensor, theta: float) -> Tensor:
    """Rotary positions over (B, S, H, D): pairs (i, i + D/2) turned by
    ``pos * theta^(-2i/D)``."""
    s, dim = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=x.device) / dim)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """softmax(q k^T / sqrt(D) + causal mask) v over (B, S, H, D)."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


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
    return causal_attention(q, k, v).reshape(b, s, -1) @ p["wo"]


def mla(p, x: Tensor, m: Model) -> Tensor:
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    qn, qr = q[..., :m.nope], rotate(q[..., m.nope:], m.theta)
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_norm/scale"], m.eps)
    kr = rotate((x @ p["w_kr"])[:, :, None, :], m.theta)
    kv = torch.einsum("bsr,rhe->bshe", ckv, p["w_ukv"])
    kn, v = kv[..., :m.nope], kv[..., m.nope:]
    k = torch.cat([kn, kr.expand(-1, -1, m.heads, -1)], -1)
    out = causal_attention(torch.cat([qn, qr], -1), k, v)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# --------------------------------------------------------------------------
# The wires' codec
# --------------------------------------------------------------------------


def int8_roundtrip(x: Tensor, u: Tensor) -> Tensor:
    """Stochastic rounding of ``x / scale`` to int8 with the one scale
    ``max|x| / 127``, decoded: ``q * scale``."""
    scale = torch.clamp_min(x.abs().max(), 1e-30) * torch.tensor(
        1.0 / 127, dtype=torch.float32)
    y = x / scale
    lo = torch.floor(y)
    q = (lo + (u < y - lo).to(torch.float32)).clamp(-128.0, 127.0)
    return q * scale


def through_wire(x: Tensor, u: Tensor, e: Optional[Tensor] = None):
    """The value after the wire, its gradient passed straight through,
    and the residual the next send adds (error feedback): the wire
    carries ``x + e``."""
    with torch.no_grad():
        target = x.detach() if e is None else x.detach() + e
        decoded = int8_roundtrip(target, u)
        residual = target - decoded
    return x + (decoded - x.detach()), residual


class Wires:
    """One worker's sends on the moe and act wires of one round: each
    send's uniforms from the wire's stream at the round, addressed by
    (layer, worker, group, part)."""

    def __init__(self, draws, worker: int, moe: bool, act: bool):
        self.worker = worker
        self.moe = draws.stream("moe").at_round(draws.round) if moe else None
        self.act = draws.stream("act").at_round(draws.round) if act else None

    def moe_send(self, x: Tensor, e, layer: int, group: int, part: str):
        if self.moe is None:
            return x, e
        u = self.moe.send_uniform((layer, self.worker, group, part), x.shape)
        return through_wire(x, u, e)

    def act_send(self, x: Tensor, e, layer: int):
        if self.act is None:
            return x, e
        u = self.act.send_uniform((layer, self.worker, None, None), x.shape)
        return through_wire(x, u, e)


# --------------------------------------------------------------------------
# Mixture of experts
# --------------------------------------------------------------------------


def capacity(tokens: int, m: Model) -> int:
    c = math.ceil(m.capacity_factor * tokens * m.top_k / m.experts)
    return max(8, -(-c // 8) * 8)


def moe(p, x: Tensor, m: Model, wires: Optional[Wires], layer: int):
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
    shared = swiglu(xf, p["shared/w_gate"], p["shared/w_up"],
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


def _layer(params: Dict[str, Tensor], prefix: str, i: int) -> Dict[str, Tensor]:
    return {k[len(prefix):]: v[i] for k, v in params.items()
            if k.startswith(prefix)}


def loss(params: Dict[str, Tensor], m: Model, tokens: Tensor,
         wires: Optional[Wires] = None) -> Tuple[Tensor, Tensor]:
    """Next-token cross-entropy of ``tokens`` (B, S) plus the routers'
    load-balance loss: ``(xent + aux, xent)``."""
    x = params["embed/table"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = 0
    for prefix, n, routed in stacks(m):
        residual = None           # the act wire's, carried within a stack
        for i in range(n):
            p = _layer(params, prefix, i)
            attn = mla if m.family == "moe" else gqa
            x = x + attn({k[5:]: v for k, v in p.items()
                          if k.startswith("attn/")},
                         rmsnorm(x, p["attn_norm/scale"], m.eps), m)
            h = rmsnorm(x, p["mlp_norm/scale"], m.eps)
            if routed:
                y, a = moe({k[4:]: v for k, v in p.items()
                            if k.startswith("moe/")}, h, m, wires, layer)
                aux = aux + a
            else:
                y = swiglu(h, p["mlp/w_gate"], p["mlp/w_up"], p["mlp/w_down"])
            x = x + y
            if wires is not None:
                x, residual = wires.act_send(x, residual, layer)
            layer += 1
    x = rmsnorm(x, params["final_norm/scale"], m.eps)
    head = params["embed/table"].T if m.tied else params["head/w"]
    logits = x @ head
    xent = F.cross_entropy(logits[:, :-1].reshape(-1, m.vocab),
                           tokens[:, 1:].reshape(-1))
    return xent + aux, xent
