"""What the plain reference's model families share: the sizes every
decoder reads, the published keys the program's config takes, the
layers (RMSNorm, rotary positions, causal attention, SwiGLU), the head
and its loss, and the moe and act wires' codec.

A family is ``reference/<model_type>.py``, found by the configuration's
published ``model_type`` (``harness.family``).  It gives:

* ``model_of(config)``: the sizes its forward pass reads, with ``.vocab``;
* ``param_specs(m)``: every leaf as ``(path, shape, init)``, init a
  normal std, ``("full", v)`` or ``("log_linspace", lo, hi)``
  (``inputs.make_params``), in the program's leaf order;
* ``loss(params, m, tokens, wires)``: ``(loss, xent)`` of a (B, S) batch;
* ``WIRES``: whether it takes the moe and act wires (``Wires``);
* ``program_fields(config)``: the program's ``ModelConfig`` fields of
  the file's published and assumed sizes;
* ``step_flops(m, batch, seq)``: the model FLOPs of one step
  (``counts/flops.py``);
* ``SMOKE``: the published keys' small values for the tests on the CPU.

Attention is written out: scores, the causal mask, softmax.  A wire
carries its tensor through an int8 codec with one max scale and
stochastic rounding, straight through on the backward pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
ONES = ("full", 1.0)

#: published key -> the program's config field, for every decoder
DECODER_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                "num_attention_heads": "n_heads",
                "num_key_value_heads": "n_kv_heads",
                "intermediate_size": "d_ff", "vocab_size": "vocab_size",
                "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
                "tie_word_embeddings": "tie_embeddings"}


@dataclass(frozen=True)
class Decoder:
    """The sizes every decoder family reads, from a configuration's keys."""
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    eps: float
    theta: float
    tied: bool


def decoder_sizes(c: dict) -> dict:
    """``Decoder``'s fields of a configuration file's object."""
    return dict(n_layers=c["num_hidden_layers"], d=c["hidden_size"],
                heads=c["num_attention_heads"],
                kv_heads=c["num_key_value_heads"],
                d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                eps=c["rms_norm_eps"], theta=float(c["rope_theta"]),
                tied=bool(c["tie_word_embeddings"]))


def program_keys(config: dict, keys: Dict[str, str]) -> dict:
    """The program's fields of the published ``keys`` the file has."""
    return {field_: config[key] for key, field_ in keys.items()
            if key in config}


# --------------------------------------------------------------------------
# Parameter layout: (path, shape, init)
# --------------------------------------------------------------------------


def outer_specs(m: Decoder):
    """The embedding, the final norm and, untied, the head."""
    specs = [("embed/table", (m.vocab, m.d), 0.02),
             ("final_norm/scale", (m.d,), ONES)]
    if not m.tied:
        specs.append(("head/w", (m.d, m.vocab), 0.02))
    return specs


def leaf_order(specs):
    """Sorted by path component: the order of the leaves on the wire."""
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


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def layer(params: Dict[str, Tensor], prefix: str, i: int) -> Dict[str, Tensor]:
    """Layer ``i`` of the stack under ``prefix``, the prefix dropped."""
    return {k[len(prefix):]: v[i] for k, v in params.items()
            if k.startswith(prefix)}


def part(p: Dict[str, Tensor], prefix: str) -> Dict[str, Tensor]:
    """The leaves under ``prefix``, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def next_token_xent(params: Dict[str, Tensor], m: Decoder, x: Tensor,
                    tokens: Tensor) -> Tensor:
    """The final norm, the head (the tied embedding where it is tied) and
    the next-token cross-entropy of ``tokens`` (B, S)."""
    x = rmsnorm(x, params["final_norm/scale"], m.eps)
    head = params["embed/table"].T if m.tied else params["head/w"]
    logits = x @ head
    return F.cross_entropy(logits[:, :-1].reshape(-1, m.vocab),
                           tokens[:, 1:].reshape(-1))


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
