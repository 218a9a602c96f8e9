"""LM assembly -- the dense, vlm (dense blocks behind a vision prefix),
moe and ssm (RWKV-6) paths of the reference's ``repro/models/model.py``:

    init_params(cfg, generator=, device=)  -> params
    forward_train(params, cfg, batch[, wires, wire_noise]) -> (logits, aux)
    train_loss(params, cfg, batch[, ...])  -> (loss, metrics)
    make_decode_state(cfg, b, cache_len, device) -> state
    decode_step(params, cfg, tok, state, pos)    -> (logits, state)
    count_params_analytic(cfg)             -> int

A family is one or more homogeneous stacks of blocks (``_Stack``): the
dense family and the VLM one stack ``blocks``, the MoE family
``dense_blocks`` (its ``first_dense_layers``) then ``moe_blocks``, RWKV-6
one stack ``blocks``.

Params are a flat dict ``{path: tensor}`` keyed by the reference's
pytree path (``"blocks/mlp/w_up"``) and ordered as
``jax.tree_util.tree_flatten`` orders the reference's tree (sorted keys
at every level).  Block leaves keep the reference's stacked ``(L, ...)``
layout: the wire codecs encode whole leaves, and the tile grid of the
blockwise q8 codec (one scale per 64 x 128 elements) spans layer
boundaries, so per-layer parameters would change the wire format.  The
forward pass unbinds each stacked leaf into per-layer views once.

The decode state is a flat dict too, keyed by the reference's state
paths (``"kv/k"``, ``"kv_moe/k"``, ``"blocks/wkv"``), its leaves stacked
``(L, B, ...)`` per stack; ``decode_step`` updates it IN PLACE, layer by layer through
views, and returns it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6

Params = Dict[str, torch.Tensor]

ONES, ZEROS = ("full", 1.0), ("full", 0.0)


def _dense_block_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one dense block; init is a normal
    std, or ``("full", value)``."""
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    specs = [
        ("attn/wq", (d, h * dh), 0.02),
        ("attn/wk", (d, kv * dh), 0.02),
        ("attn/wv", (d, kv * dh), 0.02),
        ("attn/wo", (h * dh, d), out_std),
        ("attn_norm/scale", (d,), ONES),
        ("mlp_norm/scale", (d,), ONES),
        ("mlp/w_gate", (d, f), 0.02),
        ("mlp/w_up", (d, f), 0.02),
        ("mlp/w_down", (f, d), out_std),
    ]
    if cfg.qkv_bias:
        specs += [("attn/bq", (h * dh,), ZEROS),
                  ("attn/bk", (kv * dh,), ZEROS),
                  ("attn/bv", (kv * dh,), ZEROS)]
    if cfg.qk_norm:
        specs += [("attn/q_norm/scale", (dh,), ONES),
                  ("attn/k_norm/scale", (dh,), ONES)]
    return specs


def _rwkv_block_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one RWKV-6 block."""
    d = cfg.d_model
    return [("ln1/scale", (d,), ONES), ("ln2/scale", (d,), ONES),
            *((f"time/{n}", s, i) for n, s, i in R6.time_mix_specs(cfg)),
            *((f"channel/{n}", s, i) for n, s, i in R6.channel_mix_specs(cfg))]


def _moe_block_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one MoE block: attention, its
    norms and the MoE FFN (``models/moe.py``)."""
    return [s for s in _dense_block_specs(cfg) if not s[0].startswith("mlp/")
            ] + [(f"moe/{n}", sh, i) for n, sh, i in MOE.moe_specs(cfg)]


def param_specs(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...], object]]:
    """Every leaf ``(path, shape, init)`` in the reference's flatten order
    (a stack of no layers has no leaves, as the reference's ``None``)."""
    specs = [(st.prefix + name, (st.n, *shape), init)
             for st in _family(cfg)(cfg) if st.n > 0
             for name, shape, init in st.specs(cfg)]
    specs += [("embed/table", (cfg.vocab_size, cfg.d_model), 0.02),
              ("final_norm/scale", (cfg.d_model,), ONES)]
    if not cfg.tie_embeddings:
        specs.append(("head/w", (cfg.d_model, cfg.vocab_size), 0.02))
    # jax.tree_util orders dict keys sorted at every level
    return sorted(specs, key=lambda s: s[0].split("/"))


def leaf_paths(cfg: ModelConfig) -> List[str]:
    return [path for path, _, _ in param_specs(cfg)]


def leaf_dtype(cfg: ModelConfig, init) -> torch.dtype:
    """A leaf's dtype: the model's, or f32 for ``moe.F32Normal`` (the
    router)."""
    if isinstance(init, MOE.F32Normal):
        return torch.float32
    return getattr(torch, cfg.dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> Params:
    """Random params with the reference's distributions (normal with the
    same std, the same constants); the draws are torch's, not JAX's --
    ``repro_torch.weights.params_from_jax`` carries the reference's."""
    params = {}
    for path, shape, init in param_specs(cfg):
        dtype = leaf_dtype(cfg, init)
        if isinstance(init, tuple):
            t = torch.full(shape, init[1], dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(float(init)).to(dtype)
        params[path] = t
    return params


def count_params_analytic(cfg: ModelConfig) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_specs(cfg))


def _dense_block_fwd(p, x, cfg: ModelConfig, moe=None):
    x = x + L.attention_apply(_sub(p, "attn/"),
                              L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
                              cfg)
    x = x + L.mlp_apply(_sub(p, "mlp/"),
                        L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps))
    return x, None


def _moe_block_fwd(p, x, cfg: ModelConfig, moe=None):
    """``moe``: None, or ``(wire, draw)`` of the moe wire for this layer
    (``draw(group, part)``)."""
    x = x + L.attention_apply(_sub(p, "attn/"),
                              L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
                              cfg)
    wire, draw = (None, None) if moe is None else moe
    y, aux = MOE.moe_apply(_sub(p, "moe/"),
                           L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps),
                           cfg, wire=wire, draw=draw)
    return x + y, aux


def _rwkv_block_fwd(p, x, cfg: ModelConfig, moe=None):
    x = x + R6.time_mix_apply(_sub(p, "time/"),
                              L.rmsnorm(p["ln1/scale"], x, cfg.norm_eps), cfg)
    x = x + R6.channel_mix_apply(_sub(p, "channel/"),
                                 L.rmsnorm(p["ln2/scale"], x, cfg.norm_eps))
    return x, None


def _dense_block_decode(p, x, cfg: ModelConfig, cache, pos: int):
    x = x + L.attention_decode(
        _sub(p, "attn/"), L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
        cfg, cache, pos)
    x = x + L.mlp_apply(_sub(p, "mlp/"),
                        L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps))
    return x


def _moe_block_decode(p, x, cfg: ModelConfig, cache, pos: int):
    x = x + L.attention_decode(
        _sub(p, "attn/"), L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
        cfg, cache, pos)
    y, _ = MOE.moe_apply(_sub(p, "moe/"),
                         L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps), cfg)
    return x + y


def _rwkv_block_decode(p, x, cfg: ModelConfig, st, pos: int):
    y, (tm_last, wkv) = R6.time_mix_apply(
        _sub(p, "time/"), L.rmsnorm(p["ln1/scale"], x, cfg.norm_eps), cfg,
        (st["tm_last"], st["wkv"]))
    x = x + y
    y, cm_last = R6.channel_mix_apply(
        _sub(p, "channel/"), L.rmsnorm(p["ln2/scale"], x, cfg.norm_eps),
        st["cm_last"])
    st["tm_last"].copy_(tm_last)
    st["wkv"].copy_(wkv)
    st["cm_last"].copy_(cm_last)
    return x + y


def _sub(p: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _rwkv_state(cfg, b, cache_len, dtype, device):
    return R6.make_rwkv_state(cfg, b, dtype, device)


class _Stack(NamedTuple):
    """One homogeneous stack of blocks, its leaves stacked ``(n, ...)``."""
    prefix: str          # the params' top-level key, "blocks/"
    n: int               # its layers
    specs: Callable      # cfg -> one block's (path, shape, init)
    fwd: Callable        # (p, x, cfg, moe) -> (x, aux or None): training;
    #                      moe: the moe wire and its draws, or None (a
    #                      block without experts ignores it)
    decode: Callable     # (p, x, cfg, layer state, pos) -> x, state in place
    state_prefix: str    # the decode state's top-level key, "kv/"
    state: Callable      # (cfg, b, cache_len, dtype, device) -> one
    #                      layer's zero decode state


def _dense_stacks(cfg: ModelConfig) -> List[_Stack]:
    return [_Stack("blocks/", cfg.n_layers, _dense_block_specs,
                   _dense_block_fwd, _dense_block_decode, "kv/",
                   L.make_attention_cache)]


def _moe_stacks(cfg: ModelConfig) -> List[_Stack]:
    nd = cfg.first_dense_layers
    return [_Stack("dense_blocks/", nd, _dense_block_specs, _dense_block_fwd,
                   _dense_block_decode, "kv_dense/", L.make_attention_cache),
            _Stack("moe_blocks/", cfg.n_layers - nd, _moe_block_specs,
                   _moe_block_fwd, _moe_block_decode, "kv_moe/",
                   L.make_attention_cache)]


def _ssm_stacks(cfg: ModelConfig) -> List[_Stack]:
    return [_Stack("blocks/", cfg.n_layers, _rwkv_block_specs,
                   _rwkv_block_fwd, _rwkv_block_decode, "blocks/",
                   _rwkv_state)]


#: the architecture families the port runs: each the stacks of its
#: blocks, in the order the forward pass runs them
_FAMILIES = {
    "dense": _dense_stacks,
    "vlm": _dense_stacks,     # dense blocks behind a vision prefix
    "moe": _moe_stacks,
    "ssm": _ssm_stacks,
}


def _family(cfg: ModelConfig) -> Callable[[ModelConfig], List[_Stack]]:
    if cfg.arch_type not in _FAMILIES:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet: ROADMAP queue 1, "
            f"item 9 (other architectures)"
        )
    return _FAMILIES[cfg.arch_type]


def _layers(tree: Params, prefix: str, n: int) -> List[Params]:
    """Per-layer views of the ``prefix`` leaves of a stacked tree, the
    prefix dropped from their names."""
    stacked = {k[len(prefix):]: v.unbind(0)
               for k, v in tree.items() if k.startswith(prefix)}
    return [{k: v[layer] for k, v in stacked.items()} for layer in range(n)]


def _embed_inputs(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings, behind the vision prefix (B, P, D) for the
    ``vision_prefix`` modality."""
    x = L.embed(params["embed/table"], batch["tokens"])
    if cfg.modality == "vision_prefix":
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    return x


def forward_train(params: Params, cfg: ModelConfig, batch, wires=None,
                  wire_noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits over text positions, aux_loss): the sum of the
    layers' aux (the MoE load-balance loss; zero elsewhere).

    ``wires``: a ``comm.transport.Transport`` (or any mapping with
    ``.get``) with the non-gradient wires, and ``wire_noise`` one
    worker's draws on them (``comm.transport.WorkerWireNoise``): the
    ``act`` wire carries each block's output (``layers.wire_boundary``,
    its EF shift threaded across the layers of a stack), the ``moe`` wire the
    expert buffers of each MoE layer, keyed by the layer's global
    index.  ``wires=None`` is the unwired path."""
    act_wire = wires.get("act") if wires is not None else None
    moe_wire = wires.get("moe") if wires is not None else None
    x = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    li = 0
    for st in _family(cfg)(cfg):
        # the act wire's EF shift starts at zero in each stack, as the
        # reference's scan over the stack does
        e = None if act_wire is None else torch.zeros_like(x)
        for p in _layers(params, st.prefix, st.n):
            moe = None if moe_wire is None else (
                moe_wire, lambda g, part, li=li: wire_noise.moe(li, g, part))
            x, a = st.fwd(p, x, cfg, moe)
            if a is not None:
                aux = aux + a
            if act_wire is not None:
                x, e = L.wire_boundary(act_wire, wire_noise.act(li), x, e)
            li += 1
    if cfg.arch_type == "vlm":
        x = x[:, batch["prefix"].shape[1]:]
    x = L.rmsnorm(params["final_norm/scale"], x, cfg.norm_eps)
    logits = L.lm_head(params, x, cfg)
    return logits, aux


def train_loss(params: Params, cfg: ModelConfig, batch, param_tap=None,
               wires=None, wire_noise=None):
    """Next-token cross-entropy plus the aux loss.  Returns ``(loss,
    metrics)``, ``metrics`` ``{"xent", "aux"}``.

    ``param_tap``: an identity-valued wrapper applied to the params
    before the forward pass.  The fused backward encode
    (``comm.fused_vjp.encode_on_backward``) taps every leaf here, once,
    so its cotangent -- summed over all of the leaf's uses -- is turned
    into the worker's wire message as backprop produces it.  ``None``
    is the untapped path.  ``wires`` / ``wire_noise``: the moe and act
    wires (``forward_train``)."""
    if param_tap is not None:
        params = param_tap(params)
    logits, aux = forward_train(params, cfg, batch, wires=wires,
                                wire_noise=wire_noise)
    tokens = batch["tokens"]
    loss = L.softmax_xent(logits[:, :-1], tokens[:, 1:])
    return loss + aux, {"xent": loss, "aux": aux}


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def make_decode_state(cfg: ModelConfig, b: int, cache_len: int,
                      device) -> Params:
    """Zero decode state for ``b`` rows on ``device``, its leaves stacked
    over each stack's layers: ``kv/{k,kpos,v}`` (a ring cache of
    ``cache_len`` slots a row) for the dense family and the VLM,
    ``kv_dense/...`` and ``kv_moe/...`` for the MoE family (a stack of
    no layers keeps leaves of no layers, as the reference's),
    ``blocks/{cm_last,tm_last,wkv}`` for RWKV-6."""
    state = {}
    for st in _family(cfg)(cfg):
        one = st.state(cfg, b, cache_len, getattr(torch, cfg.dtype), device)
        state.update({st.state_prefix + k:
                      v[None].repeat((st.n,) + (1,) * v.dim())
                      for k, v in one.items()})
    return state


def decode_step(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                state: Params, pos: int):
    """One token for the whole batch: ``tok`` (B, 1) int, ``pos`` the
    absolute position written (a host int).  Updates ``state`` in place;
    returns ``(logits (B, 1, V), state)``."""
    x = L.embed(params["embed/table"], tok)
    for st in _family(cfg)(cfg):
        for p, ls in zip(_layers(params, st.prefix, st.n),
                         _layers(state, st.state_prefix, st.n)):
            x = st.decode(p, x, cfg, ls, pos)
    x = L.rmsnorm(params["final_norm/scale"], x, cfg.norm_eps)
    return L.lm_head(params, x, cfg), state
