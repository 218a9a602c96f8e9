"""LM assembly -- the dense and the ssm (RWKV-6) paths of the reference's
``repro/models/model.py``:

    init_params(cfg, generator=, device=)  -> params
    forward_train(params, cfg, batch)      -> (logits, aux)
    train_loss(params, cfg, batch)         -> (loss, metrics)
    make_decode_state(cfg, b, cache_len, device) -> state
    decode_step(params, cfg, tok, state, pos)    -> (logits, state)
    count_params_analytic(cfg)             -> int

Params are a flat dict ``{path: tensor}`` keyed by the reference's
pytree path (``"blocks/mlp/w_up"``) and ordered as
``jax.tree_util.tree_flatten`` orders the reference's tree (sorted keys
at every level).  Block leaves keep the reference's stacked ``(L, ...)``
layout: the wire codecs encode whole leaves, and the tile grid of the
blockwise q8 codec (one scale per 64 x 128 elements) spans layer
boundaries, so per-layer parameters would change the wire format.  The
forward pass unbinds each stacked leaf into per-layer views once.

The decode state is a flat dict too, keyed by the reference's state
paths (``"kv/k"``, ``"blocks/wkv"``), its leaves stacked ``(L, B,
...)``; ``decode_step`` updates it IN PLACE, layer by layer through
views, and returns it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R6

Params = Dict[str, torch.Tensor]

_BLOCKS = "blocks/"


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


def param_specs(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...], object]]:
    """Every leaf ``(path, shape, init)`` in the reference's flatten order."""
    block_specs = _family(cfg).specs
    specs = [(_BLOCKS + name, (cfg.n_layers, *shape), init)
             for name, shape, init in block_specs(cfg)]
    specs += [("embed/table", (cfg.vocab_size, cfg.d_model), 0.02),
              ("final_norm/scale", (cfg.d_model,), ONES)]
    if not cfg.tie_embeddings:
        specs.append(("head/w", (cfg.d_model, cfg.vocab_size), 0.02))
    # jax.tree_util orders dict keys sorted at every level
    return sorted(specs, key=lambda s: s[0].split("/"))


def leaf_paths(cfg: ModelConfig) -> List[str]:
    return [path for path, _, _ in param_specs(cfg)]


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> Params:
    """Random params with the reference's distributions (normal with the
    same std, the same constants); the draws are torch's, not JAX's --
    ``repro_torch.weights.params_from_jax`` carries the reference's."""
    dtype = getattr(torch, cfg.dtype)
    params = {}
    for path, shape, init in param_specs(cfg):
        if isinstance(init, tuple):
            t = torch.full(shape, init[1], dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(init).to(dtype)
        params[path] = t
    return params


def count_params_analytic(cfg: ModelConfig) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_specs(cfg))


def _dense_block_fwd(p, x, cfg: ModelConfig):
    x = x + L.attention_apply(_sub(p, "attn/"),
                              L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
                              cfg)
    x = x + L.mlp_apply(_sub(p, "mlp/"),
                        L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps))
    return x


def _rwkv_block_fwd(p, x, cfg: ModelConfig):
    x = x + R6.time_mix_apply(_sub(p, "time/"),
                              L.rmsnorm(p["ln1/scale"], x, cfg.norm_eps), cfg)
    x = x + R6.channel_mix_apply(_sub(p, "channel/"),
                                 L.rmsnorm(p["ln2/scale"], x, cfg.norm_eps))
    return x


def _dense_block_decode(p, x, cfg: ModelConfig, cache, pos: int):
    x = x + L.attention_decode(
        _sub(p, "attn/"), L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
        cfg, cache, pos)
    x = x + L.mlp_apply(_sub(p, "mlp/"),
                        L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps))
    return x


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


class _Family(NamedTuple):
    specs: Callable      # cfg -> one block's (path, shape, init)
    fwd: Callable        # (p, x, cfg) -> x: one block, training
    decode: Callable     # (p, x, cfg, layer state, pos) -> x, state in place
    state_prefix: str    # the decode state's top-level key
    state: Callable      # (cfg, b, cache_len, dtype, device) -> one
    #                      layer's zero decode state


#: the architecture families the port runs
_FAMILIES = {
    "dense": _Family(_dense_block_specs, _dense_block_fwd,
                     _dense_block_decode, "kv/", L.make_attention_cache),
    "ssm": _Family(_rwkv_block_specs, _rwkv_block_fwd, _rwkv_block_decode,
                   "blocks/",
                   lambda cfg, b, cache_len, dtype, device:
                   R6.make_rwkv_state(cfg, b, dtype, device)),
}


def _family(cfg: ModelConfig) -> _Family:
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


def forward_train(params: Params, cfg: ModelConfig, batch
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits over text positions, aux_loss)."""
    x = L.embed(params["embed/table"], batch["tokens"])
    block_fwd = _family(cfg).fwd
    for p in _layers(params, _BLOCKS, cfg.n_layers):
        x = block_fwd(p, x, cfg)
    x = L.rmsnorm(params["final_norm/scale"], x, cfg.norm_eps)
    logits = L.lm_head(params, x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: Params, cfg: ModelConfig, batch, param_tap=None):
    """Next-token cross-entropy (+ aux).  Returns ``(loss, metrics)``.

    ``param_tap``: an identity-valued wrapper applied to the params
    before the forward pass.  The fused backward encode
    (``comm.fused_vjp.encode_on_backward``) taps every leaf here, once,
    so its cotangent -- summed over all of the leaf's uses -- is turned
    into the worker's wire message as backprop produces it.  ``None``
    is the untapped path."""
    if param_tap is not None:
        params = param_tap(params)
    logits, aux = forward_train(params, cfg, batch)
    tokens = batch["tokens"]
    loss = L.softmax_xent(logits[:, :-1], tokens[:, 1:])
    return loss + aux, {"xent": loss, "aux": aux}


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def make_decode_state(cfg: ModelConfig, b: int, cache_len: int,
                      device) -> Params:
    """Zero decode state for ``b`` rows on ``device``, its leaves stacked
    over the layers: ``kv/{k,kpos,v}`` (a ring cache of ``cache_len``
    slots a row) for the dense family, ``blocks/{cm_last,tm_last,wkv}``
    for RWKV-6."""
    fam = _family(cfg)
    one = fam.state(cfg, b, cache_len, getattr(torch, cfg.dtype), device)
    return {fam.state_prefix + k:
            v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def decode_step(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                state: Params, pos: int):
    """One token for the whole batch: ``tok`` (B, 1) int, ``pos`` the
    absolute position written (a host int).  Updates ``state`` in place;
    returns ``(logits (B, 1, V), state)``."""
    fam = _family(cfg)
    x = L.embed(params["embed/table"], tok)
    for p, st in zip(_layers(params, _BLOCKS, cfg.n_layers),
                     _layers(state, fam.state_prefix, cfg.n_layers)):
        x = fam.decode(p, x, cfg, st, pos)
    x = L.rmsnorm(params["final_norm/scale"], x, cfg.norm_eps)
    return L.lm_head(params, x, cfg), state
