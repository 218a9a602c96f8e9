"""LM assembly -- every architecture family of the reference's
``repro/models/model.py``:

    init_params(cfg, generator=, device=)  -> params
    forward_train(params, cfg, batch[, wires, wire_noise]) -> (logits, aux)
    train_loss(params, cfg, batch[, ...])  -> (loss, metrics)
    make_decode_state(cfg, b, cache_len, device[, enc_len]) -> state
    decode_step(params, cfg, tok, state, pos)    -> (logits, state)
    count_params_analytic(cfg)             -> int

A family (``_Family``) is its stacks of blocks (``_Stack``: the params'
layout and the decode state's) and its walk: the blocks the residual
stream runs through, in order, each a layer of a stack.  The dense
family and the VLM walk one stack ``blocks``; the MoE family
``dense_blocks`` (its ``first_dense_layers``) then ``moe_blocks``; RWKV-6
``blocks``; the hybrid (Zamba2) its Mamba-2 ``blocks`` in segments of
``attn_every`` with ONE shared attention block (``shared_attn``, leaves
not stacked) after each whole segment, the JAX reference's
simplification of Zamba2; the published Zamba2 block (``zamba2``, the
port-only ``Zamba2Config``) its Mamba-2 ``blocks`` (grouped B/C) with,
at each of its ``hybrid_layer_ids``, a ``hybrid_blocks`` step: shared
block ``j % num_mem_blocks`` of ``shared_blocks`` over the hidden state
and the token embedding concatenated, through use j's own adapter and
``linear``, added to that layer's Mamba-2 input; the audio
encoder-decoder its decoder ``blocks``, each with cross-attention to the
encoder's output (the family's encoder, ``enc_blocks`` over the
``frames``, run before the walk).  ``forward_train`` and
``decode_step`` both follow the walk.
Attention is multi-head latent attention (``models/mla.py``) where
``cfg.use_mla``, grouped-query attention elsewhere.

Params are a flat dict ``{path: tensor}`` keyed by the reference's
pytree path (``"blocks/mlp/w_up"``) and ordered as
``jax.tree_util.tree_flatten`` orders the reference's tree (sorted keys
at every level).  Block leaves keep the reference's stacked ``(L, ...)``
layout: the wire codecs encode whole leaves, and the tile grid of the
blockwise q8 codec (one scale per 64 x 128 elements) spans layer
boundaries, so per-layer parameters would change the wire format.  The
forward pass unbinds each stacked leaf into per-layer views once.

The decode state is a flat dict too, keyed by the reference's state
paths (``"kv/k"``, ``"kv_moe/ckv"``, ``"blocks/wkv"``, ``"shared_kv/k"``,
``"xkv/k"``), its leaves stacked ``(L, B, ...)`` per stack (the shared
block's per use); ``decode_step`` updates it IN PLACE, layer by layer
through views, and returns it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.spans import span

Params = Dict[str, torch.Tensor]

ONES, ZEROS = ("full", 1.0), ("full", 0.0)


# --------------------------------------------------------------------------
# Blocks: (relative path, shape, init) of one block; init is a normal std,
# ``moe.F32Normal``, ``("full", value)`` or ``mamba2.F32Init``
# --------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig):
    """One self-attention layer: MLA where ``cfg.use_mla``, else
    grouped-query attention."""
    if cfg.use_mla:
        return MLA.mla_specs(cfg)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = [("wq", (d, h * dh), 0.02),
             ("wk", (d, kv * dh), 0.02),
             ("wv", (d, kv * dh), 0.02),
             ("wo", (h * dh, d), 0.02 / math.sqrt(2 * cfg.n_layers))]
    if cfg.qkv_bias:
        specs += [("bq", (h * dh,), ZEROS), ("bk", (kv * dh,), ZEROS),
                  ("bv", (kv * dh,), ZEROS)]
    if cfg.qk_norm:
        specs += [("q_norm/scale", (dh,), ONES), ("k_norm/scale", (dh,), ONES)]
    return specs


def _dense_block_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    return [*((f"attn/{n}", sh, i) for n, sh, i in _attn_specs(cfg)),
            ("attn_norm/scale", (d,), ONES),
            ("mlp_norm/scale", (d,), ONES),
            ("mlp/w_gate", (d, f), 0.02),
            ("mlp/w_up", (d, f), 0.02),
            ("mlp/w_down", (f, d), out_std)]


def _rwkv_block_specs(cfg: ModelConfig):
    d = cfg.d_model
    return [("ln1/scale", (d,), ONES), ("ln2/scale", (d,), ONES),
            *((f"time/{n}", s, i) for n, s, i in R6.time_mix_specs(cfg)),
            *((f"channel/{n}", s, i) for n, s, i in R6.channel_mix_specs(cfg))]


def _moe_block_specs(cfg: ModelConfig):
    """Attention, its norms and the MoE FFN (``models/moe.py``)."""
    return [s for s in _dense_block_specs(cfg) if not s[0].startswith("mlp/")
            ] + [(f"moe/{n}", sh, i) for n, sh, i in MOE.moe_specs(cfg)]


def _mamba_block_specs(cfg: ModelConfig):
    return [("norm/scale", (cfg.d_model,), ONES),
            *((f"m2/{n}", s, i) for n, s, i in M2.mamba2_specs(cfg))]


def _zamba2_shared_specs(cfg: ModelConfig):
    """One shared block of Zamba2: attention over the 2 d wide hidden
    state and embedding concatenated, its output d wide, and the
    GELU-gated MLP (its adapters are the uses')."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    return [("attn/wq", (2 * d, hd), 0.02), ("attn/wk", (2 * d, hd), 0.02),
            ("attn/wv", (2 * d, hd), 0.02), ("attn/wo", (hd, d), 0.02),
            ("attn_norm/scale", (2 * d,), ONES),
            ("mlp_norm/scale", (d,), ONES),
            ("mlp/w_gate", (d, f), 0.02), ("mlp/w_up", (d, f), 0.02),
            ("mlp/w_down", (f, d), 0.02)]


def _zamba2_use_specs(cfg: ModelConfig):
    """One use of a shared block (a hybrid layer): the MLP's rank-r
    adapter and the output's ``linear``."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    return [("adapter/a", (d, r), 0.02), ("adapter/b_gate", (r, f), 0.02),
            ("adapter/b_up", (r, f), 0.02), ("linear", (d, d), 0.02)]


def _xattn_block_specs(cfg: ModelConfig):
    """The audio decoder's block: a dense block with cross-attention."""
    return _dense_block_specs(cfg) + [
        ("xattn_norm/scale", (cfg.d_model,), ONES),
        *((f"xattn/{n}", s, i) for n, s, i in L.cross_attention_specs(cfg))]


def param_specs(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...], object]]:
    """Every leaf ``(path, shape, init)`` in the reference's flatten order
    (a stack of no layers has no leaves, as the reference's ``None``)."""
    fam = _family(cfg)
    stacks = fam.stacks + ([fam.encoder] if fam.encoder is not None else [])
    specs = [(st.prefix + name, shape if st.n is None else (st.n, *shape),
              init)
             for st in stacks if st.n != 0
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
    router) and ``mamba2.F32Init`` (Mamba-2's ``a_log``, ``dt_bias``,
    ``d_skip``)."""
    if isinstance(init, (MOE.F32Normal, M2.F32Init)):
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
        if isinstance(init, tuple) and init[0] == "log_linspace":
            t = torch.log(torch.linspace(
                init[1], init[2], shape[-1], dtype=torch.float32,
                device=device)).to(dtype).expand(shape).contiguous()
        elif isinstance(init, tuple):
            t = torch.full(shape, init[1], dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(float(init)).to(dtype)
        params[path] = t
    return params


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count; ``active_only`` counts a MoE's routed experts at
    ``experts_per_token / n_experts`` (the params a token runs through),
    each leaf truncated to an int as the reference's."""
    frac = (cfg.experts_per_token / cfg.n_experts
            if active_only and cfg.is_moe else 1.0)
    total = 0
    for path, shape, _ in param_specs(cfg):
        names = path.split("/")
        routed = (any(n in ("w_gate", "w_up", "w_down") for n in names)
                  and "moe" in names and "shared" not in names)
        total += int(math.prod(shape) * (frac if routed else 1.0))
    return total


# --------------------------------------------------------------------------
# Blocks: training forward (p, x, cfg, moe=, enc=) -> (x, aux or None) and
# decode (p, x, cfg, state entry, pos) -> x, the state updated in place
# --------------------------------------------------------------------------


def _attn_apply(p, x, cfg: ModelConfig):
    if cfg.use_mla:
        return MLA.mla_apply(p, x, cfg)
    return L.attention_apply(p, x, cfg)


def _attn_decode(p, x, cfg: ModelConfig, cache, pos: int):
    if cfg.use_mla:
        return MLA.mla_decode(p, x, cfg, cache, pos, window=cfg.sliding_window)
    return L.attention_decode(p, x, cfg, cache, pos)


def _attn_state(cfg, b, cache_len, enc_len, dtype, device):
    if cfg.use_mla:
        return MLA.make_mla_cache(cfg, b, cache_len, dtype, device)
    return L.make_attention_cache(cfg, b, cache_len, dtype, device)


def _self_attn(p, x, cfg: ModelConfig):
    return x + _attn_apply(_sub(p, "attn/"),
                           L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
                           cfg)


def _self_attn_decode(p, x, cfg: ModelConfig, cache, pos: int):
    return x + _attn_decode(_sub(p, "attn/"),
                            L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps),
                            cfg, cache, pos)


def _mlp(p, x, cfg: ModelConfig):
    return x + L.mlp_apply(_sub(p, "mlp/"),
                           L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps))


def _dense_block_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    return _mlp(p, _self_attn(p, x, cfg), cfg), None


def _moe_block_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    """``moe``: None, or ``(wire, draw)`` of the moe wire for this layer
    (``draw(group, part)``)."""
    x = _self_attn(p, x, cfg)
    wire, draw = (None, None) if moe is None else moe
    y, aux = MOE.moe_apply(_sub(p, "moe/"),
                           L.rmsnorm(p["mlp_norm/scale"], x, cfg.norm_eps),
                           cfg, wire=wire, draw=draw)
    return x + y, aux


def _rwkv_block_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    x = x + R6.time_mix_apply(_sub(p, "time/"),
                              L.rmsnorm(p["ln1/scale"], x, cfg.norm_eps), cfg)
    x = x + R6.channel_mix_apply(_sub(p, "channel/"),
                                 L.rmsnorm(p["ln2/scale"], x, cfg.norm_eps))
    return x, None


def _mamba_block_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    y, _ = M2.mamba2_apply(_sub(p, "m2/"),
                           L.rmsnorm(p["norm/scale"], x, cfg.norm_eps), cfg)
    return x + y, None


def _zamba2_scale(cfg: ModelConfig) -> float:
    """Zamba2's softmax scale, ``(head_dim / 2) ** -0.5``."""
    return (cfg.head_dim / 2) ** -0.5


def _zamba2_shared(p, x, enc, cfg: ModelConfig, attend):
    """What a use of a shared block adds to its Mamba-2 layer's input:
    the block over ``concat(x, enc)``, ``enc`` the token embedding
    (``attend(attention leaves, h)`` its attention), the MLP over the
    attention's output with no residual, the use's adapter added, then
    the use's ``linear``.  ``p``: the use's leaves, its block's under
    ``shared/`` (``_zamba2_join``).  Span ``model/shared``, once a
    use."""
    with span("model/shared"):
        h = L.rmsnorm(p["shared/attn_norm/scale"], torch.cat([x, enc], -1),
                      cfg.norm_eps)
        a = attend(_sub(p, "shared/attn/"), h)
        h = L.rmsnorm(p["shared/mlp_norm/scale"], a, cfg.norm_eps)
        y = L.gelu_mlp_apply(_sub(p, "shared/mlp/"), h, _sub(p, "adapter/"))
        return y @ p["linear"]


def _zamba2_mamba(p, x, t, cfg: ModelConfig, state=None):
    """The hybrid layer's Mamba-2 layer (its leaves under ``mamba/``),
    the shared block's output ``t`` added to its input: ``x +
    mamba(norm(x + t))`` is the layer's output."""
    return M2.mamba2_apply(_sub(p, "mamba/m2/"),
                           L.rmsnorm(p["mamba/norm/scale"], x + t,
                                     cfg.norm_eps), cfg, state)


def _zamba2_hybrid_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    """A Zamba2 hybrid layer over ``enc``, the token embedding."""
    t = _zamba2_shared(p, x, enc, cfg, lambda pa, h: L.attention_apply(
        pa, h, cfg, scale=_zamba2_scale(cfg)))
    y, _ = _zamba2_mamba(p, x, t, cfg)
    return x + y, None


def _zamba2_hybrid_decode(p, x, cfg: ModelConfig, st, pos: int, enc=None):
    """``st``: the use's attention cache under ``kv/`` (its K/V
    ``n_heads x head_dim`` wide), its Mamba-2 layer's ``conv`` and
    ``ssm``."""
    t = _zamba2_shared(p, x, enc, cfg, lambda pa, h: L.attention_decode(
        pa, h, cfg, _sub(st, "kv/"), pos, scale=_zamba2_scale(cfg)))
    y, new = _zamba2_mamba(p, x, t, cfg, st)
    st["conv"].copy_(new["conv"])
    st["ssm"].copy_(new["ssm"])
    return x + y


def _cross_attn(p, x, cfg: ModelConfig, kv_pair):
    return x + L.cross_attention_apply(
        _sub(p, "xattn/"), L.rmsnorm(p["xattn_norm/scale"], x, cfg.norm_eps),
        kv_pair, cfg)


def _xattn_block_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    """The audio decoder's block over ``enc``, the encoder's output."""
    x = _self_attn(p, x, cfg)
    x = _cross_attn(p, x, cfg, L.cross_attention_kv(_sub(p, "xattn/"), enc,
                                                    cfg))
    return _mlp(p, x, cfg), None


def _bidir_attn(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = L._qkv(p, x, cfg, pos.expand(b, s))
    out = L.chunked_attention(q, k, v, causal=False, q_offset=0,
                              k_positions=pos, q_chunk=cfg.attn_q_chunk)
    return L._out_proj(out, p["wo"])


def _encoder_block_fwd(p, x, cfg: ModelConfig, moe=None, enc=None):
    """The audio encoder's block: a dense block, attention not causal."""
    x = x + _bidir_attn(_sub(p, "attn/"),
                        L.rmsnorm(p["attn_norm/scale"], x, cfg.norm_eps), cfg)
    return _mlp(p, x, cfg), None


def _dense_block_decode(p, x, cfg: ModelConfig, cache, pos: int):
    return _mlp(p, _self_attn_decode(p, x, cfg, cache, pos), cfg)


def _moe_block_decode(p, x, cfg: ModelConfig, cache, pos: int):
    x = _self_attn_decode(p, x, cfg, cache, pos)
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


def _mamba_block_decode(p, x, cfg: ModelConfig, st, pos: int, enc=None):
    y, new = M2.mamba2_apply(_sub(p, "m2/"),
                             L.rmsnorm(p["norm/scale"], x, cfg.norm_eps),
                             cfg, st)
    st["conv"].copy_(new["conv"])
    st["ssm"].copy_(new["ssm"])
    return x + y


def _xattn_block_decode(p, x, cfg: ModelConfig, st, pos: int):
    """``st``: the layer's self-attention cache under ``kv/``, the
    encoder's keys and values under ``xkv/``."""
    x = _self_attn_decode(p, x, cfg, _sub(st, "kv/"), pos)
    x = _cross_attn(p, x, cfg, (st["xkv/k"], st["xkv/v"]))
    return _mlp(p, x, cfg)


def _sub(p: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _rwkv_state(cfg, b, cache_len, enc_len, dtype, device):
    return R6.make_rwkv_state(cfg, b, dtype, device)


def _mamba_state(cfg, b, cache_len, enc_len, dtype, device):
    return M2.make_mamba2_state(cfg, b, dtype, device)


def _zamba2_hybrid_state(cfg, b, cache_len, enc_len, dtype, device):
    return {**{f"kv/{k}": v for k, v in L.make_attention_cache(
                cfg, b, cache_len, dtype, device).items()},
            **M2.make_mamba2_state(cfg, b, dtype, device)}


def _xattn_state(cfg, b, cache_len, enc_len, dtype, device):
    """The audio decoder's layer: its self-attention cache (``kv/``) and
    the encoder's keys and values (``xkv/``, (B, enc_len, KV, Dh) zeros,
    as the reference's; the caller fills them from the encoder)."""
    shape = (b, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return {**{f"kv/{k}": v for k, v in _attn_state(
                cfg, b, cache_len, enc_len, dtype, device).items()},
            "xkv/k": torch.zeros(shape, dtype=dtype, device=device),
            "xkv/v": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# Families
# --------------------------------------------------------------------------


class _Stack(NamedTuple):
    """One homogeneous stack of blocks."""
    prefix: str          # the params' top-level key, "blocks/"
    n: Optional[int]     # its layers, each leaf stacked (n, ...); None:
    #                      ONE block, its leaves not stacked (the shared
    #                      attention block)
    specs: Callable      # cfg -> one block's (path, shape, init)
    fwd: Callable        # (p, x, cfg, moe=, enc=) -> (x, aux or None):
    #                      training; moe: the moe wire and its draws, or
    #                      None (a block without experts ignores it); enc:
    #                      the encoder's output, or None
    decode: Optional[Callable] = None   # (p, x, cfg, state entry, pos) ->
    #                      x, the state in place (None only for a stack
    #                      no step of the walk runs, a family's encoder);
    #                      ``enc=`` the token embedding too where the
    #                      family's ``embedding_in``
    state_prefix: str = ""   # the decode state's top-level key, "kv/"
    #                      ("": the entry's keys are whole paths; only a
    #                      family's one stack)
    state: Optional[Callable] = None    # (cfg, b, cache_len, enc_len,
    #                      dtype, device) -> one entry's zero decode state
    #                      (None only for a family's encoder)


class _Family(NamedTuple):
    stacks: List[_Stack]
    #: the residual stream's blocks in the order they run: (stack, its
    #: layer -- 0 for a block not stacked --, its decode state entry)
    walk: List[Tuple[int, int, int]]
    #: the stack run over the batch's ``frames`` before the walk, its
    #: output the walk's ``enc`` (the audio encoder-decoder's encoder),
    #: or None
    encoder: Optional[_Stack] = None
    #: (views, cfg) -> views: the stacks' per-layer params as the walk
    #: reads them, where a step reads leaves of several stacks (Zamba2's
    #: hybrid layers); None: each stack's own (``_views``)
    join: Optional[Callable] = None
    #: the walk's ``enc`` is the token embedding (Zamba2's shared
    #: blocks read it)
    embedding_in: bool = False


def _in_turn(stacks: List[_Stack], encoder: Optional[_Stack] = None
             ) -> _Family:
    """Every layer of each stack on the walk, the stacks one after the
    other."""
    return _Family(stacks, [(si, layer, layer)
                            for si, st in enumerate(stacks)
                            for layer in range(st.n)], encoder)


def _dense_family(cfg: ModelConfig) -> _Family:
    return _in_turn([_Stack("blocks/", cfg.n_layers, _dense_block_specs,
                            _dense_block_fwd, _dense_block_decode, "kv/",
                            _attn_state)])


def _moe_family(cfg: ModelConfig) -> _Family:
    nd = cfg.first_dense_layers
    return _in_turn([
        _Stack("dense_blocks/", nd, _dense_block_specs, _dense_block_fwd,
               _dense_block_decode, "kv_dense/", _attn_state),
        _Stack("moe_blocks/", cfg.n_layers - nd, _moe_block_specs,
               _moe_block_fwd, _moe_block_decode, "kv_moe/", _attn_state)])


def _ssm_family(cfg: ModelConfig) -> _Family:
    return _in_turn([_Stack("blocks/", cfg.n_layers, _rwkv_block_specs,
                            _rwkv_block_fwd, _rwkv_block_decode, "blocks/",
                            _rwkv_state)])


def _zamba_segments(cfg: ModelConfig):
    """[(n_mamba_layers, attn_after), ...] covering ``cfg.n_layers``: runs
    of ``attn_every`` layers, the shared block after each whole run."""
    segs, rest = [], cfg.n_layers
    while rest > 0:
        n = min(cfg.attn_every, rest)
        segs.append((n, n == cfg.attn_every))
        rest -= n
    return segs


def _hybrid_family(cfg: ModelConfig) -> _Family:
    """Mamba-2 layers with ONE shared attention block after every
    ``attn_every`` of them; each use of the block has its own cache
    (``shared_kv``), and its gradient is the sum over the uses."""
    stacks = [_Stack("blocks/", cfg.n_layers, _mamba_block_specs,
                     _mamba_block_fwd, _mamba_block_decode, "blocks/",
                     _mamba_state),
              _Stack("shared_attn/", None, _dense_block_specs,
                     _dense_block_fwd, _dense_block_decode, "shared_kv/",
                     _attn_state)]
    walk, off, uses = [], 0, 0
    for n, attn_after in _zamba_segments(cfg):
        walk += [(0, layer, layer) for layer in range(off, off + n)]
        if attn_after:
            walk.append((1, 0, uses))
            uses += 1
        off += n
    return _Family(stacks, walk)


def _zamba2_blocks(cfg: ModelConfig) -> int:
    """The shared blocks some hybrid layer uses: use j runs block ``j %
    num_mem_blocks``, so only the first ``min(num_mem_blocks, uses)``
    are held (a block no layer used would only get a zero gradient)."""
    return min(cfg.num_mem_blocks, len(cfg.hybrid_layer_ids))


def _zamba2_join(views: List[List[Params]], cfg: ModelConfig):
    """Each hybrid step's params: its use's leaves, its shared block's
    under ``shared/``, its Mamba-2 layer's under ``mamba/``."""
    mamba, uses, shared = views
    k = cfg.num_mem_blocks

    def under(prefix, p):
        return {prefix + name: v for name, v in p.items()}

    hybrid = [{**uses[j], **under("shared/", shared[j % k]),
               **under("mamba/", mamba[i])}
              for j, i in enumerate(cfg.hybrid_layer_ids)]
    return [mamba, hybrid, shared]


def _zamba2_family(cfg: ModelConfig) -> _Family:
    """Zamba2: every layer a Mamba-2 layer (``blocks``); at the hybrid
    layers the ``hybrid_blocks`` step (``_zamba2_hybrid_fwd``) runs the
    shared block and that layer's Mamba-2 layer, each use with its own
    decode state (its attention cache and the layer's Mamba-2 state).
    The shared blocks' gradients are the sums over their uses."""
    ids = list(cfg.hybrid_layer_ids)
    stacks = [_Stack("blocks/", cfg.n_layers, _mamba_block_specs,
                     _mamba_block_fwd, _mamba_block_decode, "blocks/",
                     _mamba_state),
              _Stack("hybrid_blocks/", len(ids), _zamba2_use_specs,
                     _zamba2_hybrid_fwd, _zamba2_hybrid_decode,
                     "hybrid_blocks/", _zamba2_hybrid_state),
              # read only through the hybrid steps' views
              _Stack("shared_blocks/", _zamba2_blocks(cfg),
                     _zamba2_shared_specs, None, None, "shared_blocks/")]
    walk, plain = [], 0
    for layer in range(cfg.n_layers):
        if layer in ids:
            walk.append((1, ids.index(layer), ids.index(layer)))
        else:
            walk.append((0, layer, plain))
            plain += 1
    return _Family(stacks, walk, join=_zamba2_join, embedding_in=True)


def _audio_family(cfg: ModelConfig) -> _Family:
    """The decoder's blocks over the tokens, the encoder (bidirectional
    dense blocks) over the frames before them."""
    return _in_turn(
        [_Stack("blocks/", cfg.n_layers, _xattn_block_specs,
                _xattn_block_fwd, _xattn_block_decode, "", _xattn_state)],
        encoder=_Stack("enc_blocks/", cfg.n_enc_layers, _dense_block_specs,
                       _encoder_block_fwd))


_FAMILIES = {
    "dense": _dense_family,
    "vlm": _dense_family,     # dense blocks behind a vision prefix
    "moe": _moe_family,
    "ssm": _ssm_family,
    "hybrid": _hybrid_family,
    "audio": _audio_family,
    "zamba2": _zamba2_family,
}


def _family(cfg: ModelConfig) -> _Family:
    if cfg.arch_type not in _FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")
    return _FAMILIES[cfg.arch_type](cfg)


def _layers(tree: Params, prefix: str, n: int) -> List[Params]:
    """Per-layer views of the ``prefix`` leaves of a stacked tree, the
    prefix dropped from their names."""
    stacked = {k[len(prefix):]: v.unbind(0)
               for k, v in tree.items() if k.startswith(prefix)}
    return [{k: v[layer] for k, v in stacked.items()} for layer in range(n)]


def _views(params: Params, st: _Stack) -> List[Params]:
    """The params of each of a stack's layers (one for a block not
    stacked)."""
    if st.n is None:
        return [_sub(params, st.prefix)]
    return _layers(params, st.prefix, st.n)


def _all_views(params: Params, fam: _Family, cfg: ModelConfig
               ) -> List[List[Params]]:
    """The params of each walk step, by stack and layer."""
    views = [_views(params, st) for st in fam.stacks]
    return views if fam.join is None else fam.join(views, cfg)


def _entries(fam: _Family, si: int) -> int:
    """How many decode state entries stack ``si`` has: one a step of the
    walk."""
    return sum(1 for s, _, _ in fam.walk if s == si)


def _embed_inputs(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings, behind the vision prefix (B, P, D) for the
    ``vision_prefix`` modality."""
    x = L.embed(params["embed/table"], batch["tokens"])
    if cfg.modality == "vision_prefix":
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    return x


def _encode(params: Params, fam: _Family, cfg: ModelConfig, batch):
    """The output of the family's encoder over the batch's ``frames``
    (B, S_src, D), or None for a family without one."""
    if fam.encoder is None:
        return None
    enc = batch["frames"].to(getattr(torch, cfg.dtype))
    for p in _views(params, fam.encoder):
        enc, _ = fam.encoder.fwd(p, enc, cfg)
    return enc


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
    index (its step on the walk).  ``wires=None`` is the unwired path."""
    act_wire = wires.get("act") if wires is not None else None
    moe_wire = wires.get("moe") if wires is not None else None
    fam = _family(cfg)
    x = _embed_inputs(params, cfg, batch)
    enc = x if fam.embedding_in else _encode(params, fam, cfg, batch)
    views = _all_views(params, fam, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    e, prev = None, None
    for li, (si, layer, _) in enumerate(fam.walk):
        if act_wire is not None and si != prev:
            # the act wire's EF shift starts at zero in each stack, as the
            # reference's scan over the stack does
            e = torch.zeros_like(x)
        prev = si
        moe = None if moe_wire is None else (
            moe_wire, lambda g, part, li=li: wire_noise.moe(li, g, part))
        x, a = fam.stacks[si].fwd(views[si][layer], x, cfg, moe=moe, enc=enc)
        if a is not None:
            aux = aux + a
        if act_wire is not None:
            x, e = L.wire_boundary(act_wire, wire_noise.act(li), x, e)
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
                      device, enc_len: int = 0) -> Params:
    """Zero decode state for ``b`` rows on ``device``, its leaves stacked
    over each stack's entries, in the reference's flatten order:
    ``kv/{k,kpos,v}`` (a ring cache of ``cache_len`` slots a row) for the
    dense family and the VLM, ``kv_dense/...`` and ``kv_moe/...`` for the
    MoE family (a stack of no layers keeps leaves of no layers, as the
    reference's; ``{ckv,kpos,kr}`` with MLA),
    ``blocks/{cm_last,tm_last,wkv}`` for RWKV-6, ``blocks/{conv,ssm}`` and
    ``shared_kv/...`` (one entry a use of the shared block) for the
    hybrid, ``blocks/{conv,ssm}`` (the plain Mamba-2 layers) and
    ``hybrid_blocks/{conv,kv/...,ssm}`` (one entry a hybrid layer) for
    Zamba2, ``kv/...`` and ``xkv/{k,v}`` ((L, B, ``enc_len``, KV, Dh)
    zeros: the encoder's keys and values) for the audio
    encoder-decoder."""
    fam = _family(cfg)
    dtype = getattr(torch, cfg.dtype)
    state = {}
    for si, st in enumerate(fam.stacks):
        if st.state is None:        # a stack no step of the walk decodes
            continue
        n = _entries(fam, si)
        one = st.state(cfg, b, cache_len, enc_len, dtype, device)
        state.update({st.state_prefix + k: v[None].repeat((n,) + (1,) * v.dim())
                      for k, v in one.items()})
    return dict(sorted(state.items(), key=lambda kv: kv[0].split("/")))


def decode_step(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                state: Params, pos: int):
    """One token for the whole batch: ``tok`` (B, 1) int, ``pos`` the
    absolute position written (a host int).  Updates ``state`` in place;
    returns ``(logits (B, 1, V), state)``."""
    fam = _family(cfg)
    views = _all_views(params, fam, cfg)
    entries = [_layers(state, st.state_prefix, _entries(fam, si))
               for si, st in enumerate(fam.stacks)]
    x = L.embed(params["embed/table"], tok)
    kw = {"enc": x} if fam.embedding_in else {}
    for si, layer, entry in fam.walk:
        x = fam.stacks[si].decode(views[si][layer], x, cfg,
                                  entries[si][entry], pos, **kw)
    x = L.rmsnorm(params["final_norm/scale"], x, cfg.norm_eps)
    return L.lm_head(params, x, cfg), state
