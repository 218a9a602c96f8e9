"""Mixture-of-Experts FFN -- the port of the reference's
``repro/models/moe.py``: GShard-style capacity routing with dense
dispatch and combine, shared and routed experts (DeepSeek-V2 /
Qwen-MoE style).

The routed experts live in stacked ``(E, d, f)`` tensors (``w_gate``,
``w_up``, ``w_down``), the router is ``(d, E)`` in f32, the shared
experts one fused SwiGLU of width ``moe_d_ff * n_shared_experts``.
Params are a dict keyed by the reference's names relative to the
``moe`` subtree (``"router"``, ``"w_gate"``, ``"shared/w_up"``, ...).
Dispatch is the dense one-hot form: (tokens, experts, capacity)
dispatch and combine tensors, applied as matrix products, as the
reference's einsums are (it has no kernel here, so neither has the
port: ``torch.matmul`` / ``torch.bmm``).

Routing is in f32: softmax over the router logits, top-k (ties to the
lower expert index, as ``jax.lax.top_k``: a stable descending sort),
the selected gates normalised, queue positions in slot-major order
(every token's first choice wins capacity before any second choice),
tokens past an expert's capacity dropped, and the load-balance
auxiliary loss ``E * sum_e(mean_prob_e * frac_routed_e) * coef``.

Tokens run in GShard groups of ``moe_group_size``: zero-padded to a
whole number of groups (the padded rows are routed and take capacity,
as in the reference), the groups one after another, ``aux`` the mean
over the groups, the shared experts added after them.

With a ``wire`` (``comm.transport.Wire``, the ``moe`` wire) the two
expert buffers that cross the all-to-all, the dispatched ``xe`` and the
expert outputs ``ye``, ride the wire's codec, straight-through on the
backward pass, with the error-feedback shift pair threaded across the
groups; ``draw(group, part)`` gives the send's draws (``part``
``"dispatch"`` or ``"combine"``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]


class F32Normal(float):
    """A normal init std for a leaf kept in f32 whatever the model's
    dtype (the router)."""


def moe_specs(cfg: ModelConfig):
    """(relative path, shape, init) of one MoE FFN, the reference's
    ``init_moe``: a normal std, or ``F32Normal`` for the f32 router."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    sc = 0.02
    down_sc = sc / math.sqrt(2 * cfg.n_layers)
    specs = [("router", (d, e), F32Normal(sc)),
             ("w_gate", (e, d, f), sc),
             ("w_up", (e, d, f), sc),
             ("w_down", (e, f, d), down_sc)]
    if cfg.n_shared_experts > 0:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        specs += [("shared/w_gate", (d, fs), sc),
                  ("shared/w_up", (d, fs), sc),
                  ("shared/w_down", (fs, d), down_sc)]
    return specs


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(
        cfg.capacity_factor * n_tokens * cfg.experts_per_token
        / cfg.n_experts))
    # a multiple of 8, as the reference rounds it
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties to the lower index (a stable descending
    sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Top-k softmax routing with capacity over flat tokens ``x`` (N, D).
    Returns ``(dispatch (N, E, C) 0/1, combine (N, E, C) gates, aux)``,
    all f32."""
    n = x.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    c = _capacity(n, cfg)

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                           # (N, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # one-hot expert of each routing slot, slot-major: (k, N, E)
    sel = F.one_hot(gate_idx.T, e).to(torch.float32)
    flat_sel = sel.reshape(k * n, e)
    pos_in_expert = torch.cumsum(flat_sel, dim=0) * flat_sel - 1.0
    within_cap = (pos_in_expert < c) & (flat_sel > 0)
    pos = torch.sum(pos_in_expert * within_cap, dim=-1)              # (kN,)
    kept = within_cap.any(dim=-1)                                    # (kN,)

    gates_flat = gate_vals.T.reshape(k * n) * kept
    onehot_c = F.one_hot(pos.to(torch.int64).clamp_min(0), c).to(
        torch.float32) * kept[:, None]
    disp_flat = flat_sel[:, :, None] * onehot_c[:, None, :]        # (kN, E, C)
    comb_flat = disp_flat * gates_flat[:, None, None]
    dispatch = disp_flat.reshape(k, n, e, c).sum(0)
    combine = comb_flat.reshape(k, n, e, c).sum(0)

    me = probs.mean(dim=0)                                          # (E,)
    ce = sel.sum(0).mean(dim=0)                                     # (E,)
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    return dispatch, combine, aux


def _moe_group(p: Params, xf: torch.Tensor, cfg: ModelConfig, wire=None,
               draw: Optional[Callable] = None, shift=None):
    """Route, dispatch, the expert FFN and combine for one token group
    ``xf`` (G, D).  With a ``wire``, ``xe`` and ``ye`` ride it (the
    draws of ``draw("dispatch")`` and ``draw("combine")``) and ``shift``
    is the EF pair ``(e_dispatch, e_combine)``.  Returns ``(y, aux,
    shift)``."""
    dispatch, combine, aux = route(p, xf, cfg)
    n, e, c = dispatch.shape
    d = xf.shape[1]

    # (E, C, D) expert buffers: the einsum "nec,nd->ecd"
    xe = (dispatch.to(xf.dtype).reshape(n, e * c).T @ xf).reshape(e, c, d)
    if wire is not None:
        e_disp, e_comb = shift
        xe, e_disp = wire.send(draw("dispatch"), xe, e_disp)

    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])
    if wire is not None:
        ye, e_comb = wire.send(draw("combine"), ye, e_comb)
        shift = (e_disp, e_comb)

    # "nec,ecd->nd"
    y = combine.to(xf.dtype).reshape(n, e * c) @ ye.reshape(e * c, d)
    return y, aux, shift


def _wire_shift_zero(cfg: ModelConfig, g: int, d: int, dtype, device):
    """Zero EF shift pair for one group's (E, C, D) expert buffers."""
    z = torch.zeros((cfg.n_experts, _capacity(g, cfg), d), dtype=dtype,
                    device=device)
    return (z, z)


def moe_wire_traffic(cfg: ModelConfig, n_tokens: int):
    """Declared per-worker ``moe``-wire traffic of ONE MoE layer,
    ``((ShapeDtype on meta, count), ...)``: two sends (dispatch and
    combine) of the (E, C, D) expert buffer per group, with
    ``moe_apply``'s group and capacity arithmetic."""
    from repro_torch.core.compressors import ShapeDtype

    if n_tokens <= 0:
        return ()
    g = min(cfg.moe_group_size, n_tokens)
    n_groups = (n_tokens + ((-n_tokens) % g)) // g
    like = ShapeDtype((cfg.n_experts, _capacity(g, cfg), cfg.d_model),
                      getattr(torch, cfg.dtype),
                      torch.device("meta"))
    return ((like, 2 * n_groups),)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, wire=None,
              draw: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> ``(out (B, S, D), aux)``, in groups of
    ``cfg.moe_group_size`` tokens.  ``draw(group, part)``: the moe
    wire's draws of a send (with ``wire``); the EF shift starts at zero
    and is threaded across the groups."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    n = xf.shape[0]
    g = min(cfg.moe_group_size, n)
    pad = (-n) % g
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    n_groups = (n + pad) // g

    shift = None
    if wire is not None:
        shift = _wire_shift_zero(cfg, g, d, xf.dtype, xf.device)
    ys, auxs = [], []
    for gi in range(n_groups):
        gdraw = None if wire is None else (
            lambda part, gi=gi: draw(gi, part))
        y_g, aux_g, shift = _moe_group(p, xf[gi * g:(gi + 1) * g], cfg,
                                       wire=wire, draw=gdraw, shift=shift)
        ys.append(y_g)
        auxs.append(aux_g)
    y = ys[0] if n_groups == 1 else torch.cat(ys)
    aux = auxs[0] if n_groups == 1 else torch.stack(auxs).mean()

    y = y[:n]
    xf = xf[:n]
    if cfg.n_shared_experts > 0:
        hs = F.silu(xf @ p["shared/w_gate"]) * (xf @ p["shared/w_up"])
        y = y + hs @ p["shared/w_down"]
    return y.reshape(b, s, d), aux
