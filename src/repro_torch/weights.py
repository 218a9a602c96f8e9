"""Carry the reference's state into the port.

``params_from_jax`` turns the reference's params pytree -- nested dicts
of numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)`` --
into the port's flat ``{path: tensor}`` dict, in the reference's leaf
order; the port's names are the reference's paths at any depth (the MoE
family's ``moe_blocks/moe/shared/w_gate``), and a stack of no layers
(the reference's ``None``) has no leaves.  ``state_from_jax`` does the same for the other ``TrainState``
parts (AdamW moments, shifts) so both sides can start from one state,
and ``decode_state_from_jax`` for a decode state (caches, RWKV-6
states).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.comm.wire import GeneratorNoise
from repro_torch.core.compressors import f32_bits
from repro_torch.launch.train import TrainState
from repro_torch.optim.optimizers import OptState


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> ``{"a/b/c": leaf}`` in ``jax.tree_util`` order
    (sorted keys at every level; empty dicts have no leaves)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path + "/"))
        elif v is not None:
            out[path] = v
    return out


def params_from_jax(tree: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's params pytree (numpy leaves) as the port's params."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in flatten_tree(tree).items()}


def decode_state_from_jax(tree: Mapping, device="cpu"
                          ) -> Dict[str, torch.Tensor]:
    """The reference's decode state (``make_decode_state``'s nested dict,
    numpy leaves) as the port's flat ``{"kv/k": ..., "kv/kpos": ...}``."""
    return params_from_jax(tree, device)


def state_from_jax(params: Mapping, m: Mapping, v: Mapping, opt_step: int,
                   h: Optional[Mapping], h_bar: Optional[Mapping],
                   step: int = 0, bits: float = 0.0, noise=None,
                   device="cpu", seed: int = 0) -> TrainState:
    """A port ``TrainState`` from the reference's state parts (numpy
    leaves): params, AdamW ``m``/``v`` and step, shifts ``h``/``h_bar``.
    ``noise`` defaults to a ``GeneratorNoise`` seeded from ``seed``."""
    def conv(t):
        return None if t is None else params_from_jax(t, device)

    return TrainState(
        params=conv(params),
        opt=OptState(int(opt_step), conv(m), conv(v)),
        h=conv(h),
        h_bar=conv(h_bar),
        noise=noise if noise is not None else GeneratorNoise(seed, device),
        step=int(step),
        bits=f32_bits(float(np.float32(bits))),
    )
