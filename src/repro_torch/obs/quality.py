"""Measured distortion probes: the paper's quantities on real traffic --
the port of the reference's ``repro/obs/quality.py``.

The whole argument of shifted compression is a *measurable* claim —
``E||Q(v) - v||^2 <= omega ||v||^2`` for the unbiased class U(omega),
and the shifted vector ``g - h`` shrinks while the plain gradient does
not.  Here the same quantities are measured over the traffic a wire
actually carries:

* ``omega_hat`` — size-weighted mean of the per-leaf realized variance
  ratio ``||Q(v)-v||^2 / ||v||^2`` (the d-weighted mean the tuner's
  analytic estimate takes, so the two numbers compare directly;
  ``omega_hat <= omega`` must hold in expectation for any honest
  U(omega) codec).
* ``nmse`` — global ``sum err^2 / sum norm^2`` over the whole tree.
  Defined for biased (contractive) codecs too, where no omega exists.

The probes run the codec's real encode path (``comm.wire``: with the
``q8_block`` codec on a CUDA tensor, the ``q8_quantize_2d`` and
``q8_dequant_add_2d`` kernels), their draws taken from a noise source
addressed by the leaf's global position (``LeafNoise``, the port of
``leaf_key``) -- never from trainer state, which is what keeps
``diag=True`` runs bitwise the ``diag=False`` runs.  Comm imports stay
lazy so ``repro_torch.obs`` remains a leaf package.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

__all__ = [
    "array_distortion",
    "tree_distortion",
    "distortion_floats",
]

#: guard for 0/0 — an all-zero probe tree has zero distortion by fiat
_EPS = 1e-30


def _sq(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return torch.sum(x * x)


def array_distortion(codec, noise, data: torch.Tensor, *,
                     topology: str = "allreduce"
                     ) -> Dict[str, torch.Tensor]:
    """Distortion of ONE wire payload through the codec's real path.

    ``noise`` is the leaf's draws (``comm.wire.LeafNoise``).  ``data``
    is worker-stacked ``(W, ...)`` for the allreduce uplink (each row
    rides its own worker's draws, exactly like ``Channel.uplink``); any
    other topology encodes the block whole, with the leaf's one draw,
    the way the forwarded-payload wires (moe / act / model) do.

    Returns f32 scalars ``{"err_sq", "norm_sq"}`` — callers fold them
    into ``omega_hat`` / ``nmse`` (see ``tree_distortion``).
    """
    from repro_torch.comm.wire import encode_decode_workers
    from repro_torch.core.compressors import ShapeDtype

    if topology == "allreduce":
        _, decoded = encode_decode_workers(codec, noise, data)
    else:
        payload, meta = codec.encode(noise.worker(None), data)
        decoded = codec.decode(payload, meta, ShapeDtype.of(data))
    err_sq = _sq(decoded.to(torch.float32) - data.to(torch.float32))
    return {"err_sq": err_sq, "norm_sq": _sq(data)}


def tree_distortion(codec, noise, wtree, *,
                    topology: str = "allreduce") -> Dict[str, torch.Tensor]:
    """Measured ``omega_hat`` / ``nmse`` over a worker-stacked tree
    (``{path: tensor}``).

    Leaf ``i``'s draws are ``LeafNoise(noise, i)`` over the global leaf
    position — the derivation every wire consumer shares — so the probe
    sees the draws a real round at that noise would.

    Returns f32 scalars:

    * ``omega_hat`` — sum_i d_i * (err_i / norm_i) / sum_i d_i with
      d_i the per-worker leaf size (empty-norm leaves contribute 0);
    * ``nmse``      — sum_i err_i / sum_i norm_i;
    * ``err_sq`` / ``norm_sq`` — the raw global sums.
    """
    from repro_torch.comm.wire import LeafNoise

    leaves = list(wtree.values())
    if not leaves:
        raise ValueError("tree_distortion of an empty tree")
    dev = leaves[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ratio_acc, err_acc, norm_acc = zero, zero, zero
    d_total = 0
    for i, leaf in enumerate(leaves):
        shape = leaf.shape[1:] if topology == "allreduce" else leaf.shape
        d = int(math.prod(shape)) if len(shape) else 1
        out = array_distortion(codec, LeafNoise(noise, i), leaf,
                               topology=topology)
        ratio = torch.where(
            out["norm_sq"] > 0.0,
            out["err_sq"] / torch.clamp(out["norm_sq"], min=_EPS), zero)
        ratio_acc = ratio_acc + d * ratio
        err_acc = err_acc + out["err_sq"]
        norm_acc = norm_acc + out["norm_sq"]
        d_total += d
    omega_hat = ratio_acc / d_total
    nmse = torch.where(norm_acc > 0.0,
                       err_acc / torch.clamp(norm_acc, min=_EPS), zero)
    return {"omega_hat": omega_hat, "nmse": nmse,
            "err_sq": err_acc, "norm_sq": norm_acc}


def distortion_floats(out: Dict[str, Any]) -> Dict[str, float]:
    """Host-side view of a distortion dict (floats, obs-record ready)."""
    return {k: float(v) for k, v in out.items()}
