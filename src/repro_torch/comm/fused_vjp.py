"""Fused backward-pass encode: wire messages AS gradients -- the port of
the reference's ``repro/comm/fused_vjp.py``.

The post-hoc round first writes every worker's dense gradient tree,
then encodes it (``ShiftRule.message``).  Here each param leaf is
wrapped, before the model uses it, in ``message_tag``: an identity whose
backward replaces the leaf's cotangent ``g`` by worker j's decoded
message ``Q(g - h_j)`` (``ShiftRule.message_leaf_worker``).  The
gradient of the tagged loss IS then the message tree, encoded leaf by
leaf as backprop reaches each leaf, and the round is its reduce/apply
tail (``Channel.fused_round``).

Bitwise equal to the post-hoc round, because:

* DRAWS -- ``round_message_draws`` binds each leaf's draws to its global
  tree position and each worker's to its row (``ShiftRule.message_draws``),
  so the round's order-free noise source (``comm.wire.AddressedNoise``)
  hands worker j the uniforms the post-hoc encode gives row j;
* VALUES -- ``message_leaf_worker`` is row j of ``message_leaf``, bit for
  bit, and the cotangent the tag sees is worker j's gradient of the leaf:
  the tag wraps the leaf once, so the cotangents of every use of a tied
  leaf (qwen3's embedding: ``embed`` and ``lm_head``) are summed before
  its backward runs, as they are for the post-hoc gradient;
* BITS -- the round adds each leaf's structural ``message_bits_aot`` in
  the post-hoc round's order.

Only rules whose ``apply`` reads the messages and never the dense
gradients are fusible (``ShiftRule.fusible``): fixed/dcgd, diana, ef21,
efbv.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.comm.wire import LeafNoise

Tree = Dict[str, torch.Tensor]


def check_fusible(rule) -> None:
    """Reject rules whose round cannot run on the fused-backward path."""
    if not getattr(rule, "fusible", False):
        raise ValueError(
            f"shift rule {type(rule).__name__} is not fusible: its round "
            "consumes the dense per-worker gradients (or overrides the "
            "round schedule), which never materialize when messages are "
            "emitted as cotangents.  Fusible rules: fixed/dcgd, diana, "
            "ef21, efbv."
        )


class _MessageTag(torch.autograd.Function):
    """Identity forward; the backward maps the cotangent to the message."""

    @staticmethod
    def forward(ctx, x, encode):
        ctx.encode = encode
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.encode(g.contiguous()), None


def message_tag(rule, q, x: torch.Tensor, draw, h: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """``x`` (one param leaf) unchanged, whose gradient is worker j's
    decoded message ``rule.message_leaf_worker(q, draw, g, h)`` of the
    cotangent ``g``: ``draw`` is worker j's entry of the leaf's
    ``message_draws``, ``h`` its shift of the leaf (None for stateless
    rules)."""
    return _MessageTag.apply(
        x, lambda g: rule.message_leaf_worker(q, draw, g, h))


def round_message_draws(rule, q, noise, params_like: Tree, w: int) -> tuple:
    """The round's message draws, one entry per leaf in the tree's order:
    ``rule.message_draws`` of the leaf bound to its global position, a
    list of ``w`` per-worker draws (what ``rule.message`` hands row j)."""
    return tuple(rule.message_draws(q, LeafNoise(noise, i), w)
                 for i in range(len(params_like)))


def encode_on_backward(rule, q, params: Tree, draws: Sequence,
                       h: Optional[Tree]) -> Tree:
    """Every param leaf wrapped in ``message_tag``: ``draws`` is one
    worker's draw per leaf (entry j of each ``round_message_draws``
    entry), ``h`` that worker's shift tree (None for stateless rules).
    The gradient of a loss on the result is the worker's MESSAGE tree."""
    check_fusible(rule)
    if len(draws) != len(params):
        raise ValueError(
            f"round_message_draws carries {len(draws)} leaf draws but "
            f"params has {len(params)} leaves -- draws must be derived "
            "from the same tree"
        )
    return {k: message_tag(rule, q, x, d, None if h is None else h[k])
            for (k, x), d in zip(params.items(), draws)}


def fused_message_bits(rule, q, wgrads_like: Tree) -> float:
    """Total structural uplink bits of one fused round's messages -- the
    sum the fused rounds accumulate leaf by leaf (Python float)."""
    return float(sum(rule.message_bits_aot(q, leaf)
                     for leaf in wgrads_like.values()))
