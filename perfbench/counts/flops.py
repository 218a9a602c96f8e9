"""The model FLOPs of one training step, from a configuration's shapes:
6 x the matrix parameters on a token's path x the step's tokens (a
forward product 2, its backward 4), plus causal attention's two
products (scores and values) over the S (S + 1) / 2 pairs of each
sequence, three times (forward, and the backward's two).

On a token's path: every weight matrix of every layer, the routed
experts counted at top-k of n (a token runs through k of them), the
router; the head (the tied embedding where it is tied; an embedding
lookup is no product).  Not counted: norms, rotary positions, softmax,
the loss, recomputation, capacity padding and the one-hot dispatch and
combine products of the MoE layers.
"""

from __future__ import annotations

import math

from perfbench.reference import model as RM


def matrix_params(m: RM.Model) -> float:
    """Matrix parameters a token runs through."""
    total = 0.0
    for path, shape, _ in RM.param_specs(m):
        if path == "embed/table":
            total += math.prod(shape) if m.tied else 0
            continue
        stacked = path.split("/")[0].endswith("blocks")
        per = shape[1:] if stacked else shape
        if len(per) < 2:
            continue                     # norm scales
        n = math.prod(shape)
        name = path.split("/")
        if "moe" in name and "shared" not in name and "router" not in name:
            n = n * m.top_k / m.experts  # routed experts: k of n
        total += n
    return total


def attention_flops(m: RM.Model, batch: int, seq: int) -> float:
    if m.family == "moe":
        qk, v = m.nope + m.rope, m.v_dim
    else:
        qk = v = m.head_dim
    pairs = seq * (seq + 1) / 2
    return 3 * 2 * batch * m.heads * pairs * (qk + v) * m.n_layers


def step_flops(m: RM.Model, batch: int, seq: int) -> float:
    """Model FLOPs of one step over ``batch`` sequences of ``seq``."""
    return 6 * matrix_params(m) * batch * seq + attention_flops(m, batch, seq)
