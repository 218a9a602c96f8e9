"""The model FLOPs of one training step, from a configuration's shapes:
6 x the matrix parameters on a token's path x the step's tokens (a
forward product 2, its backward 4), plus causal attention's two
products (scores and values) over the S (S + 1) / 2 pairs of each
sequence, three times (forward, and the backward's two).

On a token's path: every weight matrix of every layer, the head (the
tied embedding where it is tied; an embedding lookup is no product).
A family's ``step_flops`` (``reference/<model_type>.py``) says what else
a token runs through, such as k of n routed experts.  Not counted:
norms, rotary positions, softmax, the loss, recomputation, capacity
padding and the one-hot dispatch and combine products of routed layers.
"""

from __future__ import annotations

import math


def matrix_params(specs, tied: bool, on_path=lambda path, n: n) -> float:
    """Matrix parameters a token runs through, of ``(path, shape, init)``
    leaves (a leaf under ``*blocks/`` stacked over its layers);
    ``on_path(path, n)`` gives how many of a leaf's ``n`` it runs
    through."""
    total = 0.0
    for path, shape, _ in specs:
        if path == "embed/table":
            total += math.prod(shape) if tied else 0
            continue
        stacked = path.split("/")[0].endswith("blocks")
        per = shape[1:] if stacked else shape
        if len(per) < 2:
            continue                     # norm scales
        total += on_path(path, math.prod(shape))
    return total


def attention_flops(batch: int, seq: int, heads: int, qk: int, v: int,
                    layers: int) -> float:
    """Causal attention's scores and values, forward and backward, over
    ``layers`` layers of ``heads`` heads of query/key width ``qk`` and
    value width ``v``."""
    pairs = seq * (seq + 1) / 2
    return 3 * 2 * batch * heads * pairs * (qk + v) * layers


def step_flops(matrix: float, attention: float, batch: int, seq: int) -> float:
    """Model FLOPs of one step over ``batch`` sequences of ``seq``."""
    return 6 * matrix * batch * seq + attention
