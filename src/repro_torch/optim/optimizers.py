"""AdamW and SGD with a cosine schedule, written out as the reference's
``repro/optim/optimizers.py`` writes them -- not ``torch.optim.AdamW``,
which rounds differently.  As in the reference: every leaf is decayed
(norm scales included), eps sits outside ``sqrt(v / bc2)``, moments are
f32, and the schedule is evaluated in f32.

The update is IN PLACE on the params and the moments (the reference
returns new trees): at full size a second copy of params, m and v would
cost 7 GB more for nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Union

import torch

from repro_torch.kernels.q8ring.ref import fma_f32

Tree = Dict[str, torch.Tensor]


@dataclass
class OptState:
    step: int
    m: Tree          # first moment, f32
    v: Tree          # second moment, f32


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    """Linear warmup then cosine decay to ``final_frac * base_lr``;
    returns an f32 0-d CPU tensor, computed op by op as the reference."""
    def lr(step: int) -> torch.Tensor:
        s = _f32(step)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, base_lr * cos)
    return lr


@dataclass(frozen=True)
class adamw:
    lr: Union[Callable, float] = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Tree) -> OptState:
        return OptState(
            0,
            {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()},
            {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()},
        )

    def update(self, grads: Tree, state: OptState, params: Tree):
        """Returns ``(params, state)``, both updated in place."""
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else _f32(self.lr)
        b1, b2 = self.beta1, self.beta2
        bc1 = 1 - b1 ** _f32(step)
        bc2 = 1 - b2 ** _f32(step)
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = state.m[k].mul_(b1).add_(g, alpha=1 - b1)
            v = state.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            dev = p.device
            mhat = m / bc1.to(dev)
            vhat = v / bc2.to(dev)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            delta += self.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr.to(dev) * delta)
        state.step = step
        return params, state


@dataclass(frozen=True)
class sgd:
    """Plain SGD, with heavy-ball momentum when ``momentum > 0``: ``m =
    momentum * m + g`` (else ``m = g``), ``p -= lr * m``.  ``m`` is f32;
    ``v`` holds a 0-d zero a leaf, as the reference's state does.  Both
    products are fmas (``fma_f32``), as XLA contracts the reference's."""

    lr: Union[Callable, float] = 1e-2
    momentum: float = 0.0

    def init(self, params: Tree) -> OptState:
        return OptState(
            0,
            {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()},
            {k: torch.zeros((), dtype=torch.float32, device=p.device)
             for k, p in params.items()},
        )

    def update(self, grads: Tree, state: OptState, params: Tree):
        """Returns ``(params, state)``, both updated in place."""
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else _f32(self.lr)
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            if self.momentum > 0:
                m = state.m[k].copy_(fma_f32(state.m[k], _f32(
                    self.momentum).to(p.device), g))
            else:
                m = state.m[k].copy_(g)
            p.copy_(fma_f32(m, -lr.to(p.device), p.to(torch.float32)))
        state.step = step
        return params, state


def make_optimizer(train_cfg) -> Union[adamw, sgd]:
    """``adamw`` or ``sgd`` (no momentum, as the reference builds it),
    both on the cosine schedule."""
    lr = cosine_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                         train_cfg.total_steps)
    if train_cfg.optimizer == "adamw":
        return adamw(lr=lr, beta1=train_cfg.beta1, beta2=train_cfg.beta2,
                     eps=train_cfg.eps, weight_decay=train_cfg.weight_decay)
    if train_cfg.optimizer == "sgd":
        return sgd(lr=lr)
    raise ValueError(train_cfg.optimizer)
