"""DCGD-SHIFT -- the paper's Algorithm 1 over stacked per-worker
gradients (leaves ``(W, *param.shape)``), the port of the reference's
``repro/core/algorithms.py``; and the theoretical step sizes of
Theorems 1-4 and of EF21/EF-BV, plain Python floats computed as the
reference computes them.

The reference carries a PRNG key in its state and splits it each round;
the port carries the round's noise source (``comm.wire``), which the
rule's round draws from in the reference's order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm.channel import Channel
from repro_torch.comm.wire import GeneratorNoise
from repro_torch.core.compressors import Compressor, Identity
from repro_torch.core.shift_rules import FixedShift, ShiftRule


class DCGDState(NamedTuple):
    h: Any              # shift state (rule-specific tree, worker-stacked)
    h_bar: Any          # master aggregated shift (no worker axis; None
                        # for stateless and oracle rules)
    noise: Any          # the rounds' noise source (comm.wire)
    step: int           # iteration counter
    bits: torch.Tensor  # cumulative uplink bits (f32 0-d, on the device)


@dataclass(frozen=True)
class DCGDShift:
    """Distributed Compressed Gradient Descent with Shift (Alg. 1).

    ``q``       -- per-worker compressor Q_i
    ``rule``    -- the shift update mechanism (``core.shift_rules``)
    ``channel`` -- the message transport; ``None`` is the parameter
                   server ``SimChannel`` (the paper's setting)
    """

    q: Compressor = field(default_factory=Identity)
    rule: ShiftRule = field(default_factory=FixedShift)
    channel: Optional[Channel] = None

    def init(self, wgrads_like, *, seed: int = 0, star: Any = None,
             noise: Any = None) -> DCGDState:
        """State for W-stacked gradients like ``wgrads_like`` (a tree);
        ``star``: the gradients at the optimum (DCGD-STAR).  ``noise``
        defaults to a ``GeneratorNoise`` seeded with ``seed`` on the
        gradients' device."""
        first = next(iter(wgrads_like.values()))
        if star is not None:
            h = self.rule.init_with_star(star)  # type: ignore[attr-defined]
            h_bar = None
        else:
            params = {k: a[0] for k, a in wgrads_like.items()}
            h = self.rule.init(params, first.shape[0])
            h_bar = self.rule.init_bar(params)
        if noise is None:
            noise = GeneratorNoise(seed, first.device)
        return DCGDState(h, h_bar, noise, 0,
                         torch.zeros((), dtype=torch.float32,
                                     device=first.device))

    def estimate(self, state: DCGDState, wgrads):
        """One round: compress the shifted worker gradients, aggregate,
        update the shifts.  Returns ``(g_bar, new_state)``; the shifts are
        updated in place where the rule does so."""
        g_bar, h_new, hb_new, bits = self.rule.round(
            self.q, state.noise, wgrads, state.h, state.h_bar,
            channel=self.channel)
        return g_bar, DCGDState(h_new, hb_new, state.noise, state.step + 1,
                                state.bits + bits)


# --------------------------------------------------------------------------
# Theoretical step sizes
# --------------------------------------------------------------------------


def stepsize_dcgd_fixed(L, L_max, omega, n):
    """Theorem 1: gamma <= 1 / (L + 2 max_i(L_i omega_i)/n)."""
    return 1.0 / (L + 2.0 * L_max * omega / n)


def stepsize_dcgd_star(L, L_max, omega, delta, n):
    """Theorem 2: gamma <= 1 / (L + max_i(L_i omega_i (1-delta_i))/n)."""
    return 1.0 / (L + L_max * omega * (1.0 - delta) / n)


def stepsize_diana(L_max, omega, delta, n, M_mult: float = 4.0):
    """Theorem 3 pair (alpha, gamma) with M = M_mult/(n*alpha) > 2/(n*alpha)."""
    om = omega * (1.0 - delta)
    alpha = 1.0 / (1.0 + om)
    M = M_mult / (n * alpha)
    gamma = 1.0 / ((2.0 / n) * omega * L_max + (1.0 + alpha * M) * L_max)
    return alpha, gamma


def stepsize_rand_diana(L_max, omega, n, p, M_mult: float = 2.0):
    """Theorem 4: M = M_mult * 2*omega/(n*p);
    gamma <= 1/((1+2w/n)Lmax + M max_i p_i L_i)."""
    M = M_mult * 2.0 * omega / (n * p) if omega > 0 else 0.0
    gamma = 1.0 / ((1.0 + 2.0 * omega / n) * L_max + M * p * L_max)
    return M, gamma


def rand_diana_default_p(omega: float) -> float:
    """p = 1/(omega+1) -- matches DIANA's iteration complexity."""
    return 1.0 / (omega + 1.0)


def stepsize_ef21(L, L_max, delta):
    """EF21 (Thm 1 of Richtarik, Sokolov & Fatkhullin, 2021) with L_tilde
    bounded by L_max: ``stepsize_efbv`` at eta = nu = 1."""
    return stepsize_efbv(L, L_max, delta=delta)


def _efbv_contraction(eta: float, delta: float, omega) -> float:
    """Per-step contraction r^2 of the EF-BV shift error under
    h <- h + eta * C(e): the best of the contractive certificate
    ((1-eta) + eta sqrt(1-delta))^2 and, for an unbiased C (``omega``
    not None), the exact 1 - 2 eta + eta^2 (1+omega)."""
    r2 = ((1.0 - eta) + eta * math.sqrt(max(1.0 - delta, 0.0))) ** 2
    if omega is not None:
        r2 = min(r2, 1.0 - 2.0 * eta + eta * eta * (1.0 + omega))
    return max(r2, 0.0)


def stepsize_efbv(L, L_max, delta: float = 0.0, omega=None,
                  eta: float = 1.0, nu: float = 1.0):
    """EF-BV step size: with r^2 = ``_efbv_contraction``, theta = 1 - r
    and beta = r^2 / theta, gamma = 1 / (L + nu L_max sqrt(beta/theta));
    0 when no certificate contracts (r >= 1)."""
    r2 = _efbv_contraction(eta, delta, omega)
    theta = 1.0 - math.sqrt(r2)
    if theta <= 0.0:
        return 0.0  # the shift recursion does not contract
    beta = r2 / theta
    return 1.0 / (L + nu * L_max * math.sqrt(beta / theta))


def efbv_params(delta: float = 0.0, omega=None):
    """Recommended EF-BV ``(eta, nu)``: the better contraction of eta = 1
    (contractive certificate) and, for an unbiased C, eta = 1/(1+omega);
    nu = 1."""
    eta_c = 1.0
    best = (_efbv_contraction(eta_c, delta, None), eta_c)
    if omega is not None:
        eta_u = 1.0 / (1.0 + omega)
        best = min(best, (_efbv_contraction(eta_u, delta, omega), eta_u))
    return best[1], 1.0
