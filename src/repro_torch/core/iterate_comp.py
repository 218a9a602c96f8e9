"""Compressed-iterate methods -- Section 3.3 (GDCI) and Appendix B.7
(VR-GDCI), the port of the reference's ``repro/core/iterate_comp.py``.

These compress the *model* (the broadcast direction of federated
learning) rather than the gradient.  Both consume W-stacked per-worker
gradient trees like ``DCGDShift``; the iterate is a tree of the same
keys without the worker axis.  The reference splits a PRNG key per
update; the port draws from the state's noise source (``comm.wire``),
in the reference's order: the uplink's draws, leaf by leaf and worker by
worker, then the aggregation's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm.channel import Channel
from repro_torch.comm.wire import GeneratorNoise
from repro_torch.core.compressors import Compressor, Identity
from repro_torch.core.shift_rules import _chan


def _state_noise(noise, seed, params):
    if noise is not None:
        return noise
    return GeneratorNoise(seed, next(iter(params.values())).device)


def _zero_bits(params):
    return torch.zeros((), dtype=torch.float32,
                       device=next(iter(params.values())).device)


class GDCIState(NamedTuple):
    noise: Any
    step: int
    bits: torch.Tensor


@dataclass(frozen=True)
class GDCI:
    """Distributed Gradient Descent with Compressed Iterates (eq. 13):

        x^{k+1} = (1-eta) x^k + eta * mean_i Q_i(x^k - gamma grad_i(x^k))

    Theorem 5: linear to a neighborhood ~ (2 omega eta / n) mean_i
    ||x* - gamma grad_i(x*)||^2; exact in the interpolation regime.
    """

    q: Compressor = field(default_factory=Identity)
    gamma: float = 0.1
    eta: float = 0.5
    channel: Optional[Channel] = None

    def init(self, params, *, seed: int = 0, noise: Any = None) -> GDCIState:
        return GDCIState(_state_noise(noise, seed, params), 0,
                         _zero_bits(params))

    def update(self, params, state: GDCIState, wgrads):
        ch = _chan(self.channel)
        # local iterate proposal per worker: x - gamma g_i  (broadcast x)
        prop = {k: torch.add(x[None], wgrads[k], alpha=-self.gamma)
                for k, x in params.items()}
        comp, bits = ch.uplink(self.q, state.noise, prop)
        mean = ch.reduce(state.noise, comp)
        # (1 - eta) x + eta mean, rounded as XLA contracts it
        new_params = {k: torch.add(mean[k].scaled(self.eta), x,
                                   alpha=1.0 - self.eta)
                      for k, x in params.items()}
        return new_params, GDCIState(state.noise, state.step + 1,
                                     state.bits + bits)


class VRGDCIState(NamedTuple):
    h: Any              # per-worker shifts on iterates, W-stacked
    h_bar: Any          # master aggregated shift (tracked incrementally)
    noise: Any
    step: int
    bits: torch.Tensor


@dataclass(frozen=True)
class VRGDCI:
    """Algorithm 2 -- Variance-Reduced GDCI.  Eliminates the neighborhood:

        delta_i = Q_i(x - gamma grad_i - h_i)
        h_i    += alpha delta_i
        x       = (1-eta) x + eta (mean_i delta_i + h_bar)

    Theorem 6: linear to the exact optimum at rate min{alpha/2, eta}.

    The phases (``message`` / ``apply`` / ``round``) are the reference's,
    and the same object drives the simulator and the trainer
    (``launch/train.py`` bypasses its optimizer for it).  ``h`` and
    ``h_bar`` are updated in place, and so are the params by ``round``.
    """

    q: Compressor = field(default_factory=Identity)
    gamma: float = 0.1
    eta: float = 0.5
    alpha: float = 0.5
    channel: Optional[Channel] = None

    stateful = True

    # -- trainer-facing state protocol (that of core.shift_rules) ---------

    def init(self, params, w: int):
        """Worker-stacked zero iterate shifts ``(W, *p.shape)``."""
        return {k: torch.zeros((w, *p.shape), dtype=p.dtype, device=p.device)
                for k, p in params.items()}

    def init_bar(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    # -- phases -----------------------------------------------------------

    def message(self, noise, params, wgrads, h, channel=None):
        """The wire message: per-worker compressed iterate proposals
        delta_i = Q(x - gamma grad_i - h_i).  Returns ``(delta, bits)``."""
        ch = _chan(channel if channel is not None else self.channel)
        target = {k: torch.add(x[None], wgrads[k].to(x.dtype),
                               alpha=-self.gamma).sub_(h[k])
                  for k, x in params.items()}
        return ch.uplink(self.q, noise, target)

    def apply(self, params, delta, delta_bar, h, h_bar):
        """Iterate + shift update from the aggregated proposal
        (``delta_bar``: {path: WorkerMean}), IN PLACE.  The model mix
        (1 - eta) x + eta (delta_bar + h_bar) runs in f32, rounded as
        XLA contracts it, and is cast back to the param dtype."""
        e = self.eta
        for k, x in params.items():
            h[k].add_(delta[k], alpha=self.alpha)
            inner = delta_bar[k].axpy(h_bar[k]).to(torch.float32)
            x.copy_(torch.add(e * inner, x.to(torch.float32), alpha=1.0 - e))
            delta_bar[k].axpy_(h_bar[k], self.alpha)
        return params, h, h_bar

    def round(self, noise, params, wgrads, h, h_bar, channel=None):
        """One full round: ``(new_params, h_new, h_bar_new, bits)``."""
        ch = _chan(channel if channel is not None else self.channel)
        delta, bits = self.message(noise, params, wgrads, h, ch)
        delta_bar = ch.reduce(noise, delta)
        new_params, h_new, hb_new = self.apply(params, delta, delta_bar, h,
                                               h_bar)
        return new_params, h_new, hb_new, bits

    # -- simulator state -----------------------------------------------------

    def init_state(self, params, n_workers: int, *, seed: int = 0,
                   noise: Any = None) -> VRGDCIState:
        return VRGDCIState(self.init(params, n_workers),
                           self.init_bar(params),
                           _state_noise(noise, seed, params), 0,
                           _zero_bits(params))

    def update(self, params, state: VRGDCIState, wgrads):
        new_params, h_new, hb_new, bits = self.round(
            state.noise, params, wgrads, state.h, state.h_bar, self.channel)
        return new_params, VRGDCIState(h_new, hb_new, state.noise,
                                       state.step + 1, state.bits + bits)


def stepsize_gdci(L, L_max, mu, omega, n):
    """Theorem 5 pair (eta, gamma)."""
    eta = 1.0 / (L / mu + (2.0 * omega / n) * (L_max / mu - 1.0))
    gamma = (1.0 + 2.0 * eta * omega / n) / (eta * (L + 2.0 * L_max * omega / n))
    return eta, gamma


def stepsize_vr_gdci(L, L_max, mu, omega, n):
    """Theorem 6 triple (alpha, eta, gamma)."""
    alpha = 1.0 / (omega + 1.0)
    eta = 1.0 / (L / mu + (6.0 * omega / n) * (L_max / mu - 1.0))
    gamma = (1.0 + 6.0 * omega * eta / n) / (eta * (L + 6.0 * L_max * omega / n))
    return alpha, eta, gamma
