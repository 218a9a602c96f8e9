"""Shift update rules -- the phased engine of the reference's
``repro/core/shift_rules.py``, for the rules this slice runs.

Trees are flat dicts ``{path: tensor}`` in the reference's leaf order
(``repro_torch.models.model.leaf_paths``); worker-stacked trees have a
leading ``(W,)`` axis on every leaf.  The phases are the reference's::

    init(params, w)              -> h       worker-stacked state (None if
                                            the rule is stateless)
    init_bar(params)             -> h_bar   master aggregated shift
    message_leaf(q, noise, g, h) -> (m, bits)
                                            ONE leaf's wire message;
                                            ``noise`` is already bound
                                            to the leaf's GLOBAL position
    message(q, noise, wgrads, h) -> (m, bits)
    aux(noise, wgrads, h)        -> (aux, extra_bits)
    apply(wgrads, m, m_bar, h, h_bar, aux)
                                 -> (g_bar, h_new, h_bar_new)
    round(q, noise, wgrads, h, h_bar, channel)
                                 -> (g_bar, h_new, h_bar_new, bits)

``bits`` is an f32 0-d CPU tensor accumulated leaf by leaf in the
reference's order, so it equals the reference's f32 counter exactly.
Rules still to be ported (star, rand_diana) raise
``NotImplementedError`` from ``make_shift_rule``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.comm.channel import Channel, SimChannel
from repro_torch.comm.wire import LeafNoise, encode_decode_workers
from repro_torch.core.compressors import Compressor, f32_bits

Tree = Dict[str, torch.Tensor]

#: ROADMAP item that ports the remaining rules
_RULES_ITEM = "ROADMAP queue 1, item 3 (convex Algorithm 1)"


def _chan(channel: Optional[Channel]) -> Channel:
    return channel if channel is not None else SimChannel()


@dataclass(frozen=True)
class ShiftRule:
    """Base of the phased protocol (see module docstring)."""

    #: rules with ``stateful = False`` keep ``h``/``h_bar`` as ``None``
    stateful: bool = field(default=True, init=False, repr=False)

    def init(self, params: Tree, w: int) -> Optional[Tree]:
        """Worker-stacked zero shifts ``(W, *p.shape)`` per leaf."""
        if not self.stateful:
            return None
        return {k: torch.zeros((w, *p.shape), dtype=p.dtype, device=p.device)
                for k, p in params.items()}

    def init_bar(self, params: Tree) -> Optional[Tree]:
        """The master's aggregated shift ``h_bar`` (no worker axis)."""
        if not self.stateful:
            return None
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def message_leaf(self, q: Compressor, noise, g, h):
        """One leaf's wire message: ``Q(g - h)`` encoded per worker.
        Returns ``(decoded W-stacked message, structural wire bits)``."""
        diff = g if h is None else g - h
        payloads, m = encode_decode_workers(q, noise, diff)
        return m, q.wire_bits(payloads)

    def message(self, q: Compressor, noise, wgrads: Tree, h: Optional[Tree]):
        """``message_leaf`` over the tree, each leaf's noise bound to its
        global position."""
        out = {}
        bits = f32_bits()
        for i, (k, g) in enumerate(wgrads.items()):
            m, b = self.message_leaf(q, LeafNoise(noise, i), g,
                                     None if h is None else h[k])
            out[k] = m
            bits = bits + f32_bits(b)
        return out, bits

    def aux(self, noise, wgrads, h):
        """Tree-level extras: ``(aux carried to apply, extra wire bits)``."""
        return None, f32_bits()

    def apply(self, wgrads, m, m_bar, h, h_bar, aux):
        raise NotImplementedError

    def round(self, q: Compressor, noise, wgrads, h, h_bar,
              channel: Optional[Channel] = None):
        """One full communication round, scheduled by the channel.
        Returns ``(g_bar, h_new, h_bar_new, bits)``."""
        return _chan(channel).shift_round(self, q, noise, wgrads, h, h_bar)


@dataclass(frozen=True)
class FixedShift(ShiftRule):
    """DCGD-SHIFT with constant shifts (eq. 6); ``h = 0`` (the stateless
    default) is plain DCGD."""

    stateful: bool = field(default=False, init=False, repr=False)

    def apply(self, wgrads, m, m_bar, h, h_bar, aux):
        g_bar = m_bar if h_bar is None else {
            k: h_bar[k] + mb for k, mb in m_bar.items()
        }
        return g_bar, h, h_bar


@dataclass(frozen=True)
class DianaShift(ShiftRule):
    """Classic DIANA (eq. 11): h_i += alpha * Q(grad_i - h_i).  The
    reference's generalized form (eq. 10) with a compressor C other than
    Zero is not ported yet (ROADMAP queue 1, item 3).  The same message
    feeds the estimator and the shift."""

    alpha: float = 0.1

    def message_leaf(self, q, noise, g, h):
        # the reference's two-part message C(x) + Q(x - C(x)) with
        # C = Zero: C decodes to exact zeros and sends an empty payload,
        # so x - C(x) and C(x) + Q(...) are the identity bit for bit and
        # the zero tensors the reference builds are skipped
        diff = g if h is None else g - h
        payloads, qm = encode_decode_workers(q, noise, diff)
        return qm, 0.0 + q.wire_bits(payloads)

    def apply(self, wgrads, m, m_bar, h, h_bar, aux):
        # h and h_bar are updated IN PLACE (the reference rebinds them):
        # at full size a second copy of the (W, ...) shifts would not fit
        a = self.alpha
        g_bar = {k: h_bar[k] + mb for k, mb in m_bar.items()}
        for k in h:
            h[k].add_(m[k], alpha=a)
            h_bar[k].add_(m_bar[k], alpha=a)
        return g_bar, h, h_bar


def _integrate(m, m_bar, h, h_bar, eta: float, nu: float):
    """The error-feedback update shared by EF21 and EF-BV: ``g_bar =
    h_bar + nu * m_bar``, then ``h += eta * m`` and ``h_bar += eta *
    m_bar``, IN PLACE (the reference rebinds them; at full size a second
    copy of the (W, ...) shifts would not fit).  ``add`` with ``alpha``
    rounds once, as XLA contracts the reference's ``a + c * b``."""
    g_bar = {k: torch.add(h_bar[k], mb, alpha=nu) for k, mb in m_bar.items()}
    for k in h:
        h[k].add_(m[k], alpha=eta)
        h_bar[k].add_(m_bar[k], alpha=eta)
    return g_bar, h, h_bar


@dataclass(frozen=True)
class EF21Shift(ShiftRule):
    """EF21 error feedback (Richtarik, Sokolov & Fatkhullin, 2021): the
    wire message is the (contractive) compression of the gradient-shift
    residual and the shift integrates it::

        c_i = C(grad_i - h_i);  g = mean_i (h_i + c_i);  h_i += c_i

    with the master's aggregate shift tracked as ``h_bar += mean_i c_i``.
    Only ``apply`` differs from the base rule."""

    def apply(self, wgrads, m, m_bar, h, h_bar, aux):
        return _integrate(m, m_bar, h, h_bar, 1.0, 1.0)


@dataclass(frozen=True)
class EFBVShift(ShiftRule):
    """EF-BV (Condat, Li & Richtarik, 2022), EF21's variance-reduced
    generalization::

        m_i = C(grad_i - h_i);  g = h_bar + nu * m_bar
        h_i += eta * m_i;       h_bar += eta * m_bar

    ``eta = nu = 1`` is EF21 exactly."""

    eta: float = 1.0
    nu: float = 1.0

    def apply(self, wgrads, m, m_bar, h, h_bar, aux):
        return _integrate(m, m_bar, h, h_bar, self.eta, self.nu)


#: every rule the reference's registry accepts
SHIFT_RULES = ("fixed", "dcgd", "star", "diana", "rand_diana", "ef21",
               "efbv")


def make_shift_rule(name: str, **kw) -> ShiftRule:
    table = {
        "fixed": FixedShift,
        "dcgd": FixedShift,
        "diana": DianaShift,
        "ef21": EF21Shift,
        "efbv": EFBVShift,
    }
    if name in SHIFT_RULES and name not in table:
        raise NotImplementedError(
            f"shift rule {name!r} is not ported yet: {_RULES_ITEM}"
        )
    if name not in table:
        raise ValueError(
            f"unknown shift rule {name!r}; have shift rules {SHIFT_RULES}"
        )
    return table[name](**kw)
