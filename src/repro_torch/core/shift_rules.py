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
    message_draws(q, noise, w)   -> the leaf's w per-worker draws
    message_leaf_worker(q, draw, g, h) -> m_j
                                            ONE worker's row of
                                            ``message_leaf`` (the fused
                                            backward encode's unit,
                                            ``comm.fused_vjp``)
    message_bits_aot(q, wleaf_like) -> bits  from shapes alone
    aux(noise, wgrads, h)        -> (aux, extra_bits)
    apply(wgrads, m, m_bar, h, h_bar, aux)
                                 ``m_bar``: {path: WorkerMean}, the
                                 aggregated message as the reference's
                                 jitted round folds it (see
                                 ``dist.collectives.WorkerMean``)
                                 -> (g_bar, h_new, h_bar_new)
    round(q, noise, wgrads, h, h_bar, channel)
                                 -> (g_bar, h_new, h_bar_new, bits)

``bits`` is an f32 0-d tensor accumulated leaf by leaf in the
reference's order, so it equals the reference's f32 counter exactly: on
the CPU when it is structural (computed from shapes), on the draws'
device when it depends on them (Rand-DIANA's refreshes).

``StarShift`` (DCGD-STAR) keeps the state ``{"h", "star"}`` and runs its
own round, two uplinks (Q's, then C's), on the parameter server only.
Two-part messages tag their draws with the part (``comm.wire``):
generalized DIANA's ``"c"`` and ``"q"``, STAR's ``"q"`` and ``"c"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.comm.channel import Channel, SimChannel
from repro_torch.comm.wire import (LeafNoise, bits_aot,
                                   encode_decode_workers,
                                   shifted_message_row,
                                   shifted_message_workers, worker_draws)
from repro_torch.core.compressors import Compressor, Zero, f32_bits
from repro_torch.dist.collectives import WorkerMean, drop_payload_rows

Tree = Dict[str, torch.Tensor]


def _chan(channel: Optional[Channel]) -> Channel:
    return channel if channel is not None else SimChannel()


def residual_sq_diag(wgrads: Tree, h: Optional[Tree]):
    """The paper's headline probe, as f32 0-d tensors: ``grad_sq`` =
    ``mean_i ||g_i||^2`` and ``shift_residual_sq`` = ``mean_i ||g_i -
    h_i||^2`` over the worker axis; with ``h is None`` (stateless rules)
    the residual is the gradient norm itself."""
    w = next(iter(wgrads.values())).shape[0]

    def _sq(leaves):
        return sum(torch.sum(torch.square(a.to(torch.float32)))
                   for a in leaves)

    grad_sq = _sq(wgrads.values()) / w
    if h is None:
        return {"grad_sq": grad_sq, "shift_residual_sq": grad_sq}
    resid_sq = _sq(g - h[k] for k, g in wgrads.items()) / w
    return {"grad_sq": grad_sq, "shift_residual_sq": resid_sq}


def dense_message_bits(wgrads_like: Tree) -> float:
    """Structural wire cost of one worker's uncompressed message: each
    W-stacked leaf's inner numel at its dtype's width, summed."""
    return float(sum(a[0].numel() * a.element_size() * 8
                     for a in wgrads_like.values()))


@dataclass(frozen=True)
class ShiftRule:
    """Base of the phased protocol (see module docstring)."""

    #: rules with ``stateful = False`` keep ``h``/``h_bar`` as ``None``
    stateful: bool = field(default=True, init=False, repr=False)

    #: ``fusible``: ``apply`` reads only the per-worker messages, never
    #: the dense ``wgrads``, and the round is message -> aux -> reduce ->
    #: apply, so the fused backward encode (``comm.fused_vjp``) can emit
    #: the messages as the cotangents themselves
    fusible: bool = field(default=True, init=False, repr=False)

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
        """One leaf's wire message: ``Q(g - h)`` encoded per worker
        (``comm.wire.shifted_message_workers``: the natural codec runs
        its own ``shifted_round_trip``).  Returns ``(decoded W-stacked
        message, structural wire bits)``."""
        return shifted_message_workers(q, noise, g, h)

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

    # -- the fused-backward decomposition of message_leaf ----------------
    # ``message_leaf`` is ``message_leaf_worker`` over the rows of the
    # W-stacked leaf, worker j with entry j of ``message_draws``, bit for
    # bit: the fused backward encode runs it inside worker j's backward
    # pass on that worker's cotangent.

    def message_draws(self, q: Compressor, noise: LeafNoise, w: int) -> list:
        """The ``w`` per-worker draw objects ``message_leaf`` consumes for
        one leaf (``noise`` bound to its global position)."""
        return worker_draws(q, noise, w)

    def message_leaf_worker(self, q: Compressor, draw, g, h):
        """ONE worker's row of ``message_leaf``: ``g`` and ``h`` without
        the worker axis, ``draw`` that worker's entry of
        ``message_draws``.  Returns the decoded message only."""
        return shifted_message_row(q, draw, g, h)

    def message_bits_aot(self, q: Compressor, wleaf_like) -> float:
        """``message_leaf``'s wire bits for a W-stacked leaf like
        ``wleaf_like``, from its shape and dtype alone."""
        return bits_aot(q, wleaf_like)

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
        if h_bar is None:
            return {k: mb.value() for k, mb in m_bar.items()}, h, h_bar
        return {k: mb.axpy(h_bar[k]) for k, mb in m_bar.items()}, h, h_bar


@dataclass(frozen=True)
class StarShift(ShiftRule):
    """DCGD-STAR (eq. 8): oracle shifts around grad_i(x*), optionally
    compressed by a contractive C.  Theorem 2: exact linear convergence.

    Needs the optimum, so it is the theoretical reference point only.
    Its state is ``{"h", "star"}`` (``init_with_star``) and its round
    sends two uplinks, Q's then C's, so it overrides ``round`` wholesale
    (and is not fusible); it runs on the parameter server
    (``SimChannel``) only."""

    fusible: bool = field(default=False, init=False, repr=False)

    c: Compressor = field(default_factory=Zero)

    def init_with_star(self, wgrads_star: Tree):
        """State carries the oracle gradients; h starts there too."""
        return {"h": dict(wgrads_star), "star": wgrads_star}

    def init(self, params, w):
        raise ValueError("StarShift requires init_with_star(grads_at_optimum)")

    def init_bar(self, params):
        return None

    def round(self, q, noise, wgrads, state, h_bar, channel=None):
        ch = _chan(channel)
        h, star = state["h"], state["star"]
        m, bits_q = ch.uplink(q, noise, {k: g - h[k]
                                         for k, g in wgrads.items()}, "q")
        g_bar = ch.reduce_mean(noise, {k: h[k] + mm for k, mm in m.items()})
        # h_i^{k+1} = g*_i + C(grad_i - g*_i)
        chm, bits_c = ch.uplink(self.c, noise, {k: g - star[k] for k, g
                                                in wgrads.items()}, "c")
        h_new = {k: star[k] + cc for k, cc in chm.items()}
        return g_bar, {"h": h_new, "star": star}, None, bits_q + bits_c


@dataclass(frozen=True)
class DianaShift(ShiftRule):
    """Generalized DIANA (eq. 10): h_i += alpha * Q_ind(grad_i - h_i) with
    Q_ind(x) = C(x) + Q(x - C(x)) the induced compressor; C = Zero (the
    default) is classic DIANA (eq. 11).  The same message feeds the
    estimator and the shift; its wire bits are C's plus Q's."""

    alpha: float = 0.1
    c: Compressor = field(default_factory=Zero)

    def message_leaf(self, q, noise, g, h):
        qnoise = noise.with_part("q")
        if isinstance(self.c, Zero):
            # C decodes to exact zeros and sends an empty payload, so
            # x - C(x) and C(x) + Q(...) are the identity bit for bit and
            # the zero tensors the reference builds are skipped
            qm, bits = shifted_message_workers(q, qnoise, g, h)
            return qm, 0.0 + bits
        diff = g if h is None else g - h
        cpay, cm = encode_decode_workers(self.c, noise.with_part("c"), diff)
        qpay, qm = encode_decode_workers(q, qnoise, diff - cm)
        return (drop_payload_rows(cm.add_(qm)),
                self.c.wire_bits(cpay) + q.wire_bits(qpay))

    def message_draws(self, q, noise, w):
        cd = worker_draws(self.c, noise.with_part("c"), w)
        qd = worker_draws(q, noise.with_part("q"), w)
        return [{"c": c, "q": d} for c, d in zip(cd, qd)]

    def message_leaf_worker(self, q, draw, g, h):
        if isinstance(self.c, Zero):      # message_leaf's shortcut
            return shifted_message_row(q, draw["q"], g, h)
        diff = g if h is None else g - h
        cm = self.c(draw["c"], diff)
        return cm + q(draw["q"], diff - cm)

    def message_bits_aot(self, q, wleaf_like):
        return bits_aot(self.c, wleaf_like) + bits_aot(q, wleaf_like)

    def apply(self, wgrads, m, m_bar, h, h_bar, aux):
        # h and h_bar are updated IN PLACE (the reference rebinds them):
        # at full size a second copy of the (W, ...) shifts would not fit
        a = self.alpha
        g_bar = {k: mb.axpy(h_bar[k]) for k, mb in m_bar.items()}
        for k in h:
            h[k].add_(m[k], alpha=a)
            m_bar[k].axpy_(h_bar[k], a)
        return g_bar, h, h_bar


@dataclass(frozen=True)
class RandDianaShift(ShiftRule):
    """Rand-DIANA (eq. 12): the shift is the gradient at a lazily
    refreshed point, h_i = grad_i(w_i), with w_i reset to x^k with
    probability p each round.  The refresh sends the dense gradient, so
    each refreshing worker is charged one dense message
    (``dense_message_bits``).  Theorem 4: max{kappa(1 + omega/n), 1/p}.

    ``aux`` draws one uniform a worker (``aux_uniform``); a worker
    refreshes where it is below ``p``, the reference's Bernoulli draw.
    Not fusible: ``apply`` refreshes the shifts from the dense gradients."""

    fusible: bool = field(default=False, init=False, repr=False)

    p: float = 0.1

    def aux(self, noise, wgrads, h):
        g = next(iter(wgrads.values()))
        refresh = noise.aux_uniform((g.shape[0],)) < self.p
        extra = (refresh.sum(dtype=torch.float32)
                 * f32_bits(dense_message_bits(wgrads)).to(refresh.device))
        return refresh, extra

    def apply(self, wgrads, m, m_bar, h, h_bar, refresh):
        # h_new = where(refresh, g, h) and h_bar += mean_w(h_new - h), one
        # leaf at a time: the difference is taken before h is updated IN
        # PLACE, so one (W, ...) temporary is alive at a time
        g_bar = {k: mb.axpy(h_bar[k]) for k, mb in m_bar.items()}
        for k, g in wgrads.items():
            mask = refresh.reshape((-1,) + (1,) * (g.dim() - 1))
            diff = torch.where(mask, g, h[k]).sub_(h[k])
            WorkerMean.of_rows(diff).axpy_(h_bar[k])
            del diff
            torch.where(mask, g, h[k], out=h[k])
        return g_bar, h, h_bar


def _integrate(m, m_bar, h, h_bar, eta: float, nu: float):
    """The error-feedback update shared by EF21 and EF-BV: ``g_bar =
    h_bar + nu * m_bar``, then ``h += eta * m`` and ``h_bar += eta *
    m_bar``, IN PLACE (the reference rebinds them; at full size a second
    copy of the (W, ...) shifts would not fit).  ``add`` with ``alpha``
    rounds once, as XLA contracts the reference's ``a + c * b``."""
    g_bar = {k: mb.axpy(h_bar[k], nu) for k, mb in m_bar.items()}
    for k in h:
        h[k].add_(m[k], alpha=eta)
        m_bar[k].axpy_(h_bar[k], eta)
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
        "star": StarShift,
        "diana": DianaShift,
        "rand_diana": RandDianaShift,
        "ef21": EF21Shift,
        "efbv": EFBVShift,
    }
    if name not in table:
        raise ValueError(
            f"unknown shift rule {name!r}; have shift rules {SHIFT_RULES}"
        )
    return table[name](**kw)
