"""The model-delta publisher: shifted compression of the DOWNLINK -- the
port of the reference's ``repro/serving/delta.py``.

The published vector is the TRAINER'S PARAMS and the shift is the
serving fleet's reconstruction ``h_bar``: every ``publish_every`` steps
the publisher emits ``Q(params - h_bar)`` through the transport's model
wire and integrates the decoded message into ``h_bar`` with the EF-BV
shift recursion (W = 1: the trainer is the only worker on this wire).

Subscriber lockstep is the load-bearing invariant: a replica that has
applied every message holds EXACTLY the publisher's ``h_bar``, because
both sides run the same update, ``p + eta * m_bar`` (``apply_msg``; the
publisher calls the same leaf function).  So the publisher knows each
in-sync replica's error, ``||params - h_bar|| / ||params||``, and
attaches it to every message as ``err_rel``.

Two wire formats:

  * LOSSY flags (q8 / natural / topk / sign / randk): the EF-BV stream.
    Its error is bounded and resets to ZERO at a resync.
  * ``dense`` is the LOSSLESS stream: the payload is the INTEGER
    BIT-PATTERN delta ``int(p) - int(h)`` (wrapping), applied as
    ``float(int(h) + d)`` -- exact for all values (NaN payloads,
    infinities, subnormals, signed zeros), where the float delta ``p -
    h`` is not.  One exact publish makes a replica bit-identical to the
    trainer even after a lossy initial sync.

``resync`` is a full-params REPLACEMENT message (never additive).

Ownership (the trainer's optimizer updates its params IN PLACE): the
publisher holds no tensor of the trainer's -- ``snapshot`` copies the
params, and ``Channel.broadcast`` returns the receiver's own buffers --
and it rebinds ``h_bar`` instead of updating it in place, so a message's
payload is never changed after it is sent; an engine keeps its own copy
of what it serves (``serving.engine``).  The draws of message ``seq``
are those of ``AddressedNoise`` on the wire's stream (``wire_stream``)
at round ``seq`` (the reference folds ``seq`` into the wire's key): 0
for the initial sync, then one round a publish.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.comm.channel import SimChannel
from repro_torch.comm.transport import wire_stream
from repro_torch.comm.wire import AddressedNoise
from repro_torch.core.compressors import Identity
from repro_torch.core.shift_rules import EFBVShift

Tree = Dict[str, torch.Tensor]

#: bit-pattern integer dtype per float itemsize (the lossless wire)
_INT_OF_ITEMSIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _int_dtype(leaf: torch.Tensor) -> torch.dtype:
    itemsize = leaf.element_size()
    if itemsize not in _INT_OF_ITEMSIZE:
        raise ValueError(
            f"no bit-pattern integer dtype for {leaf.dtype} (itemsize "
            f"{itemsize}); have widths {sorted(_INT_OF_ITEMSIZE)}")
    return _INT_OF_ITEMSIZE[itemsize]


def _int_delta_leaf(p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Wrapping bit-pattern delta: exact for all values, small for
    nearby ones."""
    it = _int_dtype(p)
    return p.view(it) - h.view(it)


def _int_apply_leaf(h: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Exact inverse of ``_int_delta_leaf``: recovers ``p`` bitwise."""
    return (h.view(d.dtype) + d).view(h.dtype)


def _lossy_apply_leaf(p: torch.Tensor, d: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """``p + scale * d`` -- EF-BV's ``h_bar`` line, rounded twice as the
    reference's eager ops round it; the publisher and every replica run
    this one function."""
    return p + scale * d


def tree_rel_err(a: Tree, b: Tree) -> float:
    """``||a - b|| / ||a||`` over whole trees, accumulated in f32."""
    num = sum(torch.sum(torch.square((x - b[k]).to(torch.float32)))
              for k, x in a.items())
    den = sum(torch.sum(torch.square(x.to(torch.float32)))
              for x in a.values())
    return float(torch.sqrt(num) / (torch.sqrt(den) + 1e-12))


def dense_tree_bits(tree_like) -> float:
    """Structural bits of one full-width broadcast of ``tree_like``
    (``{path: anything with .shape and .dtype}``): each leaf's numel at
    its dtype's width -- the baseline every delta publish is measured
    against."""
    return float(sum(math.prod(leaf.shape) * leaf.dtype.itemsize * 8
                     for leaf in tree_like.values()))


@dataclasses.dataclass(frozen=True)
class DeltaMsg:
    """One downlink message.  ``payload`` is the DECODED tree (the wire
    would carry the codec's payload; ``bits`` charges it structurally)."""

    kind: str          # "delta" | "resync"
    seq: int           # stream sequence number (applies strictly in order)
    step: int          # trainer step this message brings a subscriber to
    payload: Any       # delta: decoded m_bar (or int bit-delta); resync: params
    scale: float       # delta integration rate (the rule's eta; 1.0 exact)
    exact: bool        # True: integer bit-pattern delta (lossless stream)
    bits: float        # structural wire bits of the payload
    err_rel: float     # publisher-side ||params - h_bar|| / ||params|| AFTER
    #                    this message (an in-sync replica's exact error)


def apply_msg(params: Tree, msg: DeltaMsg) -> Tree:
    """Subscriber-side apply, the mirror of the publisher: a ``resync``
    REPLACES (the error becomes exactly zero); exact deltas add in
    bit-pattern space; lossy deltas run the publisher's own
    ``p + eta * m_bar``.  Returns a new tree; ``params`` is not
    changed."""
    if msg.kind == "resync":
        return msg.payload
    if msg.exact:
        return {k: _int_apply_leaf(p, msg.payload[k])
                for k, p in params.items()}
    return {k: _lossy_apply_leaf(p, msg.payload[k], msg.scale)
            for k, p in params.items()}


class DeltaPublisher:
    """Trainer-side end of the model wire (see module docstring).

    ``wire`` is the transport's broadcast ``model`` wire; its codec
    defines the stream (``Identity`` selects the exact bit-delta path).
    ``rule`` must be an ``EFBVShift``: the downlink uses its shift
    integration; the estimator knob ``nu`` is a training-side concept
    and is unused here.  ``noise``: the source whose wire stream the
    messages draw from (default ``AddressedNoise(0)`` on the device of
    the params first synced).
    """

    def __init__(self, wire, *, rule: Optional[EFBVShift] = None,
                 noise=None, track_error: bool = True):
        self.wire = wire
        self.codec = wire.codec
        self.channel = wire.channel if wire.channel is not None else SimChannel()
        self.rule = EFBVShift() if rule is None else rule
        if not isinstance(self.rule, EFBVShift):
            raise ValueError(
                "DeltaPublisher runs the EF-BV shift recursion over "
                f"params; got rule {type(self.rule).__name__} (use "
                "EFBVShift -- eta=nu=1 is EF21)")
        self.exact = isinstance(self.codec, Identity)
        self.track_error = track_error
        self._noise = noise
        self._base = None
        self.h_bar: Optional[Tree] = None   # the fleet's reconstruction
        self.seq = 0
        self.step = 0
        self.published_bits = 0.0   # cumulative, deltas + resyncs
        self.delta_bits = []        # per-delta-publish structural bits
        self.err_history = []       # err_rel after each delta publish

    def _round(self, params: Tree, r: int):
        """The noise of stream round ``r``."""
        if self._base is None:
            noise = self._noise if self._noise is not None else (
                AddressedNoise(0, next(iter(params.values())).device))
            self._base = wire_stream(noise, self.wire.name)
        return self._base.at_round(r)

    def _emit(self, kind, step, payload, scale, exact, bits, params):
        self.seq += 1
        self.step = int(step)
        self.published_bits += float(bits)
        # err is vs the stream state AFTER this message: exactly 0.0 for a
        # snapshot, the sync codec's error for a lossy initial sync
        err = tree_rel_err(params, self.h_bar) if self.track_error else 0.0
        return DeltaMsg(kind=kind, seq=self.seq, step=int(step),
                        payload=payload, scale=float(scale),
                        exact=bool(exact), bits=float(bits), err_rel=err)

    def initial_sync(self, params: Tree, *, step: int = 0,
                     sync_codec=None) -> DeltaMsg:
        """Bootstrap the stream with one full-model broadcast through
        ``sync_codec`` (default the wire's own codec).  The publisher's
        ``h_bar`` is the DECODED sync, so replica and publisher start in
        lockstep whatever the sync's fidelity."""
        q = self.codec if sync_codec is None else sync_codec
        decoded, bits = self.channel.broadcast(q, self._round(params, 0),
                                               params)
        self.h_bar = decoded
        return self._emit("resync", step, decoded, 1.0, False, float(bits),
                          params)

    def publish(self, params: Tree, *, step: int) -> DeltaMsg:
        """One shifted-compressed delta publish at trainer ``step``."""
        if self.h_bar is None:
            raise ValueError("publish before initial_sync -- the stream "
                             "has no shift state yet")
        if self.exact:
            delta = {k: _int_delta_leaf(p, self.h_bar[k])
                     for k, p in params.items()}
            self.h_bar = {k: _int_apply_leaf(h, delta[k])
                          for k, h in self.h_bar.items()}
            msg = self._emit("delta", step, delta, 1.0, True,
                             dense_tree_bits(delta), params)
        else:
            # the round of Channel.shift_round at W = 1: the trainer is
            # the only worker on this wire, and its shift is h_bar
            noise = self._round(params, self.seq + 1)
            wp = {k: p[None] for k, p in params.items()}
            wh = {k: hb[None] for k, hb in self.h_bar.items()}
            m, bits = self.rule.message(self.codec, noise, wp, wh)
            del wh
            m_bar = self.channel.reduce_mean(noise, m)
            del m
            eta = self.rule.eta
            self.h_bar = {k: _lossy_apply_leaf(hb, m_bar[k], eta)
                          for k, hb in self.h_bar.items()}
            msg = self._emit("delta", step, m_bar, eta, False, float(bits),
                             params)
        self.delta_bits.append(msg.bits)
        self.err_history.append(msg.err_rel)
        return msg

    def snapshot(self, params: Tree, *, step: int) -> DeltaMsg:
        """Dense resync: full params at identity width, REPLACEMENT
        semantics.  ``h_bar`` becomes a copy of ``params``, so every
        subscriber's error returns to exactly zero."""
        self.h_bar = {k: p.detach().clone() for k, p in params.items()}
        return self._emit("resync", step, self.h_bar, 1.0, False,
                          dense_tree_bits(params), params)

    def dense_bits_per_publish(self) -> float:
        """The dense-broadcast baseline this stream is measured against."""
        if self.h_bar is None:
            raise ValueError("no shift state yet (initial_sync first)")
        return dense_tree_bits(self.h_bar)
