"""The Channel: one transport abstraction for compressed messages -- the
port of the reference's ``repro/comm/channel.py`` for the modes the
port runs.

``Channel.uplink`` is the W-stacked encode and decode of a tree with its
structural wire bits (DCGD-STAR's and GDCI's messages);
``Channel.broadcast`` the downlink, one encode per leaf from the sender
(the model wire of ``comm.transport``, ``serving.delta``);
``Channel.all_to_all`` one forwarded payload (the moe and act wires);
``Channel.push_mean`` is an uplink then its aggregation;
``Channel.shift_round`` schedules one shift-rule round, and
``Channel.fused_round`` its reduce/apply tail for messages the backward
pass already emitted (``comm.fused_vjp``); the round's parts are spans
(``round/message``, ``round/aggregate``, ``round/apply``;
``repro_torch.spans``).

``SimChannel`` is the parameter server (exact worker mean);
``MeshChannel`` is the production aggregation of the stacked-worker
step over a ``launch.mesh.HostMesh``, in the ``dense`` (exact mean),
``randk_shared`` (shared-pattern Rand-K), ``q8_ring``
(``Int8Stochastic`` ring) or ``q8_ring_fused`` (the ring on the q8
kernels) format (``dist.collectives``); its ``wspecs`` (worker-stacked
specs, ``dist.sharding``) give each ``model`` shard of a leaf a ring of
its own, and a mesh with a ``pod`` axis adds the pod stage.  The
``ef21`` and ``efbv`` comm modes aggregate densely.  ``AsyncChannel``
(``comm.overlap``) is the overlap runtime: the ``q8_ring_overlap`` and
``efbv_overlap`` modes, and ``q8_ring_fused_vjp`` with one bucket per
leaf.  The tuner's ``auto`` is a sentinel, not a transport:
``repro_torch.tune`` resolves it to one of these modes
(``tune.autotune`` + ``tune.apply_plan``) before a channel is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.comm.wire import (
    LeafNoise,
    encode_decode_workers,
    encode_meta_free,
)
from repro_torch.core.compressors import ShapeDtype, f32_bits
from repro_torch.dist.collectives import (
    AGGREGATION_MODES,
    WorkerMean,
    compressed_tree_mean,
    dense_mean,
)
from repro_torch.spans import span

Tree = Dict[str, torch.Tensor]

#: comm modes served by the bucketed overlap runtime (``AsyncChannel``)
OVERLAP_MODES = ("q8_ring_overlap", "efbv_overlap")

#: comm modes whose messages the backward pass itself emits
#: (``comm.fused_vjp``), reduced by the ``AsyncChannel`` one leaf a bucket
FUSED_VJP_MODES = ("q8_ring_fused_vjp",)

#: every comm mode ``make_channel`` accepts, the reference's
CHANNEL_MODES = (("dense", "randk_shared", "q8_ring", "q8_ring_fused",
                  "ef21", "efbv", "sim")
                 + OVERLAP_MODES + FUSED_VJP_MODES)


def _check_mode(mode: str):
    """Raise for a comm mode no channel serves: the tuner's ``auto``
    sentinel with the reference's wording, an unknown mode naming every
    accepted one."""
    if mode == "auto":
        raise ValueError(
            "comm_mode 'auto' is a tuner sentinel, not a transport: "
            "resolve it to a concrete mode first (repro_torch.tune.autotune "
            "+ apply_plan, or `train.py --comm_mode auto` which does both)"
        )
    if mode not in CHANNEL_MODES:
        raise ValueError(f"unknown comm mode {mode!r}; have channel modes "
                         f"{CHANNEL_MODES} (aggregation formats: "
                         f"{AGGREGATION_MODES})")


class Channel:
    """Transport for compressed messages between workers and master."""

    def uplink(self, q, noise, wtree: Tree, part: Optional[str] = None):
        """Encode+decode each worker's slice of a W-stacked tree with
        codec ``q``, each leaf's draws bound to its global position (and
        to ``part``, for the second uplink of a two-part round).  Returns
        ``(decoded W-stacked messages, total wire bits)``, the bits the
        structural ``q.wire_bits`` of the payloads, summed in f32 leaf by
        leaf."""
        out = {}
        bits = f32_bits()
        for i, (k, leaf) in enumerate(wtree.items()):
            payloads, out[k] = encode_decode_workers(
                q, LeafNoise(noise, i, part), leaf)
            bits = bits + f32_bits(q.wire_bits(payloads))
        return out, bits

    def broadcast(self, q, noise, tree: Tree):
        """Downlink (model broadcast): the sender encodes each leaf once,
        its draws bound to the leaf's global position (no worker), and
        every receiver decodes the same payload.  Returns ``(decoded
        tree, bits)``, the bits structural and counted once (a broadcast
        sends each byte once per link, not per subscriber), summed in f32
        leaf by leaf.  A decoded leaf is the receiver's own buffer: where
        a codec's decode hands back its input (``Identity``) it is
        copied, so the sender's later in-place updates never reach it."""
        out = {}
        bits = f32_bits()
        for i, (k, leaf) in enumerate(tree.items()):
            payload, meta = q.encode(LeafNoise(noise, i).worker(None), leaf)
            bits = bits + f32_bits(q.wire_bits(payload))
            d = q.decode(payload, meta, ShapeDtype.of(leaf))
            same = (d.untyped_storage().data_ptr()
                    == leaf.untyped_storage().data_ptr())
            out[k] = d.clone() if same else d
        return out, bits

    def all_to_all(self, q, rand, x: torch.Tensor, minus=()):
        """The forwarded-payload transport of the moe and act wires:
        encode ``x`` with codec ``q`` and the draws ``rand``, and return
        the receiver's decode.  The receiver sees only the payload, so a
        codec that keeps decoder state in ``meta`` is rejected
        (``encode_meta_free``), as on the ring's hops.  The wire, not
        the channel, accounts the bits (``comm.transport``).  With
        ``minus`` (tensors shaped as ``x``) it returns ``(decoded,
        [decoded - t for t in minus])``, each difference with the decode
        fused in, ``decode_add(payload, -t)``: one fma for
        ``Int8Stochastic``, as XLA contracts the reference's."""
        payload = encode_meta_free(q, rand, x)
        like = ShapeDtype.of(x)
        decoded = q.decode(payload, {}, like)
        if not minus:
            return decoded
        return decoded, [q.decode_add(payload, {}, -t, like) for t in minus]

    def reduce(self, noise, wtree: Tree) -> Dict[str, WorkerMean]:
        """Master-side aggregation: the worker mean of each leaf, as a
        ``WorkerMean`` (what the rules' ``apply`` consumes)."""
        raise NotImplementedError

    def reduce_mean(self, noise, wtree: Tree) -> Tree:
        """``reduce``, each mean materialized."""
        return {k: m.value() for k, m in self.reduce(noise, wtree).items()}

    def push_mean(self, q, noise, wtree: Tree):
        """One uplink round: ``(messages, mean over workers, wire bits)``."""
        m, bits = self.uplink(q, noise, wtree)
        return m, self.reduce_mean(noise, m), bits

    def shift_round(self, rule, q, noise, wgrads, h, h_bar):
        """One shift-rule round: the rule's whole-tree message, its aux
        draw, ONE aggregation of the message tree, then ``apply``.
        Returns ``(g_bar, h_new, h_bar_new, bits)``."""
        with span("round/message"):
            m, bits = rule.message(q, noise, wgrads, h)
            aux, extra = rule.aux(noise, wgrads, h)
        with span("round/aggregate"):
            m_bar = self.reduce(noise, m)
        with span("round/apply"):
            g_bar, h_new, hb_new = rule.apply(wgrads, m, m_bar, h, h_bar,
                                              aux)
        return g_bar, h_new, hb_new, bits + extra

    def fused_round(self, rule, q, noise, msgs, h, h_bar):
        """``shift_round`` for messages the backward pass already emitted
        (``comm.fused_vjp``): its aux draw, one aggregation and ``apply``,
        the messages standing in for the dense gradients a fusible rule
        never reads.  The bits are each leaf's structural
        ``message_bits_aot``, added in ``rule.message``'s leaf order.
        Returns ``(g_bar, h_new, h_bar_new, bits)``."""
        from repro_torch.comm.fused_vjp import check_fusible

        check_fusible(rule)
        with span("round/message"):
            bits = f32_bits()
            for leaf in msgs.values():
                bits = bits + f32_bits(rule.message_bits_aot(q, leaf))
            aux, extra = rule.aux(noise, msgs, h)
        with span("round/aggregate"):
            m_bar = self.reduce(noise, msgs)
        with span("round/apply"):
            g_bar, h_new, hb_new = rule.apply(msgs, msgs, m_bar, h, h_bar,
                                              aux)
        return g_bar, h_new, hb_new, bits + extra


@dataclass(frozen=True, eq=False)
class SimChannel(Channel):
    """Parameter server: the master sees every decoded message exactly,
    so aggregation is the exact mean over the worker axis."""

    def reduce(self, noise, wtree):
        return {k: WorkerMean.of_rows(a) for k, a in wtree.items()}


@dataclass(frozen=True, eq=False)
class MeshChannel(Channel):
    """Production channel on a ``HostMesh``; ``mode`` picks the
    aggregation wire format, ``randk_q`` the keep fraction of
    ``randk_shared``, ``wspecs`` the worker-stacked specs of the ring
    modes (``{path: spec}``, ``dist.sharding``), ``q8_block_rows`` the
    fused q8 codec's scale block (None = the kernel default)."""

    mode: str = "dense"
    mesh: Any = None
    randk_q: float = 0.05
    wspecs: Any = None
    q8_block_rows: Optional[int] = None

    def __post_init__(self):
        _check_mode(self.mode)
        if self.mode not in AGGREGATION_MODES:
            raise ValueError(f"{self.mode!r} is not an aggregation mode; "
                             f"have {AGGREGATION_MODES}")

    def reduce(self, noise, wtree, leaf_indices=None):
        """``leaf_indices``: the leaves' global tree positions, which the
        aggregation's draws are bound to (default: their places in
        ``wtree``); the channel's specs of those leaves go with them."""
        if self.mode == "dense":
            return {k: WorkerMean.of_rows(a) for k, a in wtree.items()}
        wspecs = (None if self.wspecs is None
                  else {k: self.wspecs[k] for k in wtree})
        means = compressed_tree_mean(wtree, self.mode, noise, self.mesh,
                                     randk_q=self.randk_q, wspecs=wspecs,
                                     q8_block_rows=self.q8_block_rows,
                                     leaf_indices=leaf_indices)
        return {k: WorkerMean(value=v) for k, v in means.items()}


def aggregation_mode_of(mode_or_cfg) -> str:
    """Normalize a comm-mode string / CompressionConfig to an aggregation
    format: disabled configs and the ``ef21``/``efbv`` modes aggregate
    densely; the overlap and fused-VJP modes aggregate in the
    ``q8_ring_fused`` format."""
    if hasattr(mode_or_cfg, "aggregation_mode"):  # CompressionConfig
        return mode_or_cfg.aggregation_mode
    if mode_or_cfg in ("ef21", "efbv"):
        return "dense"
    if mode_or_cfg in OVERLAP_MODES + FUSED_VJP_MODES:
        return "q8_ring_fused"
    return mode_or_cfg


def make_channel(mode_or_cfg="dense", mesh=None, *, randk_q: float = 0.05,
                 wspecs=None, bucket_bytes: Optional[int] = None,
                 q8_block_rows: Optional[int] = None) -> Channel:
    """Build a Channel from a comm-mode string or a CompressionConfig
    (whose ``randk_q`` sets ``randk_shared``'s keep fraction in place of
    the argument, ``q8_block_rows`` the fused ring's scale block and
    ``overlap_bucket_bytes`` the overlap runtime's bucket budget, where
    the arguments do not set them), over ``mesh`` (a ``HostMesh``; the
    ring modes need one), with ``wspecs`` the ring's worker-stacked specs
    (``dist.sharding``) and ``q8_block_rows`` the fused codec's scale
    block (None: the kernel default).  The overlap
    modes build the bucketed ``AsyncChannel`` (``bucket_bytes`` its
    per-bucket budget in uncompressed per-worker message bytes, rejected
    for every other mode); ``q8_ring_fused_vjp`` the same channel with
    one bucket per leaf.  A disabled config aggregates densely, even with
    ``comm_mode="auto"``; ``auto`` otherwise raises (resolve it first,
    ``repro_torch.tune``), and so do unknown modes, naming every accepted
    one."""
    comm_mode = getattr(mode_or_cfg, "comm_mode", mode_or_cfg)
    if not getattr(mode_or_cfg, "enabled", True):
        comm_mode = "dense"
    _check_mode(comm_mode)
    overlap = comm_mode in OVERLAP_MODES + FUSED_VJP_MODES
    if bucket_bytes is not None and not overlap:
        raise ValueError(
            f"bucket_bytes only applies to the overlap channels "
            f"{OVERLAP_MODES + FUSED_VJP_MODES}, not {comm_mode!r} (it "
            f"would be silently ignored)"
        )
    if comm_mode == "sim":
        return SimChannel()
    if hasattr(mode_or_cfg, "comm_mode"):
        randk_q = mode_or_cfg.randk_q
        if bucket_bytes is None:
            bucket_bytes = getattr(mode_or_cfg, "overlap_bucket_bytes", None)
        if q8_block_rows is None:
            q8_block_rows = getattr(mode_or_cfg, "q8_block_rows", None)
    kw = dict(mode=aggregation_mode_of(mode_or_cfg), mesh=mesh,
              randk_q=randk_q, wspecs=wspecs, q8_block_rows=q8_block_rows)
    if not overlap:
        return MeshChannel(**kw)
    from repro_torch.comm.overlap import DEFAULT_BUCKET_BYTES, AsyncChannel

    if bucket_bytes is None:
        bucket_bytes = DEFAULT_BUCKET_BYTES
    return AsyncChannel(**kw, bucket_bytes=bucket_bytes,
                        per_leaf=comm_mode in FUSED_VJP_MODES)


def resync_h_bar(h: Optional[Tree], h_bar: Optional[Tree], step: int,
                 every: int) -> Optional[Tree]:
    """Every ``every`` rounds (on steps with ``step % every == every - 1``)
    replace ``h_bar`` with the dense mean of the current shifts; a no-op
    for ``every <= 0`` and stateless rules."""
    if every <= 0 or h is None or h_bar is None:
        return h_bar
    if step % every != every - 1:
        return h_bar
    return dense_mean(h)


def collective_payload_scale(cfg, d_nominal: int = 1_000_000) -> dict:
    """Per-collective-kind wire fraction for the step cost pass's payload
    model (the reference's, for the same reason).

    Only aggregation formats whose collective is DENSE while the protocol
    payload is compressed need a scale.  The q8 ring's int8 payloads and
    the shared-pattern Rand-K's K-sized values are counted at their true
    wire size already (scale 1).  EF21 and EF-BV aggregate an exact mean
    of DECODED messages, so their all-reduce is full width while the wire
    carries the contractive codec's payload: scale by that codec's wire
    fraction, derived structurally (``aot_wire_bits``).  Apply it to the
    GRADIENT-MESSAGE share only
    (``launch.hlo_cost.apply_gradient_payload_model``).
    """
    if not getattr(cfg, "enabled", True):
        return {}
    if getattr(cfg, "comm_mode", "dense") in ("ef21", "efbv"):
        from repro_torch.core.compressors import aot_wire_bits, make_compressor

        q = make_compressor(cfg.compressor, **dict(cfg.compressor_kwargs))
        return {"all-reduce": aot_wire_bits(q, d_nominal) / (32.0 * d_nominal)}
    return {}
