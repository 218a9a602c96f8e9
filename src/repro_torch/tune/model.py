"""The step-time predictor: structural wire accounting x alpha-beta link
-- the port of the reference's ``repro/tune/model.py``.

One candidate plan's predicted step time combines three structural
sources, with no hand-written byte formulas:

  * the COMPUTE half: a cost analysis's flops / bytes of the step (the
    reference lowers its step for it; the port's counterpart comes with
    the dry-run) divided by device rates -- None contributes zero;
  * the WIRE half: each comm mode's per-round payload, computed ahead of
    time from the mode's own codec through ``Compressor.payload_like``
    (the codec's encode run on meta tensors, the same encode the live
    uplink runs: the counterpart of the reference's ``jax.eval_shape``
    of ``encode_workers``);
  * the LAUNCH half: collective launches counted from the overlap
    bucketer's actual ``plan_buckets`` output (one per bucket), so the
    bucket-size grid trades per-launch alpha against overlap coverage.

Comm cost is the classic ring all-reduce bound over the worker count n:

    t_comm = 2 (n-1) * (n_buckets * alpha  +  (S / n) * beta)

with S the per-worker payload bytes of the mode's wire codec.  The
``ef21``/``efbv`` modes aggregate densely but their PROTOCOL payload is
the contractive message -- the predictor charges the protocol wire.

Overlap modes hide comm under backward compute; the composition charges
only the un-hidden remainder (``OVERLAP_HIDE`` is the model's one free
constant, stated here rather than buried in a weight).

Compressed modes additionally pay a standalone ENCODE stage
(``encode_time_s``: a memory-bound pass over dense message + payload) --
except the backward-fused ``q8_ring_fused_vjp`` mode, whose encode runs
inside the backward pass and is therefore charged zero by construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.comm.channel import (
    CHANNEL_MODES,
    FUSED_VJP_MODES,
    OVERLAP_MODES,
)
from repro_torch.comm.overlap import DEFAULT_BUCKET_BYTES, plan_buckets
from repro_torch.comm.transport import (
    WIRE_CODEC_FLAGS,
    _aot_payload_bits,
    aggregation_wire_codec,
    wire_flag_codec,
)
from repro_torch.core.compressors import Identity, ShapeDtype
from repro_torch.tune.measure import DeviceRates, LinkModel

#: comm modes the tuner searches over — every channel mode except the
#: reference-only parameter server and ``auto``, the tuner's own mode
#: (not a candidate)
TUNABLE_MODES: Tuple[str, ...] = tuple(
    m for m in CHANNEL_MODES if m not in ("sim", "auto")
)

#: fraction of compute time the bucketed overlap runtime is modeled to
#: hide comm under (reverse-layer buckets overlap the backward pass; the
#: head of the tree cannot be hidden — it is produced last)
OVERLAP_HIDE = 0.75


@dataclass(frozen=True)
class Candidate:
    """One point of the search grid: a comm mode plus every codec /
    runtime knob the plan can set."""

    comm_mode: str
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    randk_q: float = 0.05
    q8_block_rows: int = 64
    efbv_eta: float = 1.0
    efbv_nu: float = 1.0
    compressor: str = "natural"
    compressor_kwargs: tuple = ()
    moe_wire: str = "none"
    act_wire: str = "none"
    model_wire: str = "none"

    def __post_init__(self):
        if self.comm_mode not in TUNABLE_MODES:
            raise ValueError(
                f"unknown tunable comm mode {self.comm_mode!r}; "
                f"have {TUNABLE_MODES}"
            )
        for flag in (self.moe_wire, self.act_wire, self.model_wire):
            if flag not in WIRE_CODEC_FLAGS:
                raise ValueError(
                    f"unknown wire codec flag {flag!r}; "
                    f"have {WIRE_CODEC_FLAGS}"
                )

    @property
    def overlap(self) -> bool:
        """Modes that run through the bucketed AsyncChannel (the fused
        mode is overlap-by-construction: each leaf's payload exists the
        moment its cotangent does)."""
        return self.comm_mode in OVERLAP_MODES + FUSED_VJP_MODES

    @property
    def fused(self) -> bool:
        """Backward-fused encode: per-leaf buckets, no standalone
        encode stage (``repro_torch.comm.fused_vjp``)."""
        return self.comm_mode in FUSED_VJP_MODES

    @property
    def label(self) -> str:
        knobs = []
        if self.comm_mode == "randk_shared":
            knobs.append(f"q={self.randk_q:g}")
        if self.comm_mode in ("q8_ring_fused",) + OVERLAP_MODES + \
                FUSED_VJP_MODES:
            knobs.append(f"block={self.q8_block_rows}")
        if self.fused:
            knobs.append("per-leaf")
        elif self.overlap:
            knobs.append(f"bucket={self.bucket_bytes >> 10}KiB")
        if self.comm_mode in ("efbv", "efbv_overlap"):
            knobs.append(f"eta={self.efbv_eta:g},nu={self.efbv_nu:g}")
        if self.moe_wire != "none":
            knobs.append(f"moe={self.moe_wire}")
        if self.act_wire != "none":
            knobs.append(f"act={self.act_wire}")
        if self.model_wire != "none":
            knobs.append(f"model={self.model_wire}")
        return self.comm_mode + (f"[{','.join(knobs)}]" if knobs else "")


def wire_codec(cand: Candidate):
    """The codec whose payload defines this mode's bytes-on-wire —
    the transport's ONE mode->codec map
    (``repro_torch.comm.transport.aggregation_wire_codec``), so the
    predictor and the live grad wire cannot drift."""
    return aggregation_wire_codec(cand)


def _meta(leaf) -> ShapeDtype:
    return ShapeDtype(tuple(leaf.shape), leaf.dtype, torch.device("meta"))


def predicted_wire_bits(cand: Candidate, wtree_like) -> float:
    """Total wire bits of one round's worker-stacked messages, ahead of
    time: each ``(W, ...)`` leaf of ``wtree_like`` (``{path: anything
    with .shape and .dtype}``) through the grad wire's own accounting
    (``payload_like`` of each worker's message, the codec's structural
    ``wire_bits``), so this number cannot drift from the wire protocol
    without the accounting tests catching it."""
    codec = wire_codec(cand)
    total = 0.0
    for leaf in wtree_like.values():
        total += _aot_payload_bits(codec, _meta(leaf), "allreduce")
    return total


@dataclass(frozen=True)
class StepPrediction:
    """One candidate's predicted timing decomposition."""

    step_s: float
    compute_s: float
    comm_s: float
    wire_bytes: float          # per-worker payload bytes per round
    n_buckets: int
    encode_s: float = 0.0      # standalone encode stage (0 when fused)
    candidate: Candidate = field(repr=False, default=None)


def compute_time_s(analysis: Optional[dict],
                   rates: Optional[DeviceRates]) -> float:
    """Compute half from a cost analysis dict (``flops`` / ``bytes`` of
    the step): roofline max of flops-bound and memory-bound time.
    ``None`` analysis (micro-bench ranking) contributes zero."""
    if analysis is None:
        return 0.0
    rates = rates or DeviceRates.nominal()
    flops_s = float(analysis.get("flops", 0.0)) / rates.flops_per_s
    mem_s = float(analysis.get("bytes", 0.0)) / rates.hbm_bytes_per_s
    return max(flops_s, mem_s)


def encode_time_s(cand: Candidate, wtree_like,
                  rates: Optional[DeviceRates]) -> float:
    """The STANDALONE encode stage: a memory-bound pass reading each
    dense per-worker message and writing its wire payload.

    ``dense`` has no encode; the fused-VJP modes emit payloads as
    cotangents inside the backward pass — the stage does not exist, so
    they are charged ZERO here (the whole point of the mode).  Every
    other compressed mode pays (dense bytes + payload bytes) / memory
    rate per round.
    """
    if cand.comm_mode in ("dense",) + FUSED_VJP_MODES or rates is None:
        return 0.0
    dense_bytes = sum(
        float(math.prod(leaf.shape)) * leaf.dtype.itemsize
        for leaf in wtree_like.values()
    )
    payload_bytes = predicted_wire_bits(cand, wtree_like) / 8.0
    return float((dense_bytes + payload_bytes) / rates.hbm_bytes_per_s)


def extra_wire_bits(cand: Candidate, wire_traffic) -> float:
    """Structural per-step bits of every registered NON-grad wire under
    this candidate's per-wire codec flags.

    ``wire_traffic`` is ``Transport.extra_traffic()``: ``{wire name:
    ((like, count), ...)}``.  A wire whose flag is ``"none"`` still moves
    its payload — uncompressed — so it is charged at identity width; the
    grid can therefore trade a codec's variance against the bytes it
    removes from the wire.  Same meta-free payload as ``Wire.send``.
    """
    if not wire_traffic:
        return 0.0
    total = 0.0
    for name, traffic in wire_traffic.items():
        flag = getattr(cand, f"{name}_wire", "none")
        codec = (Identity() if flag == "none"
                 else wire_flag_codec(flag, randk_q=cand.randk_q))
        cache = {}
        for like, count in traffic:
            sig = (tuple(like.shape), like.dtype)
            if sig not in cache:
                cache[sig] = _aot_payload_bits(codec, _meta(like), "p2p")
            total += count * cache[sig]
    return total


def comm_time_s(cand: Candidate, wtree_like, link: LinkModel,
                w: int, *, wire_traffic=None) -> Tuple[float, float, int]:
    """``(comm_s, per_worker_wire_bytes, n_buckets)`` for one candidate
    (the ring all-reduce bound in the module docstring).

    Registered non-grad wires (``wire_traffic``) add their bytes at one
    link traversal each — all-to-all / p2p payloads cross the bisection
    once, not 2(w-1) ring hops — so every wire the transport owns is
    charged, under the codec flags this candidate sets.
    """
    total_bits = predicted_wire_bits(cand, wtree_like)
    s_bytes = total_bits / 8.0 / max(w, 1)
    n_buckets = (
        len(plan_buckets(wtree_like, cand.bucket_bytes,
                         per_leaf=cand.fused))
        if cand.overlap else 1
    )
    hops = 2 * (w - 1)
    comm = hops * (n_buckets * link.alpha_s
                   + (s_bytes / max(w, 1)) * link.beta_s_per_byte)
    extra_bytes = extra_wire_bits(cand, wire_traffic) / 8.0 / max(w, 1)
    comm += extra_bytes * link.beta_s_per_byte
    s_bytes += extra_bytes
    return float(comm), float(s_bytes), int(n_buckets)


def compose_step_s(compute_s: float, comm_s: float, overlap: bool,
                   hide: Optional[float] = None) -> float:
    """Serial modes pay compute + comm; overlap modes pay only the comm
    that does not fit under a ``hide`` fraction of the compute.

    ``hide=None`` charges the nominal ``OVERLAP_HIDE`` constant; a
    MEASURED fraction (``repro_torch.tune.measure.measure_overlap_hide``)
    replaces it when one is at hand.
    """
    if overlap:
        h = OVERLAP_HIDE if hide is None else hide
        return compute_s + max(0.0, comm_s - h * compute_s)
    return compute_s + comm_s


def predict_step(cand: Candidate, wtree_like, link: LinkModel, w: int, *,
                 analysis: Optional[dict] = None,
                 rates: Optional[DeviceRates] = None,
                 wire_traffic=None,
                 hide: Optional[float] = None) -> StepPrediction:
    """The full prediction for one candidate (see module docstring).
    ``hide`` overrides the nominal overlap-hide constant (measured)."""
    compute_s = compute_time_s(analysis, rates)
    comm_s, s_bytes, n_buckets = comm_time_s(cand, wtree_like, link, w,
                                             wire_traffic=wire_traffic)
    # The standalone encode stage rides the compute half (it is device
    # work, not wire time); charged only when a compute analysis is in
    # play so codec-only micro-bench rankings stay pure wire orderings.
    encode_s = (encode_time_s(cand, wtree_like, rates)
                if analysis is not None else 0.0)
    return StepPrediction(
        step_s=compose_step_s(compute_s, comm_s, cand.overlap, hide)
        + encode_s,
        compute_s=compute_s,
        comm_s=comm_s,
        wire_bytes=s_bytes,
        n_buckets=n_buckets,
        encode_s=encode_s,
        candidate=cand,
    )
