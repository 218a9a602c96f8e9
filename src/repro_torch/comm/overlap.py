"""Overlapped communication runtime: the bucketed, pipelined Channel --
the port of the reference's ``repro/comm/overlap.py``.

``plan_buckets`` cuts a worker-stacked tree into byte-budget buckets in
REVERSE-layer order (gradients arrive last layer first), whole leaves
only: cutting a leaf would move the q8 tiles and change the wire
format.  ``AsyncChannel`` aggregates bucket by bucket through explicit
``reduce_start`` / ``finish`` handles; its rounds (``shift_round``,
``fused_round``, ``push_mean``) issue bucket i's reduction right after
bucket i's messages and before bucket i+1's.

On a CUDA device the handles are real: a bucket's reduction runs on a
side stream of the channel, after the messages it reads are ready on
the caller's stream, and records an event; ``Handle.wait`` (and so
``finish``) makes the caller's stream wait on it.  Every tensor that
crosses the two streams is ``record_stream``-ed to the stream that did
not allocate it, so the caching allocator never hands its memory out
while the other stream may still use it.  On the CPU a handle is done
when it is returned.

THE CONTRACT: drained, ``AsyncChannel`` is bitwise ``MeshChannel`` in
the same aggregation mode, in any bucket partition and finish order:
each leaf's draws are bound to its GLOBAL tree position (the messages'
by ``LeafNoise``, the ring's by ``leaf_indices``), and the round's noise
source gives the same draws in any order of the calls
(``comm.wire.AddressedNoise``).  The dense mode's means are
``WorkerMean.of_rows`` and the ring's materialized, as
``MeshChannel.reduce`` gives them.  The bits are added in bucket order,
as the reference's are: above 2^24 that may differ from the leaf-order
sum in the last bit of the f32 counter.

The channel's ``wspecs`` (worker-stacked specs, ``dist.sharding``) are
keyed by path, so each bucket's reduction takes the specs of its own
leaves (``MeshChannel.reduce``).  With an ``obs`` recorder attached
(``obs.trace.StampRecorder``) the explicit ``reduce_start`` / ``finish``
calls stamp their call windows, which ``tune.measure.measure_overlap_hide``
reads; a stamp reads the host clock around the call and nothing else, so
the round is bitwise the round without it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm.channel import MeshChannel, Tree
from repro_torch.comm.wire import LeafNoise, encode_decode_workers
from repro_torch.core.compressors import f32_bits
from repro_torch.dist.collectives import WorkerMean

#: default per-bucket budget in UNCOMPRESSED per-worker message bytes
#: (inner numel x dtype width): 4 MiB, the reference's
DEFAULT_BUCKET_BYTES = 4 << 20


@dataclass(frozen=True)
class Bucket:
    """One pipeline unit: GLOBAL leaf positions (reverse-layer order)
    and the per-worker message bytes they carry."""

    indices: Tuple[int, ...]
    nbytes: int


@dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    n_leaves: int

    def __len__(self) -> int:
        return len(self.buckets)


def plan_buckets(wtree, bucket_bytes: int = DEFAULT_BUCKET_BYTES, *,
                 per_leaf: bool = False) -> BucketPlan:
    """Cut a worker-stacked tree (tensors or ``ShapeDtype`` leaves) into
    reverse-layer buckets: walk the leaves LAST first, adding each
    leaf's per-worker bytes, and close a bucket when the next leaf would
    overflow ``bucket_bytes``; a leaf above the budget gets a bucket of
    its own.  ``per_leaf=True`` ignores the budget: one bucket per leaf
    (the fused-VJP schedule)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    leaves = list(wtree.values())
    buckets = []
    cur, cur_bytes = [], 0
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        b = math.prod(leaf.shape[1:]) * leaf.dtype.itemsize
        if per_leaf:
            buckets.append(Bucket((i,), b))
            continue
        if cur and cur_bytes + b > bucket_bytes:
            buckets.append(Bucket(tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        buckets.append(Bucket(tuple(cur), cur_bytes))
    return BucketPlan(tuple(buckets), len(leaves))


class Handle(NamedTuple):
    """An issued bucket reduction: its leaves' means (``WorkerMean``, in
    ``bucket.indices`` order) and, on a CUDA device, the side stream's
    event that marks them done (None: done already)."""

    bucket: Bucket
    values: Tuple[WorkerMean, ...]
    event: Optional[Any] = None

    def wait(self) -> Tuple[WorkerMean, ...]:
        """The bucket's means, the current stream made to wait for them."""
        if self.event is not None:
            torch.cuda.current_stream().wait_event(self.event)
        return self.values


class Inflight(NamedTuple):
    """Everything ``reduce_start`` issued, for ``finish``; the handles
    may also be consumed one by one, in any order."""

    keys: Tuple[str, ...]
    handles: Tuple[Handle, ...]


def _tensor_of(mean: WorkerMean) -> torch.Tensor:
    """The tensor a ``WorkerMean`` holds: a dense mean's sum, or the
    ring's materialized mean."""
    return mean.total if mean.total is not None else mean.value()


@dataclass(frozen=True, eq=False)
class AsyncChannel(MeshChannel):
    """The bucketed overlap channel (module docstring): ``mode`` an
    aggregation format, ``bucket_bytes`` the per-bucket budget in
    uncompressed per-worker message bytes, ``per_leaf`` one bucket per
    leaf (the ``q8_ring_fused_vjp`` schedule); ``randk_q``, ``wspecs``
    and ``q8_block_rows`` as ``MeshChannel``'s."""

    mode: str = "q8_ring_fused"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    per_leaf: bool = False
    obs: Any = None        # optional StampRecorder (module docstring)
    _side: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        super().__post_init__()
        if self.bucket_bytes <= 0:
            raise ValueError(
                f"bucket_bytes must be positive, got {self.bucket_bytes}")

    def _plan(self, wtree) -> BucketPlan:
        return plan_buckets(wtree, self.bucket_bytes, per_leaf=self.per_leaf)

    def _side_stream(self, device) -> torch.cuda.Stream:
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def _reduce_bucket(self, noise, keys, leaves, bucket: Bucket) -> Handle:
        """Issue one bucket's reduction (the leaves at ``bucket.indices``,
        their aggregation draws bound to those global positions, their
        specs the channel's for them)."""
        sub = {keys[i]: leaves[i] for i in bucket.indices}
        device = leaves[bucket.indices[0]].device

        def reduce():
            return tuple(MeshChannel.reduce(
                self, noise, sub, leaf_indices=bucket.indices).values())

        if device.type != "cuda":
            return Handle(bucket, reduce())
        main, side = torch.cuda.current_stream(device), self._side_stream(
            device)
        side.wait_stream(main)          # the bucket's messages are ready
        with torch.cuda.stream(side):
            for t in sub.values():
                # the messages, and the payloads of marked ones
                # (``dist.collectives.with_payload_rows``), are read here
                for u in (t, *getattr(t, "payload_rows", ())):
                    u.record_stream(side)
            means = reduce()
            for m in means:
                _tensor_of(m).record_stream(main)
            done = torch.cuda.Event()
            done.record(side)
        return Handle(bucket, means, done)

    # -- explicit start/finish ---------------------------------------------

    def reduce_start(self, noise, wtree: Tree) -> Inflight:
        """Issue every bucket's aggregation; returns the handles without
        waiting for them.  With an ``obs`` recorder attached the call
        window is stamped ``"reduce_start"``."""
        if self.obs is not None:
            with self.obs.stamp("reduce_start"):
                return self._reduce_start(noise, wtree)
        return self._reduce_start(noise, wtree)

    def _reduce_start(self, noise, wtree: Tree) -> Inflight:
        keys, leaves = tuple(wtree), list(wtree.values())
        return Inflight(keys, tuple(
            self._reduce_bucket(noise, keys, leaves, b)
            for b in self._plan(wtree).buckets))

    def finish(self, inflight: Inflight) -> dict:
        """Wait for every handle and assemble ``{path: WorkerMean}``
        (the call window stamped ``"finish"`` when ``obs`` is
        attached)."""
        if self.obs is not None:
            with self.obs.stamp("finish"):
                return self._finish(inflight)
        return self._finish(inflight)

    def _finish(self, inflight: Inflight) -> dict:
        out: list = [None] * len(inflight.keys)
        seen = 0
        for h in inflight.handles:
            for i, m in zip(h.bucket.indices, h.wait()):
                out[i] = m
                seen += 1
        if seen != len(out) or any(o is None for o in out):
            raise ValueError(
                f"finish: handles cover {seen} of {len(out)} leaves")
        return dict(zip(inflight.keys, out))

    # -- the Channel interface -----------------------------------------------

    def reduce(self, noise, wtree: Tree):
        """The synchronous drain: start everything, finish everything."""
        return self.finish(self.reduce_start(noise, wtree))

    def shift_round(self, rule, q, noise, wgrads, h, h_bar):
        """The overlapped shift-rule round: bucket i's messages
        (``rule.message_leaf``, each leaf's draws bound to its global
        position), then bucket i's reduction issued, before bucket i+1's
        messages; then the aux draw and ``apply``.  Scheduling only:
        bitwise ``Channel.shift_round`` but for the bits' order."""
        keys, g = tuple(wgrads), list(wgrads.values())
        msgs: list = [None] * len(g)
        handles = []
        bits = f32_bits()
        for b in self._plan(wgrads).buckets:
            for i in b.indices:
                msgs[i], bl = rule.message_leaf(
                    q, LeafNoise(noise, i), g[i],
                    None if h is None else h[keys[i]])
                bits = bits + f32_bits(bl)
            handles.append(self._reduce_bucket(noise, keys, msgs, b))
        m = dict(zip(keys, msgs))
        aux, extra = rule.aux(noise, wgrads, h)
        m_bar = self._finish(Inflight(keys, tuple(handles)))
        g_bar, h_new, hb_new = rule.apply(wgrads, m, m_bar, h, h_bar, aux)
        return g_bar, h_new, hb_new, bits + extra

    def fused_round(self, rule, q, noise, msgs, h, h_bar):
        """``shift_round`` for messages the backward pass already emitted
        (``comm.fused_vjp``): only the bucket-by-bucket reductions, the
        structural bits added in the same bucket order, the aux draw and
        ``apply``.  Bitwise ``shift_round`` on the same round."""
        from repro_torch.comm.fused_vjp import check_fusible

        check_fusible(rule)
        keys, leaves = tuple(msgs), list(msgs.values())
        handles = []
        bits = f32_bits()
        for b in self._plan(msgs).buckets:
            for i in b.indices:
                bits = bits + f32_bits(rule.message_bits_aot(q, leaves[i]))
            handles.append(self._reduce_bucket(noise, keys, leaves, b))
        m_bar = self._finish(Inflight(keys, tuple(handles)))
        aux, extra = rule.aux(noise, msgs, h)
        g_bar, h_new, hb_new = rule.apply(msgs, msgs, m_bar, h, h_bar, aux)
        return g_bar, h_new, hb_new, bits + extra

    def push_mean(self, q, noise, wtree: Tree):
        """The overlapped uplink round: each bucket's reduction issued
        right after its encodes and before the next bucket's.  Returns
        ``(messages, mean over workers, wire bits)``, the bits added in
        leaf order (the reference's ``push_mean`` order)."""
        keys, leaves = tuple(wtree), list(wtree.values())
        msgs: list = [None] * len(leaves)
        leaf_bits: list = [None] * len(leaves)
        handles = []
        for b in self._plan(wtree).buckets:
            for i in b.indices:
                payloads, msgs[i] = encode_decode_workers(
                    q, LeafNoise(noise, i), leaves[i])
                leaf_bits[i] = q.wire_bits(payloads)
            handles.append(self._reduce_bucket(noise, keys, msgs, b))
        bits = f32_bits()
        for bl in leaf_bits:
            bits = bits + f32_bits(bl)
        means = self._finish(Inflight(keys, tuple(handles)))
        return (dict(zip(keys, msgs)),
                {k: m.value() for k, m in means.items()}, bits)
