"""Tree-mean collectives -- the "send m_i to master, average" line of
Algorithm 1, in the wire formats the port runs (the reference's
``repro/dist/collectives.py``):

  ``dense_mean``         exact f32 mean over the worker axis, in XLA's
                         order (``_local_sum``).
  ``q8_ring_tree_mean``  ring all-reduce (reduce-scatter + all-gather)
                         over the mesh's ``data`` axis whose hops forward
                         encoded payloads: ``Int8Stochastic``'s through
                         the generic ring (``_ring_allreduce_coded``),
                         ``FusedQ8``'s through the chunk-fused ring
                         (``_ring_allreduce_fused``), whose send side is
                         the ``q8_quantize_chunk_3d`` kernel and whose
                         receive side is ``q8_dequant_add_2d`` with an
                         accumulator.

``compressed_tree_mean`` dispatches between them from an aggregation
mode; ``comm.channel.MeshChannel`` (and so the overlap runtime's
``AsyncChannel``, bucket by bucket) is the one caller.

The mesh is a ``launch.mesh.HostMesh``: every position of the ``data``
axis runs in this process, on one device, with its own ring buffer, and
a hop (``_hop``) hands each position's payload to position ``(p + 1) %
n`` -- the one function a transport across devices replaces.  The
arithmetic is the reference's, bit for bit where the tests say so; the
ring's uniforms come from the round's noise source (``comm.wire``: leaf
by leaf, then hop by hop, one draw per hop shared by every position).

Not here yet: the ``pod`` tree stage and ``wspecs`` (inner-dim model
sharding) raise ``NotImplementedError``, as does the shared-pattern
Rand-K mean (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import math
import struct
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.comm.wire import encode_meta_free
from repro_torch.core.compressors import Int8Stochastic, ShapeDtype
from repro_torch.kernels.q8ring.kernel import (
    LANE,
    q8_dequant_add_2d,
    q8_quantize_chunk_3d,
)
from repro_torch.kernels.q8ring.ops import FusedQ8, q8_dequant, ring_chunk_layout

Tree = Dict[str, torch.Tensor]

#: where each part of the reference's collectives not ported yet comes in
_ITEM = "ROADMAP queue 1, item 5 (collectives)"

#: aggregation formats of the reference's MeshChannel (ef21/efbv and
#: disabled configs map to dense, the overlap modes to q8_ring_fused)
AGGREGATION_MODES = ("dense", "randk_shared", "q8_ring", "q8_ring_fused")


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


class WorkerMean:
    """The mean of W-stacked rows over the worker axis, as the
    reference's jitted round consumes it.

    A dense mean is kept as its f32 sum (``total``, XLA's order:
    ``_local_sum``) and W.  Under jit XLA folds the mean's scale f32(1/W)
    into the op that consumes it: ``c * mean`` becomes the sum times the
    constant f32(c) * f32(1/W), and ``base + c * mean`` one fma of the sum
    with that constant.  A mean that arrives materialized (the rings')
    is kept as ``value``, and ``base + c * mean`` is one fma of it."""

    def __init__(self, total: Optional[torch.Tensor] = None, w: int = 1,
                 value: Optional[torch.Tensor] = None, dtype=torch.float32):
        self.total, self.w, self._value, self.dtype = total, w, value, dtype

    @classmethod
    def of_rows(cls, rows: torch.Tensor) -> "WorkerMean":
        return cls(_local_sum(rows), rows.shape[0], dtype=rows.dtype)

    def _coef(self, c: float) -> float:
        return _f32(_f32(c) * _f32(1.0 / self.w))

    def _folds(self) -> bool:
        return self._value is None and self.dtype == torch.float32

    def value(self) -> torch.Tensor:
        """The mean itself: ``sum * f32(1/W)``, in the rows' dtype."""
        if self._value is None:
            self._value = _mean_of_sum(self.total.clone(), self.w, self.dtype)
        return self._value

    def scaled(self, c: float) -> torch.Tensor:
        """``c * mean``."""
        if self._folds():
            return self.total * self._coef(c)
        return self.value() * c

    def axpy(self, base: torch.Tensor, c: float = 1.0) -> torch.Tensor:
        """``base + c * mean``, rounded once."""
        if self._folds():
            return torch.add(base, self.total, alpha=self._coef(c))
        return torch.add(base, self.value(), alpha=c)

    def axpy_(self, base: torch.Tensor, c: float = 1.0) -> torch.Tensor:
        """``axpy`` into ``base``, in place."""
        if self._folds():
            return base.add_(self.total, alpha=self._coef(c))
        return base.add_(self.value(), alpha=c)


def dense_mean(wtree: Tree) -> Tree:
    """Exact mean over the leading worker axis, leaf-wise, bit for bit
    the reference's ``jnp.mean(a, axis=0)`` as XLA computes it (see
    ``_local_sum`` and ``_mean_of_sum``)."""
    return {k: _mean_of_sum(_local_sum(a), a.shape[0], a.dtype)
            for k, a in wtree.items()}


def _leaf_indices(leaves, leaf_indices) -> tuple:
    """Normalize/validate the global leaf positions of the ring draws."""
    if leaf_indices is None:
        return tuple(range(len(leaves)))
    if len(leaf_indices) != len(leaves):
        raise ValueError(
            f"leaf_indices has {len(leaf_indices)} entries for "
            f"{len(leaves)} leaves"
        )
    return tuple(int(i) for i in leaf_indices)


def _hop_rand(noise, leaf: int, hop: int) -> Callable:
    """``rand(shape)`` of one ring hop, shared by every position: the
    reference's hop key is the same at every position, so the hop's
    uniforms are drawn once, at the first call (each of the ring's
    codecs draws once per encode)."""
    drawn: List[torch.Tensor] = []

    def rand(shape):
        if not drawn:
            drawn.append(noise.ring_uniform(leaf, hop, tuple(shape)))
        if tuple(drawn[0].shape) != tuple(shape):
            raise ValueError(f"hop {hop} drew {tuple(drawn[0].shape)}, "
                             f"asked for {tuple(shape)}")
        return drawn[0]

    return rand


def _hop(payloads: list) -> list:
    """One hop on the emulated axis: position p receives the payload of
    position p - 1 (the reference's ``ppermute`` to ``(j + 1) % n``)."""
    return payloads[-1:] + payloads[:-1]


def _ring_schedule(noise, leaf: int, chunks: torch.Tensor, n: int, *,
                   encode_send, decode_add, decode) -> torch.Tensor:
    """THE ring all-reduce schedule, in one place.

    ``chunks`` is (n positions, n chunks, ...): position p's ring buffer
    is ``chunks[p]``, reduced in place.  Each hop's encodes draw from
    ``noise`` for leaf ``leaf`` (``_hop_rand``).  Both ring variants
    drive this same hop and ownership arithmetic through three hooks:

      ``encode_send(rand, buf, chunk_id)``  encode chunk ``chunk_id`` of
            one position's buffer into a forwardable payload.
      ``decode_add(payload, mine)``         dequantize + accumulate into
            the receiving position's chunk.
      ``decode(payload)``                   dequantize one chunk.

    Reduce-scatter: at hop t position p sends chunk ``(p - t) % n`` and
    accumulates what it receives into chunk ``(send_id - 1) % n``; after
    n-1 hops position p owns the fully reduced chunk ``(p + 1) % n``.
    All-gather: each owner's chunk is encoded ONCE (hop n-1) and the
    payload forwarded verbatim, so every position decodes the same bits
    -- the port decodes each owner's payload once and every position
    shares the result.  Returns the reduced (n chunks, ...) tensor.
    """
    for t in range(n - 1):
        rand = _hop_rand(noise, leaf, t)
        sent = [encode_send(rand, chunks[p], (p - t) % n) for p in range(n)]
        for p, payload in enumerate(_hop(sent)):
            recv_id = (p - t - 1) % n
            chunks[p, recv_id] = decode_add(payload, chunks[p, recv_id])
    rand = _hop_rand(noise, leaf, n - 1)
    final = torch.empty_like(chunks[0])
    for p in range(n):
        own_id = (p + 1) % n
        final[own_id] = decode(encode_send(rand, chunks[p], own_id))
    return final


#: XLA's CPU reduce adds at most this many rows one after another
_XLA_WINDOW = 32


def _local_sum(rows: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out`` (allocated when None) = the f32 sum of ``rows`` over the
    leading axis in the order of XLA's CPU reduce in the reference:
    up to 32 rows one after another; a longer axis zero-padded to a
    multiple of 32, the smaller half of the padding in front, cut into
    windows of 32 rows each summed in order, and the window sums summed
    the same way.  (``torch.sum`` may pair rows otherwise.)"""
    if out is None:
        out = torch.empty(rows.shape[1:], dtype=torch.float32,
                          device=rows.device)
    w = rows.shape[0]
    if w > _XLA_WINDOW:
        n = -(-w // _XLA_WINDOW)
        front = (n * _XLA_WINDOW - w) // 2
        sums = torch.empty((n, *rows.shape[1:]), dtype=torch.float32,
                           device=rows.device)
        for i in range(n):
            lo = max(i * _XLA_WINDOW - front, 0)
            _local_sum(rows[lo:(i + 1) * _XLA_WINDOW - front], sums[i])
        return _local_sum(sums, out)
    out.copy_(rows[0])
    for r in rows[1:]:
        out += r
    return out


def _mean_of_sum(acc: torch.Tensor, w: int, dtype) -> torch.Tensor:
    """``acc * f32(1/w)`` in ``dtype``: XLA's form of a mean, whose
    division by a constant is a multiply by its f32 reciprocal.  Scales
    the f32 sum ``acc`` in place."""
    return acc.mul_(torch.tensor(1.0 / w, dtype=torch.float32)).to(dtype)


def _ring_buffers(x: torch.Tensor, n: int, chunk_shape) -> torch.Tensor:
    """(n positions, n chunks, *chunk_shape) f32: position p's buffer
    holds the f32 sum of its W/n worker rows of ``x`` (the reference's
    per-device local sum), flattened, zero-padded and cut into n chunks."""
    k = x.shape[0] // n
    d = x[0].numel()
    buf = torch.zeros((n, n * math.prod(chunk_shape)), dtype=torch.float32,
                      device=x.device)
    for p in range(n):
        _local_sum(x[p * k:(p + 1) * k].reshape(k, d), buf[p, :d])
    return buf.reshape(n, n, *chunk_shape)


def _ring_allreduce_coded(noise, leaf: int, x: torch.Tensor, n: int,
                          codec) -> torch.Tensor:
    """Ring all-reduce (sum over positions) of ``x``'s worker rows,
    forwarding the CODEC'S ENCODED PAYLOAD on every hop; any meta-free
    codec.  Chunks are (1, c), c = ceil(d / n), as the reference's."""
    d = x[0].numel()
    c = -(-d // n)
    chunks = _ring_buffers(x, n, (1, c))
    like = ShapeDtype((1, c), torch.float32, x.device)
    final = _ring_schedule(
        noise, leaf, chunks, n,
        encode_send=lambda rand, buf, cid: encode_meta_free(codec, rand,
                                                            buf[cid]),
        decode_add=lambda p, mine: codec.decode_add(p, {}, mine, like),
        decode=lambda p: codec.decode(p, {}, like),
    )
    return final.reshape(-1)[:d].reshape(x.shape[1:])


def _ring_allreduce_fused(noise, leaf: int, x: torch.Tensor, n: int,
                          codec: FusedQ8) -> torch.Tensor:
    """Ring all-reduce with the fused q8 hop kernels: the send side is
    ONE ``q8_quantize_chunk_3d`` launch that reads the rotating chunk in
    place (no f32 chunk copy), the receive side one accumulating
    ``q8_dequant_add_2d``.  Chunks are (rows_c, 128) lane blocks on the
    codec's tile grid (``ring_chunk_layout``).  The chunk ids live on the
    device (an ``arange(n)``; a hop passes a one-element view), so no
    launch pays a host-to-device copy."""
    d = x[0].numel()
    rows_c, block = ring_chunk_layout(d, n, codec.block_rows)
    chunks = _ring_buffers(x, n, (rows_c, LANE))
    ids = torch.arange(n, dtype=torch.int32, device=x.device)

    def encode_send(rand, buf, cid):
        return q8_quantize_chunk_3d(buf, rand((rows_c, LANE)),
                                    ids[cid:cid + 1], block_rows=block)

    def decode_add(payload, mine):
        q, s = payload
        return q8_dequant_add_2d(q, s, mine, block_rows=block)

    def decode(payload):
        q, s = payload
        return q8_dequant(q, s, block=block)

    final = _ring_schedule(noise, leaf, chunks, n, encode_send=encode_send,
                           decode_add=decode_add, decode=decode)
    return final.reshape(-1)[:d].reshape(x.shape[1:])


def q8_ring_tree_mean(noise, tree: Tree, mesh, *,
                      codec=Int8Stochastic(),
                      leaf_indices: Optional[Sequence[int]] = None,
                      pod_axis: Optional[str] = None,
                      wspecs=None) -> Tree:
    """Quantized ring mean over a worker-stacked tree on a ``HostMesh``,
    with ``Int8Stochastic`` payloads by default.

    Leaves are ``(W, ...)``, W a multiple of the ``data`` axis size n;
    position p sums its worker rows ``[p W/n, (p+1) W/n)`` in f32, the
    positions ring-all-reduce their sums with encoded hops, and the
    result is divided by W.  One position returns its sum unreduced, as
    the reference's ring does at n == 1.  Codecs with ``fused_ring`` set
    (``FusedQ8``) run the kernel-fused hops.  ``leaf_indices`` pins each
    leaf's draws to its global tree position.  The division by W is the
    product with f32(1 / W), which is what XLA compiles the reference's
    ``acc / W`` to.
    """
    if pod_axis is not None:
        raise NotImplementedError(f"the pod tree stage is not ported yet: "
                                  f"{_ITEM}")
    if wspecs is not None:
        raise NotImplementedError(f"wspecs (inner-dim model sharding) is not "
                                  f"ported yet: {_ITEM}")
    n = mesh.data
    ring = (_ring_allreduce_fused if getattr(codec, "fused_ring", False)
            else _ring_allreduce_coded)
    idxs = _leaf_indices(list(tree), leaf_indices)
    out = {}
    for i, (k, x) in enumerate(tree.items()):
        w = x.shape[0]
        if w % n:
            raise ValueError(f"leaf {k!r}: {w} worker rows do not split over "
                             f"{n} ring positions")
        if not mesh.holds(x):
            raise ValueError(f"leaf {k!r} is on {x.device}, the mesh on "
                             f"{mesh.device}")
        acc = _local_sum(x) if n == 1 else ring(noise, idxs[i], x, n, codec)
        out[k] = _mean_of_sum(acc, w, x.dtype)
        del acc   # this leaf's sum is not held while the next one reduces
    return out


def compressed_tree_mean(wtree: Tree, mode: str, noise, mesh=None, *,
                         q8_block_rows: Optional[int] = None,
                         leaf_indices: Optional[Sequence[int]] = None
                         ) -> Tree:
    """Worker-mean of a stacked tree in the aggregation format ``mode``
    (one of ``AGGREGATION_MODES``; ``comm.channel.aggregation_mode_of``
    maps comm modes and configs to it).  ``q8_block_rows`` sets the fused
    codec's scale-block rows (None = the kernel default);
    ``leaf_indices`` the global tree positions the ring's draws are bound
    to (a bucket of the overlap runtime is a subtree)."""
    if mode == "dense":
        return dense_mean(wtree)
    if mode in ("q8_ring", "q8_ring_fused"):
        if mesh is None:
            raise ValueError(f"{mode} needs a mesh")
        if mode == "q8_ring_fused":
            codec = (FusedQ8() if q8_block_rows is None
                     else FusedQ8(block_rows=q8_block_rows))
        else:
            codec = Int8Stochastic()
        return q8_ring_tree_mean(noise, wtree, mesh, codec=codec,
                                 leaf_indices=leaf_indices)
    if mode == "randk_shared":
        raise NotImplementedError(f"randk_shared is not ported yet: {_ITEM}")
    raise ValueError(f"unknown aggregation mode {mode!r}; have "
                     f"{AGGREGATION_MODES}")
