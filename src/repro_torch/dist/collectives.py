"""Tree-mean collectives -- the "send m_i to master, average" line of
Algorithm 1, in the wire formats the port runs (the reference's
``repro/dist/collectives.py``):

  ``dense_mean``         exact f32 mean over the worker axis, in XLA's
                         order (``_local_sum``).
  ``randk_shared_mean``  correlated Rand-K: every worker encodes with
                         ``RandK(shared_pattern=True)`` and ONE pattern
                         per leaf, so the K-value payloads average
                         value-wise and decode once.
  ``q8_ring_tree_mean``  ring all-reduce (reduce-scatter + all-gather)
                         over the mesh's ``data`` axis whose hops forward
                         encoded payloads: ``Int8Stochastic``'s through
                         the generic ring (``_ring_allreduce_coded``),
                         ``FusedQ8``'s through the chunk-fused ring
                         (``_ring_allreduce_fused``), whose send side is
                         the ``q8_quantize_chunk_3d`` kernel and whose
                         receive side is ``q8_dequant_add_2d`` with an
                         accumulator; with worker-stacked specs
                         (``wspecs``) each ``model`` shard of a leaf runs
                         a ring of its own, and with a ``pod`` axis one
                         quantized tree stage sums the pods' rings.

``compressed_tree_mean`` dispatches between them from an aggregation
mode; ``comm.channel.MeshChannel`` (and so the overlap runtime's
``AsyncChannel``, bucket by bucket) is the one caller.

The mesh is a ``launch.mesh.HostMesh``: every position runs in this
process, on one device, with its own ring buffer, and a hop (``_hop``)
hands each position's payload to position ``(p + 1) % n`` of its ring
-- the one function a transport across devices replaces.  The arithmetic
is the reference's, bit for bit where the tests say so.  The draws come
from the round's noise source (``comm.wire``): the ring's leaf by leaf,
then hop by hop, one draw per hop shared by every position; then the
pod stage's one encode; Rand-K's pattern one permutation per leaf.  The
reference's ``shard_map`` hands every device the same key and folds in
only the leaf, the axis and the hop, so every pod and every model shard
of a leaf draws the SAME uniforms: ``_LeafDraws`` makes each draw once
and hands it to all of them.
"""

from __future__ import annotations

import math
import struct
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.comm.wire import encode_meta_free
from repro_torch.core.compressors import Int8Stochastic, RandK, ShapeDtype
from repro_torch.kernels.q8ring.kernel import (
    LANE,
    q8_dequant_add_2d,
    q8_quantize_chunk_3d,
)
from repro_torch.kernels.q8ring.ops import FusedQ8, q8_dequant, ring_chunk_layout
from repro_torch.kernels.q8ring.ref import fma_f32

Tree = Dict[str, torch.Tensor]

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
        return cls(_sum_rows(rows), rows.shape[0], dtype=rows.dtype)

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
    return {k: _mean_of_sum(_sum_rows(a), a.shape[0], a.dtype)
            for k, a in wtree.items()}


def with_payload_rows(rows: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Mark W-stacked f32 rows as the decodes ``q[j] * scale[j]`` of
    their payloads (``q`` (W, ...) int8, ``scale`` (W,) f32: the
    ``Int8Stochastic`` messages) and return them.  The reference's
    jitted round fuses that decode into the worker sum of up to 32 rows,
    one fma a worker (``_local_sum`` with per-row scales); the sums here
    read the mark (``_sum_rows``).  An op that makes new rows drops it;
    code that changes marked rows in place must drop it
    (``drop_payload_rows``)."""
    rows.payload_rows = (q, scale)
    return rows


def drop_payload_rows(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` without the mark of ``with_payload_rows``."""
    if hasattr(rows, "payload_rows"):
        del rows.payload_rows
    return rows


def _sum_rows(rows: torch.Tensor, lo: int = 0, hi: Optional[int] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 sum of rows ``[lo, hi)`` as the reference's jitted round
    takes it (``_local_sum``), flattened into ``out`` when given: over
    the payloads with their per-row scales for marked rows
    (``with_payload_rows``) when at most 32 rows are summed, where XLA
    fuses the decode into the sum; else over the rows themselves (XLA's
    windowed sum of more rows reads the rounded decodes)."""
    hi = rows.shape[0] if hi is None else hi
    parts = getattr(rows, "payload_rows", None)
    x, scale = rows[lo:hi], None
    if parts is not None and hi - lo <= _XLA_WINDOW:
        x, scale = parts[0][lo:hi], parts[1][lo:hi]
    if out is not None:
        x = x.reshape(hi - lo, -1)
    return _local_sum(x, out, scale)


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


class _LeafDraws:
    """The aggregation draws of one leaf, each made at its first call and
    handed to every later one: the ring's hops (``hop(t)``) and the pod
    stage's encode (``pod()``), shared by every position, every pod and
    every model shard of the leaf (the reference's ring and pod keys are
    the same on every device of its ``shard_map``).  Each of the ring's
    codecs draws once per encode, so a draw object returns its one draw
    and checks the shape asked for."""

    def __init__(self, noise, leaf: int):
        self.noise, self.leaf, self.drawn = noise, leaf, {}

    def _rand(self, name, make) -> Callable:
        def rand(shape):
            if name not in self.drawn:
                self.drawn[name] = make(tuple(shape))
            got = self.drawn[name]
            if tuple(got.shape) != tuple(shape):
                raise ValueError(f"leaf {self.leaf} {name} drew "
                                 f"{tuple(got.shape)}, asked for "
                                 f"{tuple(shape)}")
            return got

        return rand

    def hop(self, t: int) -> Callable:
        """``rand(shape)`` of ring hop ``t``."""
        return self._rand(("hop", t), lambda shape: self.noise.ring_uniform(
            self.leaf, t, shape))

    def pod(self) -> Callable:
        """``rand(shape)`` of the pod stage's encode."""
        return self._rand("pod", lambda shape: self.noise.pod_uniform(
            self.leaf, shape))


def _hop(payloads: list) -> list:
    """One hop on the emulated axis: position p receives the payload of
    position p - 1 (the reference's ``ppermute`` to ``(j + 1) % n``)."""
    return payloads[-1:] + payloads[:-1]


def _ring_schedule(draws: _LeafDraws, chunks: torch.Tensor, n: int, *,
                   encode_send, decode_add, decode) -> torch.Tensor:
    """THE ring all-reduce schedule, in one place.

    ``chunks`` is (n positions, n chunks, ...): position p's ring buffer
    is ``chunks[p]``, reduced in place.  Each hop's encodes draw from
    ``draws`` (the leaf's, ``_LeafDraws.hop``).  Both ring variants
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
        rand = draws.hop(t)
        sent = [encode_send(rand, chunks[p], (p - t) % n) for p in range(n)]
        for p, payload in enumerate(_hop(sent)):
            recv_id = (p - t - 1) % n
            chunks[p, recv_id] = decode_add(payload, chunks[p, recv_id])
    rand = draws.hop(n - 1)
    final = torch.empty_like(chunks[0])
    for p in range(n):
        own_id = (p + 1) % n
        final[own_id] = decode(encode_send(rand, chunks[p], own_id))
    return final


#: XLA's CPU reduce adds at most this many rows one after another
_XLA_WINDOW = 32


def _rows_marked(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x``, with their part of its payload mark."""
    parts = getattr(x, "payload_rows", None)
    if parts is None:
        return x[lo:hi]
    return with_payload_rows(x[lo:hi], parts[0][lo:hi], parts[1][lo:hi])


def _narrow_marked(x: torch.Tensor, dim: int, start: int, size: int
                   ) -> torch.Tensor:
    """A contiguous copy of ``x.narrow(dim, start, size)`` (``dim`` an
    inner dim), with the same slice of its payload mark."""
    out = x.narrow(dim, start, size).contiguous()
    parts = getattr(x, "payload_rows", None)
    if parts is None:
        return out
    return with_payload_rows(out, parts[0].narrow(dim, start, size),
                             parts[1])


def _local_sum(rows: torch.Tensor, out: Optional[torch.Tensor] = None,
               scale=None) -> torch.Tensor:
    """``out`` (allocated when None) = the f32 sum of ``rows`` over the
    leading axis in the order of XLA's CPU reduce in the reference:
    up to 32 rows one after another; a longer axis zero-padded to a
    multiple of 32, the smaller half of the padding in front, cut into
    windows of 32 rows each summed in order, and the window sums summed
    the same way.  (``torch.sum`` may pair rows otherwise.)  With
    ``scale`` the rows are ``rows * scale``, a product XLA fuses into
    the reduction: each row enters with one fma (``fma_f32``).
    ``scale`` is one float for every row (``randk_shared``'s d / K) or a
    (W,) f32 tensor, one per row (the payload scales of
    ``Int8Stochastic`` messages, ``_sum_rows``; at most 32 rows)."""
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
            _local_sum(rows[lo:(i + 1) * _XLA_WINDOW - front], sums[i], scale)
        return _local_sum(sums, out)
    if scale is None:
        out.copy_(rows[0])
        for r in rows[1:]:
            out += r
        return out
    c = (scale.to(torch.float32) if torch.is_tensor(scale) else
         torch.tensor(scale, dtype=torch.float32,
                      device=rows.device).expand(w))
    out.copy_(rows[0].to(torch.float32) * c[0])
    for r, cj in zip(rows[1:], c[1:]):
        out.copy_(fma_f32(r, cj, out))
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
        _sum_rows(x, p * k, (p + 1) * k, out=buf[p, :d])
    return buf.reshape(n, n, *chunk_shape)


def _ring_allreduce_coded(draws: _LeafDraws, x: torch.Tensor, n: int,
                          codec) -> torch.Tensor:
    """Ring all-reduce (sum over positions) of ``x``'s worker rows,
    forwarding the CODEC'S ENCODED PAYLOAD on every hop; any meta-free
    codec.  Chunks are (1, c), c = ceil(d / n), as the reference's."""
    d = x[0].numel()
    c = -(-d // n)
    chunks = _ring_buffers(x, n, (1, c))
    like = ShapeDtype((1, c), torch.float32, x.device)
    final = _ring_schedule(
        draws, chunks, n,
        encode_send=lambda rand, buf, cid: encode_meta_free(codec, rand,
                                                            buf[cid]),
        decode_add=lambda p, mine: codec.decode_add(p, {}, mine, like),
        decode=lambda p: codec.decode(p, {}, like),
    )
    return final.reshape(-1)[:d].reshape(x.shape[1:])


def _ring_allreduce_fused(draws: _LeafDraws, x: torch.Tensor, n: int,
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

    final = _ring_schedule(draws, chunks, n, encode_send=encode_send,
                           decode_add=decode_add, decode=decode)
    return final.reshape(-1)[:d].reshape(x.shape[1:])


def _model_dim(spec, mesh, key) -> Optional[int]:
    """The inner dim of a worker-stacked leaf's spec that is sharded over
    ``model`` (None: replicated over it).  The worker axes sit on the
    leading dim, so ``model`` is the only axis an inner dim may name."""
    dims = [i for i, ax in enumerate(tuple(spec)[1:]) if ax is not None]
    for i in dims:
        axs = spec[i + 1] if isinstance(spec[i + 1], tuple) else (
            spec[i + 1],)
        if set(axs) != {"model"}:
            raise ValueError(f"leaf {key!r}: spec {spec} shards an inner dim "
                             f"over {axs}; only 'model' can be")
    if len(dims) > 1:
        raise ValueError(f"leaf {key!r}: spec {spec} names 'model' twice")
    if not dims or mesh.model == 1:
        return None
    return dims[0]


def _pod_sum(draws: _LeafDraws, accs: List[torch.Tensor],
             codec) -> torch.Tensor:
    """The pod stage: each pod's ring result encoded once (the leaf's
    pod draw, the same on every pod), decoded, and the decodes summed in
    pod order (the reference's ``psum`` over ``pod``)."""
    rand = draws.pod()
    like = ShapeDtype(tuple(accs[0].shape), torch.float32, accs[0].device)
    total = None
    for acc in accs:
        dec = codec.decode(encode_meta_free(codec, rand, acc), {}, like)
        total = dec if total is None else total.add_(dec)
    return total


def q8_ring_tree_mean(noise, tree: Tree, mesh, *,
                      codec=Int8Stochastic(),
                      leaf_indices: Optional[Sequence[int]] = None,
                      pod_axis: Optional[str] = None,
                      wspecs=None) -> Tree:
    """Quantized ring mean over a worker-stacked tree on a ``HostMesh``,
    with ``Int8Stochastic`` payloads by default.

    Leaves are ``(W, ...)``, W a multiple of the worker positions (pod x
    data), which own the rows pod-major: position ``(p, j)`` the rows
    ``[(p n + j) k, (p n + j + 1) k)``, k = W / (pods n).  Each position
    sums its rows in f32 (``_local_sum``), the n positions of each pod
    ring-all-reduce their sums with encoded hops, then (``pod_axis``,
    more than one pod) each pod's result is encoded once, decoded and
    summed over the pods (``_pod_sum``); the result is divided by W.
    ``wspecs`` (``{path: worker-stacked spec}``, ``dist.sharding``)
    names the inner dim each leaf shards over ``model``: each of the
    mesh's ``model`` shards of it (that slice of the dim, contiguous,
    then flattened) runs its own ring and pod stage, and the shards are
    put back along the dim.  A leaf replicated over ``model`` gives the
    same value at every model position, so it is reduced once.  One
    position returns its sum unreduced, as the reference's ring does at
    n == 1.  Codecs with ``fused_ring`` set (``FusedQ8``) run the
    kernel-fused hops.  ``leaf_indices`` pins each leaf's draws to its
    global tree position.  The division by W is the product with
    f32(1 / W), which is what XLA compiles the reference's ``acc / W``
    to.
    """
    if pod_axis is not None and pod_axis not in mesh.axis_names:
        raise ValueError(f"pod_axis {pod_axis!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")
    n = mesh.data
    pods = mesh.pods if pod_axis is not None else 1
    ring = (_ring_allreduce_fused if getattr(codec, "fused_ring", False)
            else _ring_allreduce_coded)
    idxs = _leaf_indices(list(tree), leaf_indices)
    if wspecs is not None and set(wspecs) != set(tree):
        raise ValueError("wspecs must name the leaves of the tree")
    out = {}
    for i, (k, x) in enumerate(tree.items()):
        w = x.shape[0]
        if w % (n * pods):
            raise ValueError(f"leaf {k!r}: {w} worker rows do not split over "
                             f"{pods} x {n} worker positions")
        if not mesh.holds(x):
            raise ValueError(f"leaf {k!r} is on {x.device}, the mesh on "
                             f"{mesh.device}")
        dim = None if wspecs is None else _model_dim(wspecs[k], mesh, k)
        draws = _LeafDraws(noise, idxs[i])
        rows = w // pods
        shards = []
        for s in range(1 if dim is None else mesh.model):
            if dim is None:
                xs = x
            else:
                size = x.shape[dim + 1] // mesh.model
                xs = _narrow_marked(x, dim + 1, s * size, size)
            accs = [_sum_rows(xs, p * rows, (p + 1) * rows)
                    if n == 1 else ring(draws, _rows_marked(
                        xs, p * rows, (p + 1) * rows), n, codec)
                    for p in range(pods)]
            del xs
            shards.append(accs[0] if pods == 1 else
                          _pod_sum(draws, accs, codec))
            del accs
        acc = shards[0] if dim is None else torch.cat(shards, dim)
        del shards
        out[k] = _mean_of_sum(acc, w, x.dtype)
        del acc   # this leaf's sum is not held while the next one reduces
    return out


def randk_shared_mean(noise, wtree: Tree, ratio: float, *,
                      leaf_indices: Optional[Sequence[int]] = None) -> Tree:
    """Mean of shared-pattern Rand-K messages (correlated sampling).

    Every worker encodes with ``RandK(q=ratio, shared_pattern=True)`` and
    the leaf's ONE permutation (``noise.shared_permutation(leaf, d)``,
    the reference's per-leaf key, the same for every worker), so all
    workers keep one K-subset (K = round(ratio d), at least 1); the
    payload is the K kept values times d / K (the pattern lives in
    ``meta`` and is never charged).  The master averages the payloads
    value-wise and decodes ONCE: ``mean_i C(g_i) = decode(mean_i
    encode(g_i))``.  Unbiased over the pattern draw.

    The average is XLA's: the scaling by f32(d / K) fused into the sum
    over the workers (``_local_sum`` with ``scale``: one fma a worker),
    then times f32(1/W); so the payloads are gathered once, all workers
    together, and scaled inside the sum."""
    idxs = _leaf_indices(list(wtree), leaf_indices)
    codec = RandK(q=ratio, shared_pattern=True)
    out = {}
    for i, (k, x) in enumerate(wtree.items()):
        w, d = x.shape[0], x[0].numel()
        kk = max(1, int(round(ratio * d)))
        idx = noise.shared_permutation(idxs[i], d)[:kk].to(torch.int32)
        kept = x.reshape(w, d)[:, idx.long()]
        if x.dtype == torch.float32:
            total = _local_sum(kept, scale=d / kk)
        else:   # the payload is rounded to the leaf's dtype first
            total = _local_sum(kept * (d / kk))
        mean = _mean_of_sum(total, w, x.dtype)
        like = ShapeDtype(tuple(x.shape[1:]), x.dtype, x.device)
        out[k] = codec.decode({"values": mean}, {"indices": idx}, like)
    return out


def compressed_tree_mean(wtree: Tree, mode: str, noise, mesh=None, *,
                         randk_q: float = 0.05, wspecs=None,
                         q8_block_rows: Optional[int] = None,
                         leaf_indices: Optional[Sequence[int]] = None
                         ) -> Tree:
    """Worker-mean of a stacked tree in the aggregation format ``mode``
    (one of ``AGGREGATION_MODES``; ``comm.channel.aggregation_mode_of``
    maps comm modes and configs to it).  ``randk_q`` is the keep
    fraction of ``randk_shared``; ``wspecs`` the worker-stacked specs of
    the ring modes (``q8_ring_tree_mean``), whose pod stage runs when
    the mesh has a ``pod`` axis; ``q8_block_rows`` sets the fused
    codec's scale-block rows (None = the kernel default);
    ``leaf_indices`` the global tree positions the draws are bound to (a
    bucket of the overlap runtime is a subtree)."""
    if mode == "dense":
        return dense_mean(wtree)
    if mode == "randk_shared":
        return randk_shared_mean(noise, wtree, randk_q,
                                 leaf_indices=leaf_indices)
    if mode in ("q8_ring", "q8_ring_fused"):
        if mesh is None:
            raise ValueError(f"{mode} needs a mesh")
        if mode == "q8_ring_fused":
            codec = (FusedQ8() if q8_block_rows is None
                     else FusedQ8(block_rows=q8_block_rows))
        else:
            codec = Int8Stochastic()
        pod = "pod" if "pod" in mesh.axis_names else None
        return q8_ring_tree_mean(noise, wtree, mesh, codec=codec,
                                 leaf_indices=leaf_indices, pod_axis=pod,
                                 wspecs=wspecs)
    raise ValueError(f"unknown aggregation mode {mode!r}; have "
                     f"{AGGREGATION_MODES}")
