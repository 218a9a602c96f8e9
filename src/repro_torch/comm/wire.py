"""Per-worker encode plumbing and the round's noise source.

The reference derives every random bit of a round from one PRNG key:
``leaf_key`` folds the leaf's global tree position into it, a two-part
message splits it once more per part, and ``worker_keys`` splits it per
worker -- or hands every worker the same key when the codec declares a
shared pattern or is deterministic.  The port's codecs take their
randomness from a draw object instead (``WorkerNoise``), and the draws
come from one noise source; the default schedule
(``comm.channel.Channel.shift_round``) asks for them in this order:

1. the messages, one uplink after another (StarShift sends Q's uplink,
   then C's); within an uplink leaf by leaf (the leaf's global position
   in the tree), within a leaf part by part (generalized DIANA's C,
   then its Q), within a part worker by worker.  A draw is either
   ``uniform(leaf, worker, shape)`` (f32 in [0, 1)) or
   ``permutation(leaf, worker, d)`` (a random permutation of
   ``range(d)``, int64: RandK's index draw).  A codec with a shared
   pattern draws once, for every worker, with ``worker=None``; a
   deterministic codec draws nothing.  Every message draw carries its
   part as the keyword ``part``: ``"c"`` or ``"q"`` for the parts of a
   two-part message, None for a one-part one.
2. then the round's tree-level extras: ``aux_uniform(shape)``
   (Rand-DIANA's per-worker refresh draw, one uniform a worker);
3. then the round's aggregation (``dist.collectives``), leaf by leaf:
   through a ring, the ring's encodes, ``ring_uniform(leaf, hop,
   shape)`` -- hops ``0 .. n-2`` are the reduce-scatter's, hop ``n-1``
   is the all-gather's one encode -- then, on a mesh with more than one
   pod, the pod stage's one encode, ``pod_uniform(leaf, shape)``; in
   the ``randk_shared`` format the leaf's one Rand-K pattern,
   ``shared_permutation(leaf, d)``.  Every ring position, every pod and
   every model shard of a leaf uses the same draw: the reference's
   aggregation key enters its ``shard_map`` replicated.

Three sources implement this protocol, and so can any object with the
same methods (the parity tests replay the draws the reference makes
along its own key chain, which is how the port's round is held bit for
bit against the reference's):

* ``AddressedNoise``, the training step's (``launch.train.init_state``):
  every draw is a pure function of its address -- the seed, the wire
  (``stream``: none on the gradient wire), the round, the kind of draw
  and its (leaf, worker or hop, part), or on the moe and act wires its
  (layer, worker, group, part) (``send_uniform``) -- so a round draws the same bits
  in ANY order of its calls.  That is what lets the
  overlap runtime (``comm.overlap``: bucket by bucket, message then
  ring) and the fused backward encode (``comm.fused_vjp``: worker by
  worker, in reverse layer order, inside autograd) re-schedule a round
  and stay bitwise equal to ``MeshChannel``'s.  ``next_round()``, which
  the step calls once per step, moves it to the next round's draws.
* ``GeneratorNoise``: one ``torch.Generator`` stream, whose draws
  depend on the order of the calls, which the round fixes as listed
  above; the convex path (``core.algorithms``, ``core.iterate_comp``)
  uses it.  Its ``next_round()`` does nothing: the stream goes on.
* ``MetaNoise``, the step's cost pass's (``launch.hlo_cost``): every
  draw an empty meta tensor of its shape, so a round on meta tensors
  traces its ops and draws nothing.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.compressors import ShapeDtype


class GeneratorNoise:
    """Draws from a ``torch.Generator`` on ``device``; successive calls
    continue one stream, so the draws depend on the order of the calls,
    which the round fixes (module docstring)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def uniform(self, leaf: int, worker: Optional[int], shape,
                part: Optional[str] = None) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ``worker``'s encode of leaf
        ``leaf`` (``worker=None``: one draw for every worker)."""
        return torch.rand(shape, generator=self.generator, device=self.device,
                          dtype=torch.float32)

    def permutation(self, leaf: int, worker: Optional[int], d: int,
                    part: Optional[str] = None) -> torch.Tensor:
        """A random permutation of ``range(d)`` (int64) for ``worker``'s
        encode of leaf ``leaf``."""
        return torch.randperm(d, generator=self.generator, device=self.device)

    def aux_uniform(self, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for the round's tree-level extras."""
        return self.uniform(-1, None, shape)

    def ring_uniform(self, leaf: int, hop: int, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ring hop ``hop`` of leaf ``leaf``,
        shared by every ring position."""
        return self.uniform(leaf, hop, shape)

    def pod_uniform(self, leaf: int, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for the pod stage's encode of leaf
        ``leaf``, shared by every pod."""
        return self.uniform(leaf, None, shape)

    def shared_permutation(self, leaf: int, d: int) -> torch.Tensor:
        """The ``randk_shared`` aggregation's pattern of leaf ``leaf``: a
        permutation of ``range(d)`` (int64) shared by every worker."""
        return self.permutation(leaf, None, d)

    def next_round(self) -> None:
        """Nothing: the next round's draws continue the stream."""


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One step of splitmix64 (Steele, Lea & Flood, 2014): a bijective
    64-bit mix whose outputs pass BigCrush as a sequence."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _field(v) -> int:
    """An address field as a 64-bit word: None is all ones (no worker,
    no part), an int its two's complement, a part name its CRC-32."""
    if v is None:
        return _MASK64
    if isinstance(v, str):
        return zlib.crc32(v.encode())
    return int(v) & _MASK64


#: the kinds of draw, one address space each
(_UNIFORM, _PERMUTATION, _AUX, _RING, _POD, _PATTERN, _SEND,
 _SEND_PERMUTATION) = range(8)


class AddressedNoise:
    """The port's ``jax.random.fold_in``: every draw of a round is
    addressed by name, ``(seed, [wire,] round, kind, leaf, worker or hop,
    part)``, and made by reseeding one ``torch.Generator`` on ``device``
    from a splitmix64 chain over that address.  The same address gives
    the same bits in any order of the calls and on any stream.  It does
    not reproduce the reference's threefry draws (the port never does:
    the parity tests replay those), only their independence from the
    order.

    ``wire`` is the stream of a named wire other than the gradient wire
    (``stream``, the port of ``comm.transport.wire_stream``): the CRC-32
    of its name, masked to 31 bits as the reference folds it in; None on
    the gradient wire, whose addresses then omit the field.

    On a CUDA device the generator is Philox, keyed by all 64 bits of
    the mixed seed; the CPU's Mersenne Twister keeps the low 32 of them,
    so two of a round's ~100 addresses collide there with probability
    ~1e-6.  ``next_round()`` moves to the next round's addresses,
    ``at_round(r)`` gives a source at round ``r``."""

    def __init__(self, seed: int, device, wire: Optional[int] = None,
                 round: int = 0):
        self.seed, self.wire, self.round = int(seed), wire, int(round)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def stream(self, name: str) -> "AddressedNoise":
        """The source of the wire called ``name``, at round 0."""
        return AddressedNoise(self.seed, self.device,
                              zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF)

    def at_round(self, r: int) -> "AddressedNoise":
        """This source's addresses at round ``r``."""
        return AddressedNoise(self.seed, self.device, self.wire, r)

    def _at(self, kind: int, *fields) -> torch.Generator:
        head = (self.seed,) if self.wire is None else (self.seed, self.wire)
        h = 0
        for v in head + (self.round, kind) + fields:
            h = _splitmix64(h ^ _field(v))
        self.generator.manual_seed(h)
        return self.generator

    def uniform(self, leaf: int, worker: Optional[int], shape,
                part: Optional[str] = None) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ``worker``'s encode of leaf
        ``leaf`` (``worker=None``: one draw for every worker)."""
        return torch.rand(shape, generator=self._at(_UNIFORM, leaf, worker,
                                                    part),
                          device=self.device, dtype=torch.float32)

    def permutation(self, leaf: int, worker: Optional[int], d: int,
                    part: Optional[str] = None) -> torch.Tensor:
        """A random permutation of ``range(d)`` (int64) for ``worker``'s
        encode of leaf ``leaf``."""
        return torch.randperm(d, generator=self._at(_PERMUTATION, leaf,
                                                    worker, part),
                              device=self.device)

    def aux_uniform(self, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for the round's tree-level extras."""
        return torch.rand(shape, generator=self._at(_AUX, None, None, None),
                          device=self.device, dtype=torch.float32)

    def ring_uniform(self, leaf: int, hop: int, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ring hop ``hop`` of leaf ``leaf``,
        shared by every ring position."""
        return torch.rand(shape, generator=self._at(_RING, leaf, hop, None),
                          device=self.device, dtype=torch.float32)

    def pod_uniform(self, leaf: int, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for the pod stage's encode of leaf
        ``leaf``, shared by every pod."""
        return torch.rand(shape, generator=self._at(_POD, leaf, None, None),
                          device=self.device, dtype=torch.float32)

    def shared_permutation(self, leaf: int, d: int) -> torch.Tensor:
        """The ``randk_shared`` aggregation's pattern of leaf ``leaf``: a
        permutation of ``range(d)`` (int64) shared by every worker."""
        return torch.randperm(d, generator=self._at(_PATTERN, leaf, None,
                                                    None),
                              device=self.device)

    def send_uniform(self, address: tuple, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for one send of a forwarded-payload
        wire (this source is the wire's stream): ``address`` is ``(layer,
        worker, group, part)``, as ``comm.transport.SendDraw`` gives it."""
        return torch.rand(shape, generator=self._at(_SEND, *address),
                          device=self.device, dtype=torch.float32)

    def send_permutation(self, address: tuple, d: int) -> torch.Tensor:
        """A random permutation of ``range(d)`` (int64) for one send of a
        forwarded-payload wire (``send_uniform``'s address)."""
        return torch.randperm(d, generator=self._at(_SEND_PERMUTATION,
                                                    *address),
                              device=self.device)

    def next_round(self) -> None:
        """Address the next round's draws."""
        self.round += 1


class MetaNoise:
    """The noise source of the step's cost pass (``launch.hlo_cost``): every
    draw of ``AddressedNoise``'s protocol, as an empty tensor of its shape
    and dtype on the meta device -- the ops a round runs on its draws are
    traced, and no value is drawn."""

    device = torch.device("meta")
    round = 0

    def _u(self, shape):
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def _p(self, d):
        return torch.empty((d,), dtype=torch.int64, device=self.device)

    def uniform(self, leaf, worker, shape, part=None):
        return self._u(shape)

    def permutation(self, leaf, worker, d, part=None):
        return self._p(d)

    def aux_uniform(self, shape):
        return self._u(shape)

    def ring_uniform(self, leaf, hop, shape):
        return self._u(shape)

    def pod_uniform(self, leaf, shape):
        return self._u(shape)

    def shared_permutation(self, leaf, d):
        return self._p(d)

    def send_uniform(self, address, shape):
        return self._u(shape)

    def send_permutation(self, address, d):
        return self._p(d)

    def stream(self, name: str) -> "MetaNoise":
        return self

    def at_round(self, r: int) -> "MetaNoise":
        return self

    def next_round(self) -> None:
        """Nothing: meta draws have no rounds."""


@dataclass(frozen=True)
class WorkerNoise:
    """One worker's draws for one leaf and part: ``rand(shape)`` gives
    uniforms, ``rand.permutation(d)`` an index draw (``worker=None``:
    the one draw every worker shares)."""

    source: Any
    leaf: int
    worker: Optional[int]
    part: Optional[str] = None

    def __call__(self, shape) -> torch.Tensor:
        return self.source.uniform(self.leaf, self.worker, shape,
                                   part=self.part)

    def permutation(self, d: int) -> torch.Tensor:
        return self.source.permutation(self.leaf, self.worker, d,
                                       part=self.part)

    def part_of(self, name: str) -> "WorkerNoise":
        """The draws of part ``name`` of a two-part codec (``Induced``):
        the part joined to this draw's own, ``"q/c"`` under DIANA's
        ``"q"``."""
        part = name if self.part is None else f"{self.part}/{name}"
        return WorkerNoise(self.source, self.leaf, self.worker, part)


class _SharedDraw:
    """The draws of a shared-pattern codec: each kind is drawn once, at
    its first call, and handed to every worker (the reference's
    ``worker_keys`` broadcasts one key)."""

    def __init__(self, noise: WorkerNoise):
        self.noise = noise
        self.drawn = {}
        self.parts = {}

    def _once(self, what, fn):
        if what not in self.drawn:
            self.drawn[what] = fn()
        return self.drawn[what]

    def __call__(self, shape):
        return self._once(("u", tuple(shape)), lambda: self.noise(shape))

    def permutation(self, d: int):
        return self._once(("p", d), lambda: self.noise.permutation(d))

    def part_of(self, name: str) -> "_SharedDraw":
        if name not in self.parts:
            self.parts[name] = _SharedDraw(self.noise.part_of(name))
        return self.parts[name]


@dataclass(frozen=True)
class LeafNoise:
    """THE per-leaf noise derivation of the wire layer (the port of
    ``leaf_key``): the noise source bound to one leaf's GLOBAL position
    in the tree, and to a message part (``part``; None for one-part
    messages)."""

    source: Any
    leaf: int
    part: Optional[str] = None

    def worker(self, j: Optional[int]) -> WorkerNoise:
        """The draw object of worker ``j`` (None: every worker's)."""
        return WorkerNoise(self.source, self.leaf, j, self.part)

    def with_part(self, part: str) -> "LeafNoise":
        return LeafNoise(self.source, self.leaf, part)


def worker_draws(codec, noise: LeafNoise, w: int) -> list:
    """The draw objects of ``w`` workers for one leaf, the port of
    ``worker_keys``: a codec with a shared pattern, or a deterministic
    one, gets one draw (``worker=None``) for every worker; any other
    codec one per worker."""
    if getattr(codec, "shared_pattern", False) or not codec.stochastic:
        shared = _SharedDraw(noise.worker(None))
        return [shared] * w
    return [noise.worker(j) for j in range(w)]


def encode_decode_workers(codec, noise: LeafNoise, leaf: torch.Tensor
                          ) -> Tuple[List[Any], torch.Tensor]:
    """One uplink leaf: encode then decode each worker row of a
    worker-stacked ``(W, ...)`` leaf.

    Returns ``(payloads, decoded (W, ...) messages)``; ``wire_bits`` of
    the payloads is the leaf's total.  The reference vmaps the codec over
    the worker axis.  Here a codec with ``encode_decode_stacked`` takes
    all the rows in one call; any other runs the workers one after
    another into one stacked output.
    """
    draws = worker_draws(codec, noise, leaf.shape[0])
    if hasattr(codec, "encode_decode_stacked"):
        payload, out = codec.encode_decode_stacked(draws, leaf)
        return [payload], out
    like = ShapeDtype(tuple(leaf.shape[1:]), leaf.dtype, leaf.device)
    out = torch.empty_like(leaf)
    payloads = []
    for j, rand in enumerate(draws):
        payload, meta = codec.encode(rand, leaf[j])
        out[j] = codec.decode(payload, meta, like)
        payloads.append(payload)
    if getattr(codec, "sum_fuses_decode", False) and out.dtype == torch.float32:
        from repro_torch.dist.collectives import with_payload_rows

        with_payload_rows(out, torch.stack([p["q"] for p in payloads]),
                          torch.stack([p["scale"] for p in payloads]))
    return payloads, out


def bits_aot(codec, wleaf_like) -> float:
    """Structural wire bits of ``codec``'s payloads for a W-stacked leaf,
    from its shape and dtype alone (``Compressor.payload_like``)."""
    w, *inner = wleaf_like.shape
    like = ShapeDtype(tuple(inner), wleaf_like.dtype, torch.device("meta"))
    return float(w * codec.wire_bits(codec.payload_like(like)))


def _shifted_round_trip(codec, h):
    """Whether ``Q(g - h)`` is the codec's own ``shifted_round_trip``: a
    shift, and a codec that has one (the natural codec)."""
    return h is not None and hasattr(codec, "shifted_round_trip")


def shifted_message_workers(codec, noise: LeafNoise, g: torch.Tensor, h
                            ) -> Tuple[torch.Tensor, float]:
    """One uplink leaf's message ``Q(g - h)``: the decoded ``(W, ...)``
    messages of the worker-stacked ``g`` and ``h`` (``h`` None: ``Q(g)``)
    and their structural wire bits.  A codec with ``shifted_round_trip``
    takes g, h and the workers' draws whole (the natural codec: one
    kernel a worker on the card), and the bits are ``bits_aot``'s, from
    the shapes; any other codec, or no shift, sends ``g - h`` through
    ``encode_decode_workers``."""
    if not _shifted_round_trip(codec, h):
        payloads, m = encode_decode_workers(codec, noise,
                                            g if h is None else g - h)
        return m, codec.wire_bits(payloads)
    draws = worker_draws(codec, noise, g.shape[0])
    return codec.shifted_round_trip(draws, g, h), bits_aot(codec, g)


def shifted_message_row(codec, draw, g: torch.Tensor, h) -> torch.Tensor:
    """ONE worker's row of ``shifted_message_workers``: ``g`` and ``h``
    without the worker axis, ``draw`` the worker's draw object.  Returns
    the decoded message only, through the same route."""
    if not _shifted_round_trip(codec, h):
        return codec(draw, g if h is None else g - h)
    return codec.shifted_round_trip([draw], g[None], h[None])[0]


def encode_meta_free(codec, rand, block: torch.Tensor):
    """Encode for forwarded-payload transports (ring hops): the decoder
    sees ONLY the payload, so a codec that needs side information in
    ``meta`` is rejected."""
    payload, meta = codec.encode(rand, block)
    if meta:
        raise ValueError(
            f"{type(codec).__name__} carries decoder state in meta; "
            "quantized ring stages forward payloads only (meta must be "
            "empty)"
        )
    return payload
