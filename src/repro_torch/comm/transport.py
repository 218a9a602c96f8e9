"""The Transport layer: every wire of a run as one registry -- the port
of the reference's ``repro/comm/transport.py``.

  ``Wire``       one named traffic stream: a topology, the codec whose
        payload rides it, an optional shift rule + Channel (the
        ``allreduce`` grad wire), and its declared per-step traffic for
        structural accounting.
  ``Transport``  the per-step registry of every Wire; ``per_wire_bits``
        is the accounting table.
  ``build_transport``  the standard registry from a
        ``CompressionConfig``: the grad wire always; when their flags
        are set the ``moe`` wire (``all_to_all``: the MoE layers'
        expert buffers), the ``act`` wire (``p2p``: the block-boundary
        activations) -- both forwarded payloads, ``Wire.send`` -- and
        the ``model`` wire (``broadcast``: the trainer -> serving-fleet
        downlink, ``serving.delta``).

Noise rule (the reference's keying rule, on the port's noise sources):
the grad wire hands its round's noise VERBATIM to ``rule.round``
(``shift_round``, ``iterate_round``) and to ``Channel.fused_round``
(``fused_round``), so a round through the wire is bitwise the round
without it, and the training step routes every round through it; every other
wire draws from its own stream, ``wire_stream(noise, name)``
(``AddressedNoise.stream``: the CRC-32 of the wire's name becomes a
field of every address), so no two wires share draws; a send on the moe
and act wires is addressed by (round, layer, worker, group, part)
(``WorkerWireNoise``).

Accounting is ahead of time and structural: ``Compressor.payload_like``
runs a codec's encode on meta tensors (shapes, no data, no draw), the
same encode the live traffic runs, so the bits cannot drift from the
wire protocol.  The grad wire's accounting codec is the aggregation's
(``aggregation_wire_codec``): ``randk_shared`` is charged ``RandK(q=randk_q,
shared_pattern=True)``, whose pattern rides in ``meta`` and costs no
bits.

Measured surfaces (the obs run header reads them through
``Transport.obs_snapshot``): ``Wire.codec_timings`` times one payload of
a wire's traffic through its codec (``tune.measure.time_fn``, the device
synchronised around every call; a fused wire reports exact zeros without
timing anything: its encode runs inside the backward pass), and
``Wire.codec_quality`` measures its ``omega_hat``/``nmse``
(``obs.quality``), both on data and draws of their own.  A wire's
``overlap_hidden`` (the tune model's nominal ``OVERLAP_HIDE`` on the
overlap and fused modes' grad wire) and ``fused`` are set by
``build_transport``; ``Transport.extra_traffic`` is what the tune
predictor charges for the non-grad wires.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.compressors import ShapeDtype, _tensor_leaves
from repro_torch.spans import span

#: wire topologies of the reference: ``allreduce`` (the grad wire),
#: ``all_to_all`` (moe), ``p2p`` (act), ``broadcast`` (model)
WIRE_TOPOLOGIES = ("allreduce", "all_to_all", "p2p", "broadcast")

#: per-wire codec flags the config/CLI surface accepts (``--moe_wire``,
#: ``--act_wire``, ``--model_wire``)
WIRE_CODEC_FLAGS = ("none", "dense", "q8", "randk", "topk", "sign",
                    "natural")

def wire_stream(noise, name: str):
    """THE per-wire noise derivation: the stream of the wire ``name``
    (the reference folds the CRC-32 of the name into its key).  The grad
    wire does not use it: its round noise passes verbatim."""
    return noise.stream(name)


def wire_flag_codec(flag: str, *, randk_q: float = 0.05):
    """Codec for one per-wire config flag (None for ``"none"``); every
    one is meta-free (its decoder state travels in the payload)."""
    from repro_torch.core.compressors import (
        Identity,
        Int8Stochastic,
        NaturalCompression,
        RandK,
        ScaledSign,
        TopK,
    )

    table = {
        "none": lambda: None,
        "dense": Identity,
        "q8": Int8Stochastic,
        "randk": lambda: RandK(q=randk_q),
        "topk": lambda: TopK(q=randk_q),
        "sign": ScaledSign,
        "natural": NaturalCompression,
    }
    if flag not in table:
        raise ValueError(
            f"unknown wire codec {flag!r}; have {WIRE_CODEC_FLAGS}")
    return table[flag]()


def aggregation_wire_codec(comp):
    """The codec whose payload defines a grad-wire round's bytes on the
    wire, from anything with ``enabled`` / ``comm_mode`` / ``randk_q`` /
    ``q8_block_rows`` / ``compressor`` attributes: the aggregation
    formats are charged their aggregation codec, the error-feedback
    modes their configured contractive message."""
    from repro_torch.comm.channel import FUSED_VJP_MODES, OVERLAP_MODES
    from repro_torch.core.compressors import (
        Identity,
        Int8Stochastic,
        RandK,
        make_compressor,
    )

    if not getattr(comp, "enabled", True):
        return Identity()
    mode = comp.comm_mode
    if mode in ("dense", "sim"):   # sim: the exact-mean parameter server
        return Identity()
    if mode == "randk_shared":
        return RandK(q=comp.randk_q, shared_pattern=True)
    if mode == "q8_ring":
        return Int8Stochastic()
    if mode in ("q8_ring_fused",) + OVERLAP_MODES + FUSED_VJP_MODES:
        return make_compressor("q8_block", block_rows=comp.q8_block_rows)
    if mode in ("ef21", "efbv"):
        return make_compressor(comp.compressor,
                               **dict(comp.compressor_kwargs))
    raise ValueError(f"no wire codec for comm mode {mode!r}")


def _payload_like(codec, like: ShapeDtype, topology: str):
    """The payload of ONE send of ``like`` through ``codec``, as meta
    tensors: a worker-stacked ``(W, ...)`` leaf on an allreduce wire
    (one payload a worker), the whole tensor on the other wires."""
    if topology == "allreduce":
        w, *inner = like.shape
        one = codec.payload_like(ShapeDtype(tuple(inner), like.dtype,
                                            torch.device("meta")))
        return [one] * w
    return codec.payload_like(like)


def _aot_payload_bits(codec, like, topology: str) -> float:
    """Structural bits of one send (the codec's ``wire_bits``)."""
    return float(codec.wire_bits(_payload_like(codec, like, topology)))


def _aot_payload_nbytes(codec, like, topology: str) -> float:
    """Buffer bytes of one send's payload: container widths (a 1-bit
    sign in an int8 container counts 1 byte), beside the structural
    bits."""
    total = 0
    for leaf in _tensor_leaves(_payload_like(codec, like, topology)):
        t = getattr(leaf, "data", leaf)
        total += math.prod(t.shape) * t.element_size()
    return float(total)


@dataclass(eq=False)
class Wire:
    """One named traffic stream of the Transport.

    ``traffic`` declares the per-STEP payload tensors as ``((ShapeDtype,
    count), ...)``; counts fold repeated sends (workers, publishes every
    k steps as 1/k) so the accounting stays static."""

    name: str
    topology: str
    codec: Any
    channel: Any = None
    rule: Any = None                 # allreduce: the phased ShiftRule
    msg_codec: Any = None            # allreduce: the rule's message codec
    traffic: Tuple = ()
    overlap_hidden: float = 0.0      # fraction of comm hidden under compute
    fused: bool = False              # encode runs INSIDE the backward pass
    #                                  (comm.fused_vjp): no standalone
    #                                  encode launches on this wire

    def __post_init__(self):
        if self.topology not in WIRE_TOPOLOGIES:
            raise ValueError(f"unknown wire topology {self.topology!r}; "
                             f"have {WIRE_TOPOLOGIES}")

    # -- the allreduce grad wire: the shift-rule engine, noise VERBATIM --

    def shift_round(self, noise, wgrads, h, h_bar):
        """One gradient round: ``rule.round`` with the round's noise as
        given, bitwise ``Channel.shift_round``.  Returns ``(g_bar, h_new,
        h_bar_new, bits)``."""
        return self.rule.round(self.msg_codec, noise, wgrads, h, h_bar,
                               self.channel)

    def fused_round(self, noise, msgs, h, h_bar):
        """The fused-backward round's tail (``comm.fused_vjp``): ``msgs``
        are the decoded messages the backward pass emitted, drawn from
        this round's noise, which passes on as given to
        ``Channel.fused_round``.  Returns ``(g_bar, h_new, h_bar_new,
        bits)``."""
        return self.channel.fused_round(self.rule, self.msg_codec, noise,
                                        msgs, h, h_bar)

    def iterate_round(self, noise, params, wgrads, h, h_bar):
        """Algorithm 2 (VR-GDCI): the compressed-iterate round, the noise
        as given.  Returns ``(params, h_new, h_bar_new, bits)``."""
        return self.rule.round(noise, params, wgrads, h, h_bar, self.channel)

    def reduce_mean(self, noise, wtree):
        """The channel's worker mean (an uncompressed step's round)."""
        return self.channel.reduce_mean(noise, wtree)

    # -- the forwarded-payload wires (moe, act): one compressed hop -------

    def send(self, draw, x: torch.Tensor, e: Optional[torch.Tensor] = None):
        """One compressed hop of ``x`` with the draws ``draw``
        (``SendDraw``): ``(y, e_new)``.  The forward value is ``x +
        (decoded - x)``, rounded as the reference's jitted send rounds
        it (the difference with the decode fused in,
        ``Channel.all_to_all``'s ``minus``); the backward pass is
        straight through (the decode counts as the identity).  With a
        shift ``e`` the error-compensated ``target = x + e`` rides the
        wire and its residual ``target - decoded`` (fused the same way)
        is the next send's shift.  The send is the span
        ``wire/<name>`` (``repro_torch.spans``)."""
        with span(f"wire/{self.name}"):
            target = x if e is None else x + e.to(x.dtype)
            with torch.no_grad():
                xd, td = x.detach(), target.detach()
                _, diffs = self.channel.all_to_all(
                    self.codec, draw, td,
                    minus=(xd,) if e is None else (xd, td))
            e_new = None if e is None else diffs[1].neg_()
            return x + diffs[0], e_new

    # -- the broadcast model wire ----------------------------------------

    def broadcast(self, noise, tree):
        """One downlink fan-out of a whole tree through the wire's codec:
        ``(decoded, bits)``, the bits counted once."""
        return self.channel.broadcast(self.codec, noise, tree)

    # -- accounting --------------------------------------------------------

    def _per_step(self, per_send) -> float:
        total, cache = 0.0, {}
        for like, count in self.traffic:
            sig = (tuple(like.shape), like.dtype)
            if sig not in cache:
                cache[sig] = per_send(self.codec, like, self.topology)
            total += count * cache[sig]
        return total

    def wire_bits(self) -> float:
        """Per-step structural wire bits of the declared traffic."""
        return self._per_step(_aot_payload_bits)

    def payload_nbytes(self) -> float:
        """Per-step payload buffer bytes of the declared traffic."""
        return self._per_step(_aot_payload_nbytes)

    # -- measured surfaces -------------------------------------------------

    def _probe(self, cap_bytes: int, seed: int, device):
        """The probe data of ``codec_timings`` / ``codec_quality``: the
        largest declared shape within ``cap_bytes`` (falling back to the
        smallest -- a micro-measurement must stay micro), normal values
        from a generator seeded with ``seed``, on ``device`` (default:
        the CUDA device); and the draws of leaf 0 of an addressed noise
        source of the same seed."""
        from repro_torch.comm.wire import AddressedNoise, LeafNoise
        from repro_torch.device import resolve_device

        def nbytes(like):
            return math.prod(like.shape) * like.dtype.itemsize

        within = [like for like, _ in self.traffic
                  if nbytes(like) <= cap_bytes]
        like = (max(within, key=nbytes) if within
                else min((l for l, _ in self.traffic), key=nbytes))
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        data = torch.randn(tuple(like.shape), generator=gen, device=dev,
                           dtype=torch.float32).to(like.dtype)
        return data, LeafNoise(AddressedNoise(seed, dev), 0)

    def codec_timings(self, *, iters: int = 2, cap_bytes: int = 1 << 20,
                      seed: int = 0, device=None
                      ) -> Dict[str, Optional[float]]:
        """Measured ``{"encode_s", "decode_s"}`` of ONE payload of this
        wire's traffic through its codec (median wall clock of
        ``tune.measure.time_fn``, the device synchronised around every
        call; the shape as ``_probe`` picks it).  Nones when the wire
        declares no traffic.  ``decode_s`` times the decode of the
        encoded payload alone (the reference takes the round trip minus
        the encode, which short noisy timings can drive to zero).

        A FUSED wire reports exact zeros without timing anything: its
        encode and decode run inside the backward pass itself (the
        cotangent is consumed as it is produced), so there is no
        standalone codec launch to measure.
        """
        if self.fused:
            return {"encode_s": 0.0, "decode_s": 0.0}
        if not self.traffic:
            return {"encode_s": None, "decode_s": None}
        from repro_torch.comm.wire import worker_draws
        from repro_torch.core.compressors import ShapeDtype
        from repro_torch.tune.measure import time_fn

        data, noise = self._probe(cap_bytes, seed, device)
        codec = self.codec
        if self.topology == "allreduce":   # each worker row, its own draws
            like = ShapeDtype(tuple(data.shape[1:]), data.dtype, data.device)

            def enc():
                return [codec.encode(d, data[j]) for j, d in
                        enumerate(worker_draws(codec, noise, data.shape[0]))]
        else:                              # the block whole, one draw
            like = ShapeDtype.of(data)

            def enc():
                return [codec.encode(noise.worker(None), data)]

        sent = enc()

        def dec():
            return [codec.decode(payload, meta, like)
                    for payload, meta in sent]

        return {"encode_s": float(time_fn(enc, iters=iters)),
                "decode_s": float(time_fn(dec, iters=iters))}

    def codec_quality(self, *, cap_bytes: int = 1 << 18, seed: int = 0,
                      device=None) -> Dict[str, Optional[float]]:
        """Measured ``{"omega_hat", "nmse"}`` of ONE payload of this
        wire's traffic through its codec (``obs.quality``), the shape as
        ``codec_timings`` picks it (within ``cap_bytes``).  The probe
        runs the wire's REAL encode path per topology (allreduce: each
        worker row with its own draws; everything else: whole-block
        encode/decode).  Unlike timings, a FUSED wire is probed too --
        fusing deletes the standalone launch, not the distortion.
        Nones when no traffic is declared.
        """
        if not self.traffic:
            return {"omega_hat": None, "nmse": None}
        from repro_torch.obs.quality import array_distortion

        data, noise = self._probe(cap_bytes, seed, device)
        out = array_distortion(self.codec, noise, data,
                               topology=self.topology)
        err = float(out["err_sq"])
        norm = float(out["norm_sq"])
        nmse = err / norm if norm > 0.0 else 0.0
        return {"omega_hat": nmse, "nmse": nmse}


class Transport:
    """Per-step registry of every Wire.  Dict-like: ``transport["grad"]``,
    ``"model" in transport``, ``transport.get("model")``."""

    def __init__(self, wires=()):
        self._wires: Dict[str, Wire] = {}
        for wire in wires:
            self.register(wire)

    def register(self, wire: Wire) -> Wire:
        if wire.name in self._wires:
            raise ValueError(f"wire {wire.name!r} already registered "
                             f"(have {sorted(self._wires)})")
        self._wires[wire.name] = wire
        return wire

    def __contains__(self, name) -> bool:
        return name in self._wires

    def __getitem__(self, name) -> Wire:
        if name not in self._wires:
            raise KeyError(f"no wire {name!r} registered; have "
                           f"{sorted(self._wires)}")
        return self._wires[name]

    def get(self, name, default=None) -> Optional[Wire]:
        return self._wires.get(name, default)

    def __iter__(self):
        return iter(self._wires.values())

    def __len__(self) -> int:
        return len(self._wires)

    def names(self):
        return tuple(self._wires)

    def per_wire_bits(self) -> Dict[str, float]:
        """{wire name: per-step wire bits}."""
        return {name: wire.wire_bits() for name, wire in self._wires.items()}

    def obs_snapshot(self, *, timed: bool = False, quality: bool = False,
                     device=None) -> Dict[str, dict]:
        """Per-wire telemetry dict for the obs run header: topology,
        codec, structural ``wire_bits`` AND actual ``payload_bytes`` per
        step, plus (with ``timed``) measured encode/decode seconds and
        (with ``quality``) measured ``omega_hat``/``nmse`` of one
        payload, measured on ``device`` (default: the CUDA device).
        Keys match what ``repro_torch.obs.export`` renders."""
        snap: Dict[str, dict] = {}
        for name, wire in self._wires.items():
            timings = (wire.codec_timings(device=device) if timed
                       else {"encode_s": None, "decode_s": None})
            qual = (wire.codec_quality(device=device) if quality
                    else {"omega_hat": None, "nmse": None})
            snap[name] = {
                "topology": wire.topology,
                "codec": type(wire.codec).__name__,
                "wire_bits": wire.wire_bits(),
                "payload_bytes": wire.payload_nbytes(),
                "fused": wire.fused,
                **timings,
                **qual,
            }
        return snap

    def extra_traffic(self) -> Dict[str, Tuple]:
        """Declared traffic of every NON-grad wire, keyed by name — the
        ``wire_traffic`` dict the tune predictor charges."""
        return {
            name: wire.traffic
            for name, wire in self._wires.items()
            if name != "grad" and wire.traffic
        }


@dataclass(frozen=True)
class SendDraw:
    """The draws of one send on a forwarded-payload wire: ``source`` is
    the wire's stream at the step's round, ``address`` ``(layer, worker,
    group, part)``.  Called with a shape it gives uniforms; its
    ``permutation(d)`` an index draw (Rand-K)."""

    source: Any
    address: Tuple

    def __call__(self, shape) -> torch.Tensor:
        return self.source.send_uniform(self.address, tuple(shape))

    def permutation(self, d: int) -> torch.Tensor:
        return self.source.send_permutation(self.address, d)


class WorkerWireNoise:
    """One worker's draws on the ``act`` and ``moe`` wires of one step:
    each wire's stream (``wire_stream``) at the round of ``noise``, a
    send addressed by (layer, worker, group, part) -- the reference's
    ``wire_stream(key, "transport")`` split over the workers, then
    ``wire_stream(key, "moe" / "act")`` folded by layer and group and
    split into dispatch and combine."""

    def __init__(self, noise, worker: int):
        self.worker = worker
        self._streams = {name: wire_stream(noise, name).at_round(noise.round)
                         for name in ("act", "moe")}

    def act(self, layer: int) -> SendDraw:
        """The draws of layer ``layer``'s block-boundary send."""
        return SendDraw(self._streams["act"], (layer, self.worker, None, None))

    def moe(self, layer: int, group: int, part: str) -> SendDraw:
        """The draws of MoE layer ``layer``'s send ``part`` (``"dispatch"``
        or ``"combine"``) of token group ``group``."""
        return SendDraw(self._streams["moe"], (layer, self.worker, group,
                                               part))


def build_transport(comp, cfg, channel, *, rule=None, msg_codec=None,
                    w: int = 1, params_like=None,
                    tokens_per_worker: int = 0) -> Transport:
    """The standard per-step Transport of one run.

    The ``grad`` wire always: its accounting codec is
    ``aggregation_wire_codec(comp)``, its engine objects ``rule`` /
    ``msg_codec`` (None for an accounting-only transport).  The
    ``model`` wire (``broadcast``) when ``comp.model_wire`` is set: one
    params-shaped payload per publish, its traffic counted ``1 /
    publish_every`` a step.  ``params_like`` (``{path: anything with
    .shape and .dtype}``) declares the grad wire's traffic as
    worker-stacked leaves and the model wire's as the leaves themselves;
    omit it for a transport that never reads ``per_wire_bits``.  The
    grad wire's ``overlap_hidden`` is ``tune.model.OVERLAP_HIDE`` and its
    ``fused`` set on the modes that earn them, as the reference sets
    them.

    The ``moe`` wire (``all_to_all``) and the ``act`` wire (``p2p``)
    when their flags are set, their traffic declared when
    ``tokens_per_worker`` is known: the moe wire 2 sends of the (E, C,
    D) expert buffer per group per MoE layer per worker
    (``models.moe.moe_wire_traffic``), the act wire one (tokens,
    d_model) send per layer per worker.  Each raises the reference's
    ``ValueError`` for an architecture that cannot carry it.
    """
    from repro_torch.comm.channel import FUSED_VJP_MODES, OVERLAP_MODES

    meta = torch.device("meta")
    leaves = [] if params_like is None else list(params_like.values())
    enabled = getattr(comp, "enabled", False)
    hidden = 0.0
    if enabled and comp.comm_mode in OVERLAP_MODES + FUSED_VJP_MODES:
        from repro_torch.tune.model import OVERLAP_HIDE

        hidden = OVERLAP_HIDE
    wires = [Wire(
        name="grad", topology="allreduce",
        codec=aggregation_wire_codec(comp), channel=channel, rule=rule,
        msg_codec=msg_codec,
        traffic=tuple((ShapeDtype((w, *leaf.shape), leaf.dtype, meta), 1)
                      for leaf in leaves),
        overlap_hidden=hidden,
        fused=enabled and comp.comm_mode in FUSED_VJP_MODES,
    )]
    moe_flag = getattr(comp, "moe_wire", "none")
    if moe_flag != "none":
        if not cfg.is_moe:
            raise ValueError(
                f"moe_wire {moe_flag!r} needs a MoE architecture; "
                f"{cfg.name!r} has n_experts={cfg.n_experts}")
        from repro_torch.models.moe import moe_wire_traffic

        traffic = ()
        if tokens_per_worker > 0:
            n_moe_layers = cfg.n_layers - cfg.first_dense_layers
            traffic = tuple(
                (like, count * n_moe_layers * w)
                for like, count in moe_wire_traffic(cfg, tokens_per_worker))
        wires.append(Wire(
            name="moe", topology="all_to_all",
            codec=wire_flag_codec(moe_flag, randk_q=comp.randk_q),
            channel=channel, traffic=traffic))

    act_flag = getattr(comp, "act_wire", "none")
    if act_flag != "none":
        if cfg.arch_type not in ("dense", "vlm", "moe"):
            raise ValueError(
                f"act_wire {act_flag!r} supports arch_type dense|vlm|moe "
                f"(residual-stream blocks); {cfg.name!r} is "
                f"{cfg.arch_type!r}")
        traffic = ()
        if tokens_per_worker > 0:
            traffic = ((ShapeDtype((tokens_per_worker, cfg.d_model),
                                   getattr(torch, cfg.dtype), meta),
                        cfg.n_layers * w),)
        wires.append(Wire(
            name="act", topology="p2p",
            codec=wire_flag_codec(act_flag, randk_q=comp.randk_q),
            channel=channel, traffic=traffic))

    model_flag = getattr(comp, "model_wire", "none")
    if model_flag != "none":
        every = max(1, int(getattr(comp, "publish_every", 1)))
        wires.append(Wire(
            name="model", topology="broadcast",
            codec=wire_flag_codec(model_flag, randk_q=comp.randk_q),
            channel=channel,
            traffic=tuple((ShapeDtype(tuple(leaf.shape), leaf.dtype, meta),
                           1.0 / every) for leaf in leaves),
        ))
    return Transport(wires)
