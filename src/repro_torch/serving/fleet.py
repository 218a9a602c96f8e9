"""The subscriber fleet: N continuous-batching replicas on one delta
stream -- the port of the reference's ``repro/serving/fleet.py``.

Each ``Replica`` wraps an ``Engine`` and applies queued ``DeltaMsg``s
BETWEEN decode ticks.  The fleet tracks per-replica staleness (trainer
steps behind the last applied message) and asks for a dense ``resync``
when a replica falls more than ``stale_k`` steps behind or its stream
error (the publisher's ``err_rel``, exact for an in-sync replica)
exceeds ``err_budget``.  A pending resync supersedes everything queued
before it: a lagging replica fast-forwards to the snapshot.

``TrainerFleetBridge`` is the glue a training loop needs: the
publisher, the publish cadence, the resync policy, and one
``on_step(params, step)`` hook.  Its ``stats()`` are read from the
events the fleet emitted, so the printed row and the event stream
cannot disagree.  ``run_fleet_demo`` co-simulates the port's smoke
trainer (``launch.train.build_train_step``) with a serving fleet.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

from repro_torch.obs import MemorySink, TeeSink, event_record
from repro_torch.serving.delta import DeltaMsg, DeltaPublisher, apply_msg
from repro_torch.serving.engine import Engine, Request


class Replica:
    """One serving replica subscribed to the delta stream."""

    def __init__(self, rid: int, cfg, params, *, max_batch: int = 2,
                 cache_len: int = 128, obs=None):
        self.rid = rid
        self.engine = Engine(cfg, params, max_batch=max_batch,
                             cache_len=cache_len)
        self.step = 0          # trainer step of the params being served
        self.seq = 0           # last applied stream sequence number
        self.err_rel = 0.0     # stream error of the served params
        self.applied = 0       # delta messages applied
        self.resyncs = 0       # dense resyncs applied
        self.obs = obs         # optional record sink: resync-apply events
        self.pending: deque = deque()

    @property
    def params(self):
        return self.engine.params

    def enqueue(self, msg: DeltaMsg) -> None:
        self.pending.append(msg)

    def _fast_forward(self) -> None:
        """Drop every message queued before the LAST pending resync."""
        last = None
        for i, msg in enumerate(self.pending):
            if msg.kind == "resync":
                last = i
        if last:
            for _ in range(last):
                self.pending.popleft()

    def apply_pending(self, limit: Optional[int] = None) -> int:
        """Apply queued messages in stream order (between decode ticks),
        at most ``limit`` (the knob that makes staleness real in
        simulation).  Returns the number applied."""
        self._fast_forward()
        n = 0
        while self.pending and (limit is None or n < limit):
            msg = self.pending.popleft()
            self.engine.update_params(apply_msg(self.engine.params, msg))
            self.step = msg.step
            self.seq = msg.seq
            self.err_rel = msg.err_rel
            if msg.kind == "resync":
                self.resyncs += 1
                if self.obs is not None:
                    self.obs.emit(event_record(
                        "fleet_resync", max(0, msg.step), replica=self.rid,
                        seq=msg.seq, bytes=msg.bits / 8.0))
            else:
                self.applied += 1
            n += 1
        return n

    def staleness(self, trainer_step: int) -> int:
        return trainer_step - self.step

    def load(self) -> int:
        """Admission pressure: occupied slots + queued requests."""
        busy = sum(0 if s.free else 1 for s in self.engine.slots)
        return busy + len(self.engine.queue)


class ServingFleet:
    """N replicas, one stream: deliver -> apply between ticks -> decode.
    Built from the publisher's ``initial_sync`` message, so every replica
    starts in lockstep with the publisher's ``h_bar``."""

    def __init__(self, cfg, sync_msg: DeltaMsg, n_replicas: int, *,
                 stale_k: int = 4, err_budget: Optional[float] = None,
                 max_batch: int = 2, cache_len: int = 128,
                 max_apply_per_tick: Optional[int] = None, obs=None):
        if sync_msg.kind != "resync":
            raise ValueError("a fleet bootstraps from a full-model sync "
                             f"message, not {sync_msg.kind!r}")
        self.obs = obs
        self.replicas: List[Replica] = [
            Replica(r, cfg, sync_msg.payload, max_batch=max_batch,
                    cache_len=cache_len, obs=obs)
            for r in range(n_replicas)
        ]
        for rep in self.replicas:
            rep.step = sync_msg.step
            rep.seq = sync_msg.seq
            rep.err_rel = sync_msg.err_rel
        self.trainer_step = sync_msg.step
        self.stale_k = stale_k
        self.err_budget = err_budget
        self.max_apply_per_tick = max_apply_per_tick
        self.max_staleness_seen = 0
        self._rr = 0

    def submit(self, req: Request) -> Replica:
        """Admit to the least-loaded replica (round-robin tie-break)."""
        order = sorted(range(len(self.replicas)),
                       key=lambda i: (self.replicas[i].load(),
                                      (i - self._rr) % len(self.replicas)))
        rep = self.replicas[order[0]]
        self._rr = (rep.rid + 1) % len(self.replicas)
        rep.engine.submit(req)
        return rep

    def deliver(self, msg: DeltaMsg) -> None:
        """Broadcast one stream message to every replica's queue."""
        self.trainer_step = max(self.trainer_step, msg.step)
        for rep in self.replicas:
            rep.enqueue(msg)

    def tick(self) -> List[Request]:
        """One fleet tick: each replica applies pending deltas, then
        runs one shared-clock decode tick.  Returns finished requests."""
        finished: List[Request] = []
        for rep in self.replicas:
            rep.apply_pending(self.max_apply_per_tick)
            stale = rep.staleness(self.trainer_step)
            if stale > self.max_staleness_seen and self.obs is not None:
                self.obs.emit(event_record(
                    "fleet_staleness", max(0, self.trainer_step),
                    replica=rep.rid, staleness=stale))
            self.max_staleness_seen = max(self.max_staleness_seen, stale)
            finished.extend(rep.engine.step_tick())
        return finished

    def needs_resync(self) -> List[Replica]:
        """Replicas over the staleness bound K or the error budget."""
        out = []
        for rep in self.replicas:
            stale = rep.staleness(self.trainer_step) > self.stale_k
            err = (self.err_budget is not None
                   and rep.err_rel > self.err_budget)
            if stale or err:
                out.append(rep)
        return out

    def idle(self) -> bool:
        return all(rep.engine.idle() for rep in self.replicas)

    def run_drain(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until every replica's queue and slots drain."""
        finished: List[Request] = []
        for _ in range(max_ticks):
            if self.idle():
                break
            finished.extend(self.tick())
        return finished

    def staleness_by_replica(self):
        return {rep.rid: rep.staleness(self.trainer_step)
                for rep in self.replicas}


class TrainerFleetBridge:
    """Glue between a training loop and a serving fleet.

    Owns the ``DeltaPublisher`` (over the transport's model wire), the
    publish cadence and the resync policy.  The training loop calls
    ``on_step(params, step)`` after every optimizer step, ``step``
    counting COMPLETED steps from 1; publishes happen every
    ``publish_every`` steps, each followed by one fleet tick (apply +
    decode) and a resync check on the APPLIED state.  ``noise`` is the
    publisher's (``DeltaPublisher``).
    """

    def __init__(self, cfg, params, wire, *, n_replicas: int,
                 publish_every: int = 1, stale_k: int = 4,
                 err_budget: Optional[float] = None, eta: float = 1.0,
                 sync_codec=None, noise=None, max_batch: int = 2,
                 cache_len: int = 128,
                 max_apply_per_tick: Optional[int] = None, obs=None):
        from repro_torch.core.shift_rules import EFBVShift

        # every event lands in the bridge's own MemorySink (``stats``
        # reads from it) AND fans out to the caller's sink
        self.events = MemorySink()
        self._obs = TeeSink(self.events, obs)
        self.publisher = DeltaPublisher(wire, rule=EFBVShift(eta=eta),
                                        noise=noise)
        sync = self.publisher.initial_sync(params, step=0,
                                           sync_codec=sync_codec)
        self.sync_bits = sync.bits
        self._obs.emit(event_record(
            "fleet_bootstrap", 0, replicas=n_replicas,
            bytes=sync.bits / 8.0))
        self.fleet = ServingFleet(
            cfg, sync, n_replicas, stale_k=stale_k, err_budget=err_budget,
            max_batch=max_batch, cache_len=cache_len,
            max_apply_per_tick=max_apply_per_tick, obs=self._obs)
        self.publish_every = max(1, publish_every)
        self.finished: List[Request] = []

    def on_step(self, params, step: int) -> Optional[DeltaMsg]:
        if step % self.publish_every:
            return None
        msg = self.publisher.publish(params, step=step)
        self._obs.emit(event_record(
            "publish", step, seq=msg.seq, bytes=msg.bits / 8.0,
            err_rel=msg.err_rel,
            # the downlink's quality in the NMSE units of the wire probes
            nmse=msg.err_rel ** 2))
        self.fleet.deliver(msg)
        self.finished.extend(self.fleet.tick())
        lagging = self.fleet.needs_resync()
        if lagging:
            snap = self.publisher.snapshot(params, step=step)
            for rep in lagging:
                stale = rep.staleness(self.fleet.trainer_step)
                reason = ("staleness" if stale > self.fleet.stale_k
                          else "err_budget")
                self._obs.emit(event_record(
                    "resync_requested", step, replica=rep.rid,
                    reason=reason, staleness=stale, err_rel=rep.err_rel,
                    bytes=snap.bits / 8.0))
            self.fleet.deliver(snap)
            self.finished.extend(self.fleet.tick())
        return msg

    def drain(self, max_ticks: int = 10_000) -> List[Request]:
        self.finished.extend(self.fleet.run_drain(max_ticks))
        return self.finished

    def stats(self) -> dict:
        """The bridge's ledger; ``publishes``, ``resyncs``,
        ``max_staleness`` and ``err_rel`` come from the events the fleet
        emitted."""
        dense = self.publisher.dense_bits_per_publish()
        publishes = self.events.events("publish")
        deltas = [e["data"]["bytes"] * 8.0 for e in publishes]
        per_publish = (sum(deltas) / len(deltas)) if deltas else 0.0
        stale_events = self.events.events("fleet_staleness")
        names = [e["name"] for e in self.events.by_kind("event")]
        return {
            "publishes": len(publishes),
            "resyncs": len(self.events.events("fleet_resync")),
            "sync_bytes": self.sync_bits / 8.0,
            "delta_bytes": [b / 8.0 for b in deltas],
            "delta_bytes_per_publish": per_publish / 8.0,
            "delta_bytes_per_step": per_publish / 8.0 / self.publish_every,
            "dense_bytes_per_publish": dense / 8.0,
            "dense_bytes_per_step": dense / 8.0 / self.publish_every,
            "bytes_fraction": (per_publish / dense) if dense else 0.0,
            "err_rel": [e["data"]["err_rel"] for e in publishes],
            "max_staleness": max(
                (e["data"]["staleness"] for e in stale_events),
                default=self.fleet.max_staleness_seen),
            "staleness": self.fleet.staleness_by_replica(),
            "requests_done": len(self.finished),
            "tokens_served": sum(len(r.output) for r in self.finished),
            "obs_events": {n: names.count(n) for n in sorted(set(names))},
        }


def run_fleet_demo(arch: str = "qwen3-0.6b", *, n_replicas: int = 2,
                   model_wire: str = "q8", publish_every: int = 2,
                   stale_k: int = 4, steps: int = 6, batch: int = 4,
                   seq: int = 64, lr: float = 1e-2, n_requests: int = 6,
                   gen_len: int = 8, max_batch: int = 2,
                   cache_len: int = 64, err_budget: Optional[float] = None,
                   max_apply_per_tick: Optional[int] = None,
                   sync_flag: str = "natural", seed: int = 0,
                   obs=None, device=None) -> dict:
    """Co-simulate the port's smoke trainer with a serving fleet.

    Runs ``steps`` train steps (``launch.train.build_train_step``, dense
    aggregation, compression off) of the smoke variant of ``arch`` while
    ``n_replicas`` engines serve ``n_requests`` synthetic prompts off the
    delta stream; returns the stats row (the reference's
    ``BENCH_serve_delta.json`` row).  On the CUDA device unless
    ``device`` says else.  Params, data and prompts are torch's draws
    from ``seed``, the stream's noise ``AddressedNoise(seed + 1)``.
    """
    import math

    import torch

    from repro_torch.comm.channel import SimChannel
    from repro_torch.comm.transport import build_transport, wire_flag_codec
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CompressionConfig, TrainConfig
    from repro_torch.core.compressors import ShapeDtype
    from repro_torch.data.tokens import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, n_workers
    from repro_torch.launch.train import build_train_step, init_state
    from repro_torch.models.model import param_specs

    dev = resolve_device(device)
    cfg = get_smoke_config(arch).with_(dtype="float32")
    mesh = make_host_mesh(dev)
    w = n_workers(mesh)
    comp = CompressionConfig(enabled=False, model_wire=model_wire,
                             publish_every=publish_every)
    tcfg = TrainConfig(learning_rate=lr, total_steps=steps, warmup_steps=1,
                       compression=comp)
    like = {path: ShapeDtype(shape, torch.float32, torch.device("meta"))
            for path, shape, _ in param_specs(cfg)}
    transport = build_transport(comp, cfg, SimChannel(), w=w,
                                params_like=like)

    state = init_state(seed, cfg, tcfg, w, dev)
    step_fn = build_train_step(cfg, tcfg, w, mesh)
    stream = TokenStream(cfg, seq, batch)

    bridge = TrainerFleetBridge(
        cfg, state.params, transport["model"], n_replicas=n_replicas,
        publish_every=publish_every, stale_k=stale_k, err_budget=err_budget,
        noise=AddressedNoise(seed + 1, dev), max_batch=max_batch,
        cache_len=cache_len, max_apply_per_tick=max_apply_per_tick,
        sync_codec=wire_flag_codec(sync_flag), obs=obs)
    gen = torch.Generator().manual_seed(seed + 2)
    for i in range(n_requests):
        prompt = torch.randint(0, cfg.vocab_size, (2 + i % 3,),
                               generator=gen).tolist()
        bridge.fleet.submit(Request(uid=i, prompt=prompt,
                                    max_new_tokens=gen_len))

    loss = math.nan
    for i in range(steps):
        state, metrics = step_fn(state, stream.batch(i, dev))
        loss = float(metrics["loss"])
        bridge.on_step(state.params, i + 1)
    bridge.drain()

    stats = bridge.stats()
    stats.update({
        "arch": cfg.name, "model_wire": model_wire,
        "n_replicas": n_replicas, "publish_every": publish_every,
        "stale_k": stale_k, "steps": steps, "final_loss": loss,
        "wire_bytes_per_step": {
            name: bits / 8.0
            for name, bits in transport.per_wire_bits().items()},
    })
    return stats
