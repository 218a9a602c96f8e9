"""Training step with shifted compression -- Algorithm 1 (DCGD-SHIFT) as
the production step, the port of the reference's
``repro/launch/train.py`` for this slice.

One step: per-worker gradients (``dist.worker_grads``, W workers stacked
on one device; with the moe and act wires set, each worker's forward
sends its MoE layers' expert buffers and its blocks' outputs through
them, ``comm.transport``), one shift-rule round through the transport's grad wire
(``comm.transport``: ``rule.round``, message -> aggregate -> apply,
through the channel; the codec's encode and decode run the CUDA kernels
on a GPU, and so do the hops of the ``q8_ring_fused`` aggregation over
the mesh's ``data`` axis, each ``model`` shard's ring and the pod
stage), then AdamW.  ``build_channel`` gives the ring and
``randk_shared`` modes the worker-stacked specs of ``dist.sharding``
(``HostMesh(pod=2, data=2, model=2)`` runs the reference's production
layout on one device).  The overlap modes (``q8_ring_overlap``, ``efbv_overlap``) run
the round bucket by bucket (``comm.overlap``); ``q8_ring_fused_vjp``
encodes each worker's messages inside its backward pass
(``comm.fused_vjp``) and runs only the round's reduce/apply tail.
There is no per-rule math here.  ``diag=True`` adds the shift rules'
diagnostics (``ef_err_norm``, ``grad_sq``, ``shift_residual_sq``,
``h_bar_drift``) to the metrics, and nothing else: the state is bitwise
the ``diag=False`` state.  The reference splits a PRNG key per
step; the port draws the round's uniforms from the state's noise source
(``comm.wire``: by default ``AddressedNoise``, whose draws do not depend
on the order of the calls), which the step moves to the next round at
its end.

State is updated in place (params, moments, shifts); see the modules
that do it.

The step's phases (``train/grads``, ``train/reduce``, ``train/round``,
``train/apply``) are profiler annotations (``obs.trace.annotate``): they
tag the work for a running ``torch.profiler`` and add no clock, no
synchronisation and no op; with no profiler running ``obs`` is not even
imported.  ``--metrics_out`` writes the reference's obs records (strict
JSONL): a ``run`` header (per-wire telemetry with measured codec
timings and quality, the measured overlap hide fraction, the nominal
predicted step time), one ``step`` record a step (the step's wall clock
ends in a device synchronisation), the ``drift_resync`` events and a
``summary``; it turns ``diag`` on, and the returned state stays bitwise
the uninstrumented run's.  ``--trace`` records the ``host/step`` span.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
          [--smoke] [--steps N] [--batch B] [--seq S] \
          [--compressor natural|topk|randk|q8_block|...] \
          [--shift-rule diana|rand_diana|vr_gdci|...] \
          [--comm-mode dense|randk_shared|q8_ring|q8_ring_fused|ef21|
                       efbv|q8_ring_overlap|efbv_overlap|
                       q8_ring_fused_vjp] \
          [--drift-resync-every N] [--efbv-eta ETA] [--efbv-nu NU] \
          [--moe-wire none|dense|q8|...] [--act-wire none|dense|q8|...] \
          [--model-wire none|dense|q8|natural|... [--publish_every N] \
           [--serve_fleet N] [--stale_k K]] \
          [--lr LR] [--no-compression] [--device cuda|cpu] \
          [--mesh-data N] [--metrics_out RUN.jsonl] [--trace]

The worker count is the size of the host mesh's ``data`` axis, as in the
reference: the CUDA device count, or 1 on the CPU; ``--mesh-data N``
puts N positions on the one device instead (the counterpart of the
reference's emulated devices).
"""

from __future__ import annotations

import argparse
import time
from contextlib import nullcontext
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm import fused_vjp
from repro_torch.comm.channel import (
    CHANNEL_MODES,
    FUSED_VJP_MODES,
    SimChannel,
    make_channel,
    resync_h_bar,
)
from repro_torch.comm.transport import (
    WIRE_CODEC_FLAGS,
    WorkerWireNoise,
    build_transport,
)
from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import CompressionConfig, ModelConfig, TrainConfig
from repro_torch.core.compressors import ShapeDtype, f32_bits
from repro_torch.core.iterate_comp import VRGDCI
from repro_torch.core.shift_rules import SHIFT_RULES, residual_sq_diag
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import dense_mean
from repro_torch.dist.sharding import (
    PSpec,
    params_pspecs,
    validate_pspecs,
    worker_stacked_pspec,
    worker_stacked_pspecs,
)
from repro_torch.dist.worker_grads import per_worker_grads, split_batch
from repro_torch.launch.mesh import HostMesh, make_host_mesh, n_workers
from repro_torch.models import model as M
from repro_torch.optim.optimizers import OptState, make_optimizer

#: CLI comm modes: the channel registry minus the reference-only
#: parameter server (unported modes raise from ``make_channel``)
COMM_MODES = tuple(m for m in CHANNEL_MODES if m != "sim")

#: CLI shift rules, the reference's: the registry minus the oracle rule
#: (it needs the gradients at the optimum) plus the iterate-compression
#: Algorithm 2
SHIFT_RULE_CHOICES = tuple(
    r for r in SHIFT_RULES if r != "star"
) + ("vr_gdci",)


class TrainState(NamedTuple):
    params: Any
    opt: Any
    h: Any              # worker-stacked shifts (None for stateless rules)
    h_bar: Any          # master aggregated shift (None if stateless)
    noise: Any          # the rounds' uniform source (comm.wire), moved
                        # to the next round at the end of every step
    step: int
    bits: torch.Tensor  # cumulative uplink bits, f32 0-d: on the CPU,
                        # on the device once a drawn count enters it
                        # (Rand-DIANA's refreshes)


def init_state(seed: int, cfg: ModelConfig, tcfg: TrainConfig, w: int,
               device=None) -> TrainState:
    """Params from ``seed``, the round noise from ``seed + 1``, zero
    moments and shifts; on the CUDA device unless ``device`` says else."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(cfg, generator=gen, device=dev)
    opt = make_optimizer(tcfg).init(params)
    comp = tcfg.compression
    if comp.enabled:
        _, rule = comp.make(learning_rate=tcfg.learning_rate)
        h, h_bar = rule.init(params, w), rule.init_bar(params)
    else:
        h = h_bar = None
    return TrainState(params, opt, h, h_bar, AddressedNoise(seed + 1, dev),
                      0, f32_bits())


def worker_loss(cfg: ModelConfig, rule=None, q=None, wires=None):
    """One worker's ``loss_fn(params, batch) -> (loss, metrics)``.  With
    ``rule`` and ``q`` (the fused mode) its batch carries the worker's
    draws and shifts (``with_fused_draws``), and the params are tapped
    with them: the gradient of the loss IS the worker's decoded wire
    message (``comm.fused_vjp``).  With ``wires`` (a transport holding
    the moe or act wire) its batch carries the worker's draws on them
    (``wire_noise``, ``comm.transport.WorkerWireNoise``)."""
    def loss_fn(params, batch):
        tap = wire_noise = None
        if rule is not None or wires is not None:
            batch = dict(batch)
        if rule is not None:
            draws, fh = batch.pop("fused_draws"), batch.pop("fused_h", None)
            tap = lambda p: fused_vjp.encode_on_backward(  # noqa: E731
                rule, q, p, draws, fh)
        if wires is not None:
            wire_noise = batch.pop("wire_noise")
        return M.train_loss(params, cfg, batch, param_tap=tap, wires=wires,
                            wire_noise=wire_noise)

    return loss_fn


def with_fused_draws(wbatch, rule, q, state: TrainState, w: int):
    """``wbatch`` (split per worker) with, per worker, its draw of every
    leaf (row j of ``round_message_draws``) and its rows of the shifts,
    riding the worker batch into ``worker_loss``."""
    draws = fused_vjp.round_message_draws(rule, q, state.noise, state.params,
                                          w)
    wbatch = dict(wbatch, fused_draws=[[d[j] for d in draws]
                                       for j in range(w)])
    if state.h is not None:
        wbatch["fused_h"] = [{k: v[j] for k, v in state.h.items()}
                             for j in range(w)]
    return wbatch


def params_like(cfg: ModelConfig) -> dict:
    """``{path: ShapeDtype}`` of ``cfg``'s params, on the meta device."""
    return {path: ShapeDtype(tuple(shape), M.leaf_dtype(cfg, init),
                             torch.device("meta"))
            for path, shape, init in M.param_specs(cfg)}


def build_channel(comp: CompressionConfig, cfg: ModelConfig,
                  mesh: Optional[HostMesh], w: int):
    """The channel of this run over ``mesh`` (``None``: one position),
    with the worker-stacked specs of ``dist.sharding`` when the
    aggregation runs on the ring or in ``randk_shared`` and a mesh is
    given: each ``model`` shard of a leaf then runs its own ring."""
    wspecs = None
    if (comp.enabled and mesh is not None and comp.aggregation_mode in
            ("q8_ring", "q8_ring_fused", "randk_shared")):
        wspecs = worker_stacked_pspecs(mesh, params_like(cfg), w)
    return make_channel(comp, HostMesh() if mesh is None else mesh,
                        wspecs=wspecs)


def _tree_dist(a, b) -> torch.Tensor:
    """The l2 distance ``||a - b||`` over two trees, in f32."""
    sq = None
    for k, x in a.items():
        d = x.to(torch.float32) - b[k].to(torch.float32)
        s = torch.sum(d * d)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _worker_mean_f32(wtree):
    return dense_mean({k: v.to(torch.float32) for k, v in wtree.items()})


def _phase(name: str):
    """The profiler tag of one step phase (``obs.trace.annotate``); with
    no profiler running, nothing at all (``obs`` is not imported)."""
    if not torch.autograd._profiler_enabled():
        return nullcontext()
    from repro_torch.obs.trace import annotate

    return annotate(name)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, w: int,
                     mesh: Optional[HostMesh] = None, diag: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is ``{"tokens": (B, S)}`` on the state's device, B divisible by ``w``.
    The ring aggregation modes run over ``mesh`` (``None``: one position,
    where the ring is the exact sum), with its ``model`` shards and pod
    stage (``build_channel``).  Every round goes through the transport's
    grad wire, its noise passed on as given.

    ``diag=True`` adds the shift rules' diagnostics to the METRICS only:
    ``ef_err_norm`` (||g_bar - mean_i g_i||, the round's compression
    error), ``grad_sq`` and ``shift_residual_sq`` (``residual_sq_diag``
    against the shifts BEFORE the round, what the wire carried) and
    ``h_bar_drift`` (||h_bar - mean_i h_i||, what ``resync_h_bar``
    bounds); the fused mode has no dense gradients, so only the drift.
    They consume no draws and feed nothing back: the state is bitwise
    the ``diag=False`` state.  Iterate-compression and uncompressed
    steps add none, as the reference's.
    """
    if tcfg.train_attn_chunk > 0:
        cfg = cfg.with_(attn_q_chunk=tcfg.train_attn_chunk)
    comp = tcfg.compression
    optimizer = make_optimizer(tcfg)
    channel = build_channel(comp, cfg, mesh, w)
    q, rule = (comp.make(learning_rate=tcfg.learning_rate) if comp.enabled
               else (None, None))
    iterate_rule = isinstance(rule, VRGDCI)
    fused = comp.enabled and comp.comm_mode in FUSED_VJP_MODES
    if fused:
        if iterate_rule:
            raise ValueError(
                "comm_mode 'q8_ring_fused_vjp' fuses GRADIENT-message "
                "encode into the backward pass; the iterate-compression "
                "rule 'vr_gdci' has no gradient message to fuse"
            )
        fused_vjp.check_fusible(rule)
    # every wire of the step is registered on the transport: the grad
    # wire wraps the channel and the rule, the moe and act wires (when
    # set) ride into the forward pass
    transport = build_transport(comp, cfg, channel, rule=rule, msg_codec=q,
                                w=w)
    grad_wire = transport["grad"]
    wired = "moe" in transport or "act" in transport
    loss_fn = worker_loss(cfg, rule if fused else None, q if fused else None,
                          wires=transport if wired else None)

    def train_step(state: TrainState, batch):
        wbatch = split_batch(batch, w)
        if wired:
            # each worker's draws on the moe / act wires, addressed by
            # (round, wire, worker, layer, group, part)
            wbatch["wire_noise"] = [WorkerWireNoise(state.noise, j)
                                    for j in range(w)]
        if fused:
            wbatch = with_fused_draws(wbatch, rule, q, state, w)
        with _phase("train/grads"):
            grads, loss, metrics = per_worker_grads(loss_fn, state.params,
                                                    wbatch)
        extra = {}
        if not comp.enabled:
            with _phase("train/reduce"):
                g_bar = grad_wire.reduce_mean(state.noise, grads)
            h, h_bar, bits = state.h, state.h_bar, state.bits
        elif iterate_rule:
            # Algorithm 2: the round mixes the iterate itself (in place)
            with _phase("train/round"):
                params, h, h_bar, step_bits = grad_wire.iterate_round(
                    state.noise, state.params, grads, state.h, state.h_bar)
            state.noise.next_round()
            new_state = TrainState(params, state.opt, h, h_bar, state.noise,
                                   state.step + 1, state.bits + step_bits)
            return new_state, {**metrics, "loss": loss,
                               "bits": new_state.bits}
        else:
            if diag and not fused:
                # against the shifts BEFORE the round, which updates them
                # in place
                extra.update(residual_sq_diag(grads, state.h))
            with _phase("train/round"):
                if fused:   # ``grads`` are the decoded messages already
                    g_bar, h, h_bar, step_bits = grad_wire.fused_round(
                        state.noise, grads, state.h, state.h_bar)
                else:
                    g_bar, h, h_bar, step_bits = grad_wire.shift_round(
                        state.noise, grads, state.h, state.h_bar)
                # bound the shift-tracking drift of lossy aggregation
                h_bar = resync_h_bar(h, h_bar, state.step,
                                     comp.drift_resync_every)
            bits = state.bits + step_bits
            if diag:
                if not fused:
                    extra["ef_err_norm"] = _tree_dist(
                        g_bar, _worker_mean_f32(grads))
                if h is not None and h_bar is not None:
                    extra["h_bar_drift"] = _tree_dist(h_bar,
                                                      _worker_mean_f32(h))
        del grads
        with _phase("train/apply"):
            params, opt = optimizer.update(g_bar, state.opt, state.params)
        state.noise.next_round()
        new_state = TrainState(params, opt, h, h_bar, state.noise,
                               state.step + 1, bits)
        return new_state, {**metrics, "loss": loss, "bits": bits, **extra}

    return train_step


def state_pspecs(state_shapes: TrainState, mesh, tcfg: TrainConfig
                 ) -> TrainState:
    """Partition specs of a ``TrainState`` (its leaves anything with
    ``.shape``), validated against the mesh: params (FSDP per
    ``tcfg.fsdp_params``), the AdamW moments (over ``data`` per
    ``tcfg.zero_opt_state``), the worker-stacked shifts and the FSDP
    master shift; the noise, step and bits replicated."""
    def of(tree, fsdp):
        return validate_pspecs(tree, params_pspecs(tree, fsdp=fsdp), mesh)

    params = state_shapes.params
    h_specs = hb_specs = None
    if state_shapes.h is not None:
        inner = params_pspecs(params, fsdp=False)
        h_specs = validate_pspecs(
            state_shapes.h,
            {k: worker_stacked_pspec(mesh, sp) for k, sp in inner.items()},
            mesh)
        hb_specs = of(state_shapes.h_bar, True)
    opt = OptState(step=PSpec(), m=of(state_shapes.opt.m, tcfg.zero_opt_state),
                   v=of(state_shapes.opt.v, tcfg.zero_opt_state))
    return TrainState(params=of(params, tcfg.fsdp_params), opt=opt,
                      h=h_specs, h_bar=hb_specs, noise=PSpec(), step=PSpec(),
                      bits=PSpec())


def batch_pspecs(batch_shapes, mesh) -> dict:
    """The batch's specs: its leading dim over the worker axes."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return {k: PSpec(axes) for k in batch_shapes}


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the reference's for what the port runs, with the
    reference's defaults."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of the arch")
    ap.add_argument("--compressor", default="natural")
    ap.add_argument("--shift-rule", "--shift_rule", dest="shift_rule",
                    default="diana", choices=list(SHIFT_RULE_CHOICES))
    ap.add_argument("--comm-mode", "--comm_mode", dest="comm_mode",
                    default="dense", choices=list(COMM_MODES),
                    help="channel aggregation format; ef21/efbv select the "
                         "error-feedback modes (implying their rule); "
                         "q8_ring_overlap/efbv_overlap the bucketed overlap "
                         "runtime over the fused q8 ring (efbv_overlap "
                         "implying efbv); q8_ring_fused_vjp encodes the "
                         "messages in the backward pass")
    ap.add_argument("--drift-resync-every", "--drift_resync_every",
                    dest="drift_resync_every", type=int, default=0,
                    help="every N rounds resync h_bar from a dense reduce "
                         "of the worker shifts (bounds shift-tracking "
                         "drift over lossy aggregation; 0 = off)")
    ap.add_argument("--efbv-eta", "--efbv_eta", dest="efbv_eta",
                    type=float, default=1.0,
                    help="EF-BV shift integration rate (1.0 = EF21)")
    ap.add_argument("--efbv-nu", "--efbv_nu", dest="efbv_nu",
                    type=float, default=1.0,
                    help="EF-BV estimator mixing")
    ap.add_argument("--moe-wire", "--moe_wire", dest="moe_wire",
                    default="none", choices=list(WIRE_CODEC_FLAGS),
                    help="codec for the MoE dispatch/combine all-to-all "
                         "wire ('none' leaves it off the transport; "
                         "'dense' routes it uncompressed)")
    ap.add_argument("--act-wire", "--act_wire", dest="act_wire",
                    default="none", choices=list(WIRE_CODEC_FLAGS),
                    help="codec for the block-boundary activation wire "
                         "(straight-through backward)")
    ap.add_argument("--model-wire", "--model_wire", dest="model_wire",
                    default="none", choices=list(WIRE_CODEC_FLAGS),
                    help="codec for the trainer->serving model-delta "
                         "downlink ('none' leaves it off the transport)")
    ap.add_argument("--publish_every", "--publish-every",
                    dest="publish_every", type=int, default=1,
                    help="trainer steps between model-delta publishes on "
                         "the downlink")
    ap.add_argument("--serve_fleet", "--serve-fleet", dest="serve_fleet",
                    type=int, default=0,
                    help="N > 0: co-run N continuous-batching serving "
                         "replicas off the model-delta stream while "
                         "training")
    ap.add_argument("--stale_k", "--stale-k", dest="stale_k", type=int,
                    default=4,
                    help="fleet staleness bound K (trainer steps behind) "
                         "before a dense resync")
    ap.add_argument("--no-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh-data", "--mesh_data", dest="mesh_data", type=int,
                    default=None,
                    help="positions of the host mesh's data axis (the DCGD "
                         "workers), all on the one device (default: one per "
                         "CUDA device, 1 on the CPU)")
    ap.add_argument("--metrics_out", "--metrics-out", dest="metrics_out",
                    default=None,
                    help="write per-step obs records (strict JSONL, "
                         "rotated) here; enables shift-rule diagnostics "
                         "(h_bar drift, EF error norm) in the metrics "
                         "dict — the returned train STATE stays "
                         "bit-exact with the uninstrumented run")
    ap.add_argument("--trace", action="store_true",
                    help="record host wall-clock spans per phase "
                         "(encode/reduce/apply) and include the span "
                         "table in the run summary")
    return ap


def _host_spans_table(spans: dict) -> str:
    from repro_torch import obs

    rows = [(n, sp["count"], f"{sp['mean_s']:.3e}s")
            for n, sp in sorted(spans.items())]
    return obs.format_table("host spans", ["span", "count", "mean"], rows)


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.with_(dtype="float32")
    comp = CompressionConfig(
        enabled=not args.no_compression,
        compressor=args.compressor,
        shift_rule=args.shift_rule,
        comm_mode=args.comm_mode,
        drift_resync_every=args.drift_resync_every,
        efbv_eta=args.efbv_eta,
        efbv_nu=args.efbv_nu,
        moe_wire=args.moe_wire,
        act_wire=args.act_wire,
        model_wire=args.model_wire,
        publish_every=args.publish_every,
    )
    if args.serve_fleet > 0 and args.model_wire == "none":
        raise SystemExit("--serve_fleet needs a model downlink; pass "
                         "--model_wire (dense/q8/natural/...)")
    mesh = (make_host_mesh(device) if args.mesh_data is None
            else HostMesh(data=args.mesh_data, device=device))
    w = n_workers(mesh)
    if args.batch % w:
        raise SystemExit(f"--batch must be divisible by {w} workers")
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       compression=comp)
    # the sink and the recorder exist only with observability on: obs is
    # not imported otherwise
    obs_on = args.metrics_out is not None
    sink = recorder = None
    if obs_on or args.trace:
        from repro_torch import obs

        if obs_on:
            sink = obs.JsonlSink(args.metrics_out)
        if args.trace:
            recorder = obs.SpanRecorder()

    state = init_state(0, cfg, tcfg, w, device)
    step_fn = build_train_step(cfg, tcfg, w, mesh, diag=obs_on)
    stream = TokenStream(cfg, args.seq, args.batch)
    # the per-wire structural traffic of a step, every wire at once
    acct = build_transport(comp, cfg, SimChannel(), w=w,
                           params_like=params_like(cfg),
                           tokens_per_worker=(args.batch // w) * args.seq)

    predicted_step_s = None
    if obs_on:
        from repro_torch import tune

        # the predicted step time of the measured-vs-predicted ledger: a
        # nominal comm-only prediction (no compute analysis: the gap is
        # the point, not a problem)
        wlike = {k: ShapeDtype((w, *p.shape), p.dtype, p.device)
                 for k, p in params_like(cfg).items()}
        if comp.enabled and comp.comm_mode in tune.TUNABLE_MODES:
            cand = tune.Candidate(
                comp.comm_mode,
                bucket_bytes=comp.overlap_bucket_bytes,
                randk_q=comp.randk_q,
                q8_block_rows=comp.q8_block_rows or 64,
                efbv_eta=comp.efbv_eta, efbv_nu=comp.efbv_nu,
                compressor=comp.compressor,
                compressor_kwargs=tuple(comp.compressor_kwargs),
            )
            predicted_step_s = tune.predict_step(
                cand, wlike, tune.LinkModel.nominal(), w).step_s
        # run header: per-wire telemetry (structural bits AND payload
        # bytes, measured codec timings and quality) + the measured
        # overlap hide
        m = tune.measure_overlap_hide(mesh, wlike, cap_bytes=1 << 20,
                                      iters=2)
        sink.emit(obs.run_record(
            "train",
            arch=args.arch,
            workers=w,
            comm_mode=comp.comm_mode,
            shift_rule=comp.effective_shift_rule if comp.enabled else None,
            steps=args.steps,
            wires=acct.obs_snapshot(timed=True, quality=True, device=device),
            hide_fraction=m.hide_fraction,
            hide_source=m.source,
            omega=None,
            omega_source="analytic",
            predicted_step_s=predicted_step_s,
        ))

    bridge = None
    if args.serve_fleet > 0:
        from repro_torch.serving.fleet import TrainerFleetBridge

        bridge = TrainerFleetBridge(
            cfg, state.params, acct["model"], n_replicas=args.serve_fleet,
            publish_every=comp.publish_every, stale_k=args.stale_k,
            noise=AddressedNoise(1, device), obs=sink)

    print(f"arch={args.arch} params={M.count_params_analytic(cfg):,} "
          f"workers={w} device={device} compression={comp.enabled} "
          f"rule={comp.effective_shift_rule} comm={comp.comm_mode} "
          f"compressor={comp.compressor} moe_wire={comp.moe_wire} "
          f"act_wire={comp.act_wire} model_wire={comp.model_wire}")
    print("wire bytes/step: " + "  ".join(
        f"{name}={bits / 8:,.0f}" for name, bits in
        acct.per_wire_bits().items()))
    every = comp.drift_resync_every if comp.enabled else 0
    loop_ctx = obs.recording(recorder) if recorder is not None else \
        nullcontext()
    # the host span around a step ends in a device synchronisation (the
    # step's state ready, as the reference's block_until_ready): the
    # span and the step record hold the device's work, not its launches
    step_ctx = ((lambda: obs.span("host/step")) if recorder is not None
                else nullcontext)
    timed = sink is not None or recorder is not None
    t0 = time.time()
    with loop_ctx:
        for i in range(args.steps):
            ts = time.perf_counter()
            with step_ctx():
                state, metrics = step_fn(state, stream.batch(i, device))
                if timed and device.type == "cuda":
                    torch.cuda.synchronize(device)
            step_s = time.perf_counter() - ts
            if bridge is not None:
                bridge.on_step(state.params, i + 1)
            if sink is not None:
                sink.emit(obs.step_record(
                    i,
                    loss=float(metrics["loss"]),
                    bits=float(metrics["bits"]),
                    step_s=step_s,
                    predicted_step_s=predicted_step_s,
                    **{k: (float(metrics[k]) if k in metrics else None)
                       for k in ("h_bar_drift", "ef_err_norm", "grad_sq",
                                 "shift_residual_sq")},
                ))
                # resync_h_bar fires at (step % N) == N-1; the event
                # mirrors it from the same arithmetic
                if every and (i % every) == every - 1:
                    sink.emit(obs.event_record("drift_resync", i,
                                               every=every))
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                      f"bits {float(metrics['bits']):.3e}  "
                      f"({time.time() - t0:.1f}s)")
    if bridge is not None:
        bridge.drain()
        s = bridge.stats()
        print(f"fleet[{args.serve_fleet}] wire={comp.model_wire}: "
              f"{s['publishes']} publishes, {s['resyncs']} resyncs, "
              f"{s['bytes_fraction']:.3f} of dense bytes/publish, "
              f"max staleness {s['max_staleness']} (K={args.stale_k}), "
              f"{s['tokens_served']} tokens served")
    spans = recorder.snapshot() if recorder is not None else None
    if sink is not None:
        sink.emit(obs.summary_record("train", spans=spans))
        sink.close()
        print(obs.summary_table(obs.read_jsonl(args.metrics_out),
                                name=args.arch))
    if spans:
        print(_host_spans_table(spans))
    return state


if __name__ == "__main__":
    main()
