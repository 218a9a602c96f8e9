"""The AOT dry-run over every (architecture x input shape x mesh) -- the
port of the reference's ``repro/launch/dryrun.py``, with its CLI and its
record keys.

The reference lowers and compiles each combination for 256 or 512
placeholder TPU devices and reads XLA's memory and cost analyses.  The
port runs each combination's step through the step's cost pass
(``launch.hlo_cost``) on the META device, over the production mesh
(``launch.mesh.make_production_mesh``): the train step
(``launch.train.step_cost``), the prefill forward or one decode step.
Nothing is allocated and nothing is computed, so it runs on any host.

What the numbers mean: those of the port's own execution, ONE card
holding every position of the mesh (its workers take turns), so the
roofline's ``n_chips`` is 1.  ``memory.argument_bytes`` and
``output_bytes`` come from the shapes, with ``fits_one_card`` (the
arguments within the card's 80 GiB); XLA's ``temp_bytes`` and
``generated_code_bytes`` have no counterpart and are ``null``, with a
note.  ``lower_s`` is the meta trace's time; ``compile_s`` is ``null``
(nothing is compiled).  ``--save-hlo`` writes the cost pass's per-op
table in place of HLO text.  A combination that cannot be traced on meta
records ``status: "error"`` with its reason, as the reference records a
failed lowering.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Outputs one JSON per combination under experiments/dryrun/ (``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.comm.transport import WIRE_CODEC_FLAGS
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import (
    CompressionConfig,
    InputShape,
    ModelConfig,
    TrainConfig,
)
from repro_torch.core.compressors import ShapeDtype
from repro_torch.data.tokens import make_batch_specs
from repro_torch.launch import hlo_cost, hlo_stats
from repro_torch.launch.mesh import make_production_mesh, n_workers
from repro_torch.launch.serve import (
    build_serve_step,
    decode_specs,
    serving_config,
)
from repro_torch.launch.train import COMM_MODES, params_like, step_cost
from repro_torch.models import model as M

#: the card's memory (NVIDIA H100 80GB HBM3)
CARD_BYTES = 80 * (1 << 30)

_XLA_ONLY = ("XLA's compiled-buffer size: the port compiles nothing (its "
             "ops run eagerly), so there is no counterpart")


def skip_reason(arch: str, shape: InputShape) -> Optional[str]:
    cfg = get_config(arch)
    if shape.name == "long_500k" and cfg.arch_type == "audio":
        return ("long_500k skipped for audio enc-dec "
                "(DESIGN.md §Arch-applicability)")
    return None


def _wlike(cfg: ModelConfig, w: int) -> dict:
    return {k: ShapeDtype((w, *p.shape), p.dtype, p.device)
            for k, p in params_like(cfg).items()}


def tune_preview(cfg: ModelConfig, comp: CompressionConfig, mesh,
                 analysis: Dict[str, Any], top: int = 5,
                 wire_traffic=None) -> Dict[str, Any]:
    """Predicted-vs-chosen comm plans for this (arch x mesh) workload.

    Ahead of time only: the tuner's predictor runs off this dry-run's
    cost pass, the card's nominal link and rates (the product peak for
    the model's dtype), and structural wire bits (``verify_top=0`` --
    nothing is timed).  The measured search belongs to ``--comm_mode
    auto`` at launch; this preview shows what it WOULD choose next to
    what is configured.  With registered non-grad wires
    (``wire_traffic``) the grid also crosses each configured wire flag
    against ``"none"``.
    """
    from repro_torch import tune

    w = n_workers(mesh)
    grids = {}
    if comp.moe_wire != "none":
        grids["moe_wire_grid"] = tuple(dict.fromkeys(("none", comp.moe_wire)))
    if comp.act_wire != "none":
        grids["act_wire_grid"] = tuple(dict.fromkeys(("none", comp.act_wire)))
    if comp.model_wire != "none":
        grids["model_wire_grid"] = tuple(
            dict.fromkeys(("none", comp.model_wire)))
    plan = tune.search_plan(
        comp, _wlike(cfg, w), mesh, w, fingerprint="preview",
        analysis=analysis, link=tune.LinkModel.nominal(),
        rates=tune.DeviceRates.nominal(cfg.dtype),
        verify_top=0, wire_traffic=wire_traffic, **grids,
    )
    return {
        "configured_comm_mode": comp.comm_mode,
        "predicted_choice": plan.comm_mode,
        "predicted_moe_wire": plan.moe_wire,
        "predicted_act_wire": plan.act_wire,
        "predicted_model_wire": plan.model_wire,
        "predicted_step_s": plan.predicted_step_s,
        "hide_fraction": plan.hide_fraction,
        "hide_source": plan.hide_source,
        "omega": plan.omega,
        "omega_source": plan.omega_source,
        "candidates": list(plan.candidates[:top]),
    }


def accounting_transport(cfg: ModelConfig, comp: CompressionConfig, mesh,
                         shape: InputShape):
    """The Transport this run registers, channel-free (accounting only):
    grad traffic from the parameter tree, moe/act traffic from the input
    shape's per-worker token count."""
    from repro_torch.comm.transport import build_transport

    w = n_workers(mesh)
    return build_transport(
        comp, cfg, None, w=w, params_like=params_like(cfg),
        tokens_per_worker=shape.global_batch * shape.seq_len // max(w, 1),
    )


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D for training, 2*N*D forward-only; N = active params."""
    n = M.count_params_analytic(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def lower_train(cfg: ModelConfig, shape: InputShape, mesh,
                tcfg: TrainConfig, table: Optional[dict] = None,
                counts: Optional[dict] = None) -> dict:
    """The cost pass over one train step of ``tcfg`` at ``shape`` over
    ``mesh`` (its W = pod x data workers)."""
    return step_cost(cfg, tcfg, n_workers(mesh), mesh,
                     make_batch_specs(cfg, shape), table=table,
                     counts=counts)


def lower_eval(cfg: ModelConfig, shape: InputShape, mesh,
               table: Optional[dict] = None) -> dict:
    """Prefill = the forward pass over the full sequence (the last
    position's logits), no gradient."""
    meta = torch.device("meta")
    params = {k: torch.empty(p.shape, dtype=p.dtype, device=meta)
              for k, p in params_like(cfg).items()}

    def eval_step(params, batch):
        with torch.no_grad():
            logits, _ = M.forward_train(params, cfg, batch)
        return logits[:, -1]

    return hlo_cost.analyze(eval_step, params, make_batch_specs(cfg, shape),
                            table=table)


def lower_decode(cfg: ModelConfig, shape: InputShape, mesh,
                 table: Optional[dict] = None) -> dict:
    """One decode step of the whole batch at ``shape.seq_len``."""
    scfg = serving_config(cfg, shape.name)
    params, state, tok, pos = decode_specs(scfg, shape.seq_len,
                                           shape.global_batch)
    step = build_serve_step(scfg)

    def run(params, state, tok):
        with torch.no_grad():
            return step(params, state, tok, pos)

    return hlo_cost.analyze(run, params, state, tok, table=table)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in hlo_cost._tensors(tree))


def _params_bytes(cfg: ModelConfig) -> int:
    return sum(math.prod(p.shape) * p.dtype.itemsize
               for p in params_like(cfg).values())


def _memory(cfg: ModelConfig, shape: InputShape, mesh,
            tcfg: TrainConfig) -> Dict[str, Any]:
    """Argument and output bytes from the shapes (one card holds them
    all): the train state and batch in, the state out; the params and
    batch in, the last logits out; the params, decode state and token in,
    the logits and state out."""
    meta = torch.device("meta")
    b = shape.global_batch
    if shape.kind == "train":
        from repro_torch.launch.train import init_state

        state = init_state(0, cfg, tcfg, n_workers(mesh), meta)
        st = _tensor_bytes((state.params, state.opt.m, state.opt.v,
                            state.h, state.h_bar))
        args = st + _tensor_bytes(make_batch_specs(cfg, shape))
        outs = st
    elif shape.kind == "prefill":
        args = _params_bytes(cfg) + _tensor_bytes(make_batch_specs(cfg,
                                                                   shape))
        outs = b * cfg.vocab_size * getattr(torch, cfg.dtype).itemsize
    else:
        params, state, tok, _ = decode_specs(
            serving_config(cfg, shape.name), shape.seq_len, b)
        args = _tensor_bytes((params, state, tok))
        outs = _tensor_bytes(state) + b * cfg.vocab_size * 4
    return {
        "argument_bytes": int(args),
        "output_bytes": int(outs),
        "temp_bytes": None,
        "generated_code_bytes": None,
        "fits_one_card": bool(args <= CARD_BYTES),
        "note": {"temp_bytes": _XLA_ONLY,
                 "generated_code_bytes": _XLA_ONLY,
                 "fits_one_card": "argument bytes within the card's 80 GiB "
                                  "(activations not counted)"},
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            tcfg: TrainConfig, out_dir: str, save_hlo: bool = False,
            probe_quality: bool = False) -> Dict[str, Any]:
    shape = INPUT_SHAPES[shape_name]
    mesh_tag = "pod512" if multi_pod else "pod256"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "kind": shape.kind,
    }
    reason = skip_reason(arch, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    cfg = get_config(arch)
    # per-arch wire sanitization: under --all a moe/act wire flag only
    # applies to the archs that have that wire
    comp = tcfg.compression
    drop = {}
    if comp.moe_wire != "none" and not cfg.is_moe:
        drop["moe_wire"] = "none"
    if comp.act_wire != "none" and cfg.arch_type not in ("dense", "vlm",
                                                         "moe"):
        drop["act_wire"] = "none"
    if drop:
        tcfg = dataclasses.replace(
            tcfg, compression=dataclasses.replace(comp, **drop))
    mesh = make_production_mesh(multi_pod=multi_pod)
    table = {} if save_hlo else None
    counts = {}
    t0 = time.time()
    try:
        if shape.kind == "train":
            corrected = lower_train(cfg, shape, mesh, tcfg, table=table,
                                    counts=counts)
        elif shape.kind == "prefill":
            corrected = lower_eval(cfg, shape, mesh, table=table)
        else:
            corrected = lower_decode(cfg, shape, mesh, table=table)
        t_lower = time.time() - t0
        from repro_torch.comm.channel import collective_payload_scale

        scale = (collective_payload_scale(tcfg.compression)
                 if shape.kind == "train" else {})
        if scale:
            # re-charge only the gradient-mean share of the all-reduce
            # bytes at the codec wire fraction: one position's share of
            # the param tree (the tree over the model axis)
            msg_bytes = _params_bytes(cfg) / mesh.model
            corrected = hlo_cost.apply_gradient_payload_model(
                corrected, "all-reduce", msg_bytes, scale["all-reduce"])
        coll = hlo_stats.collective_bytes_of(corrected, counts)
        mf = model_flops(
            serving_config(cfg, shape_name) if shape.kind == "decode"
            else cfg, shape)
        roof = hlo_stats.roofline(corrected, corrected, mf, 1,
                                  dtype=cfg.dtype)

        rec.update({
            "status": "ok",
            "lower_s": round(t_lower, 1),
            "compile_s": None,
            "cost_model": {
                "unresolved_whiles": list(corrected["unresolved_whiles"]),
                "unresolved_while_count":
                    len(corrected["unresolved_whiles"]),
                "while_trips": dict(corrected["while_trips"]),
                "repeated_loops": dict(corrected["repeated_loops"]),
            },
            "memory": _memory(cfg, shape, mesh, tcfg),
            "roofline": roof,
            "collective_counts": coll.get("_counts"),
        })
        if shape.kind == "train":
            transport = accounting_transport(cfg, tcfg.compression, mesh,
                                             shape)
            rec["wires"] = [
                {
                    "name": wire.name,
                    "topology": wire.topology,
                    "codec": type(wire.codec).__name__,
                    "bytes_per_step": wire.wire_bits() / 8.0,
                    "overlap_hidden": wire.overlap_hidden,
                    # measured distortion is opt-in: it runs each wire's
                    # codec on synthetic traffic on the card
                    **(wire.codec_quality() if probe_quality
                       else {"omega_hat": None, "nmse": None}),
                }
                for wire in transport
            ]
            if tcfg.compression.enabled:
                rec["tune_preview"] = tune_preview(
                    cfg, tcfg.compression, mesh, corrected,
                    wire_traffic=transport.extra_traffic(),
                )
        if save_hlo:
            path = os.path.join(out_dir,
                                f"{arch}_{shape_name}_{mesh_tag}.ops.json")
            with open(path, "w") as f:
                json.dump(table, f, indent=1, sort_keys=True)
    except Exception as e:  # record failures -- they are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the cost pass's per-op table (count, "
                         "flops, bytes, transcendentals by ATen op) as "
                         "<arch>_<shape>_<mesh>.ops.json: the port has no "
                         "HLO text")
    ap.add_argument("--comm-mode", "--comm_mode", dest="comm_mode",
                    default="dense", choices=list(COMM_MODES))
    ap.add_argument("--compressor", default="natural")
    ap.add_argument("--shift-rule", "--shift_rule", dest="shift_rule",
                    default="diana")
    ap.add_argument("--moe-wire", "--moe_wire", dest="moe_wire",
                    default="none", choices=list(WIRE_CODEC_FLAGS))
    ap.add_argument("--act-wire", "--act_wire", dest="act_wire",
                    default="none", choices=list(WIRE_CODEC_FLAGS))
    ap.add_argument("--model-wire", "--model_wire", dest="model_wire",
                    default="none", choices=list(WIRE_CODEC_FLAGS),
                    help="trainer->serving model-delta downlink codec")
    ap.add_argument("--publish_every", "--publish-every",
                    dest="publish_every", type=int, default=1,
                    help="steps between downlink publishes (amortizes "
                         "the model wire's bytes/step)")
    ap.add_argument("--no-compression", action="store_true")
    ap.add_argument("--probe-quality", "--probe_quality",
                    dest="probe_quality", action="store_true",
                    help="run the measured omega_hat/NMSE distortion "
                         "probe on each wire's codec, on the card (off by "
                         "default: the per-wire table shows a dash)")
    ap.add_argument("--metrics_out", "--metrics-out", dest="metrics_out",
                    default=None,
                    help="emit one obs event per combination (status, "
                         "unresolved-while count) as strict JSONL")
    return ap


def _print_record(rec: Dict[str, Any]) -> None:
    """The per-combination lines under the status line (the reference's
    form): the unresolved loops, each wire, the tune preview."""
    unresolved = (rec.get("cost_model") or {}).get("unresolved_whiles") or []
    if unresolved:
        print(f"    WARNING: {len(unresolved)} while loop(s) with "
              f"unresolved trip counts (fell back to 1): "
              f"{', '.join(unresolved[:4])}"
              f"{' ...' if len(unresolved) > 4 else ''}", flush=True)
    for wrow in rec.get("wires") or ():
        oh, nm = wrow.get("omega_hat"), wrow.get("nmse")
        print(f"    wire {wrow['name']:<5} "
              f"{wrow['topology']:<10} {wrow['codec']:<18} "
              f"{wrow['bytes_per_step']:.3e} B/step  "
              f"hidden={wrow['overlap_hidden']:.0%}  "
              f"omega_hat={'-' if oh is None else format(oh, '.3g')}  "
              f"nmse={'-' if nm is None else format(nm, '.3g')}",
              flush=True)
    tp = rec.get("tune_preview")
    if tp:
        mark = ("  (matches configured)"
                if tp["predicted_choice"] == tp["configured_comm_mode"] else
                f"  (configured: {tp['configured_comm_mode']})")
        om = tp.get("omega")
        print(f"    tune preview: predicted choice "
              f"{tp['predicted_choice']} "
              f"@ {tp['predicted_step_s']:.3e}s/step{mark}  "
              f"[hide: {tp['hide_source']}, omega: "
              f"{'-' if om is None else format(om, '.3g')} "
              f"({tp['omega_source']})]", flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    sink = None
    if args.metrics_out:
        from repro_torch import obs

        sink = obs.JsonlSink(args.metrics_out)
        sink.emit(obs.run_record("dryrun", comm_mode=args.comm_mode))

    os.makedirs(args.out, exist_ok=True)
    tcfg = TrainConfig(
        compression=CompressionConfig(
            enabled=not args.no_compression,
            compressor=args.compressor,
            shift_rule=args.shift_rule,
            comm_mode=args.comm_mode,
            moe_wire=args.moe_wire,
            act_wire=args.act_wire,
            model_wire=args.model_wire,
            publish_every=args.publish_every,
        )
    )

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'512' if mp else '256'}"
                print(f"=== {tag} ...", flush=True)
                rec = run_one(arch, shape, mp, tcfg, args.out,
                              save_hlo=args.save_hlo,
                              probe_quality=args.probe_quality)
                results.append(rec)
                fname = os.path.join(
                    args.out,
                    f"{arch}_{shape}_{'pod512' if mp else 'pod256'}"
                    f"_{tcfg.compression.comm_mode}.json",
                )
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=2)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']} "
                             f"c={r['compute_s']:.3f}s m={r['memory_s']:.3f}s "
                             f"coll={r['collective_s']:.3f}s "
                             f"useful={r['useful_flops_frac']:.3f}")
                elif status == "error":
                    extra = " " + rec["error"][:200]
                print(f"=== {tag}: {status}{extra}", flush=True)
                if sink is not None:
                    from repro_torch import obs

                    unresolved = (rec.get("cost_model") or {}).get(
                        "unresolved_whiles") or []
                    sink.emit(obs.event_record(
                        "dryrun_combination", len(results) - 1,
                        arch=arch, shape=shape, status=status,
                        unresolved_while_count=len(unresolved),
                    ))
                _print_record(rec)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if sink is not None:
        from repro_torch import obs

        sink.emit(obs.summary_record("dryrun", ok=n_ok, skipped=n_skip,
                                     errors=n_err))
        sink.close()
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
