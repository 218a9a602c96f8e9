"""One run of one cell: the program's training step driven from the
benchmark's inputs, timed, checked against the plain reference, and
reported as one JSON line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<name>.json``: the model's published keys, with the sizes
the benchmark assumes) and a traffic mix (``traffic/<name>.json``: the
workers, the codec and the aggregation, the batch and sequence, the
optimizer).  Its limits are ``limits/<cell>.json``; its per-layer
metrics are ``metrics/<name>.py``, each a ``read(run)``; the plain
reference of its model family is ``reference/<model_type>.py``, by the
configuration's published ``model_type``.  All are found by name: a new
cell, configuration, mix, metric or family is a new file.

A run, in order:

1. set-up: the program's step and state are built, the state's params
   from the benchmark's draw; the step runs ``CHECKED_STEPS`` steps on
   the first batches, through the same call and feed as the window,
   and the readings the comparison needs are taken between them (each
   step's loss, the first step's gradient from AdamW's first moment,
   the parameters' change over the steps, the wire bits);
2. the window: steps, back to back, for ``--seconds``; it ends in a
   device synchronisation.  With ``--trace 1`` a few more steps run
   under the profiler after it;
3. the peak device memory is read; the program's state is freed;
4. the plain reference runs the same steps from the same inputs, and
   each number compared is printed beside its limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from perfbench import inputs, trace
from perfbench.counts import q8

ROOT = Path(__file__).resolve().parent
CHECKED_STEPS = 3
#: profiled steps after the window: about this many seconds of them
TRACE_SECONDS = 2.0


# --------------------------------------------------------------------------
# Cells, found by name
# --------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    family: ModuleType


def load_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    bench = bench or load_json(root.parent / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root.parent / cfg["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    fam = family(config, root)
    wires = [k for k in ("moe_wire", "act_wire")
             if traffic.get(k, "none") != "none"]
    if wires and not fam.WIRES:
        raise SystemExit(f"traffic {w['traffic']!r} sets {wires}, which the "
                         f"{config['model_type']!r} family ({fam.__file__}) "
                         f"does not take")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, config, traffic,
                load_json(root / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], fam)


def _load(name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # a dataclass looks its module up in sys.modules
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    return _load(f"perfbench_metric_{metric}",
                 root / "metrics" / f"{metric}.py").read


def family(config: dict, root: Path = ROOT) -> ModuleType:
    """The plain reference's model family of a configuration file,
    ``reference/<model_type>.py`` by its published ``model_type``
    (what a family gives: ``reference/common.py``)."""
    kind = config.get("model_type")
    path = root / "reference" / f"{kind}.py"
    if not isinstance(kind, str) or not path.is_file():
        raise SystemExit(f"no reference family for model_type {kind!r}: "
                         f"{path} is not there")
    return _load(f"perfbench_family_{kind}", path)


# --------------------------------------------------------------------------
# The program's objects for a cell
# --------------------------------------------------------------------------

def program_config(cell: Cell):
    """The program's ``ModelConfig`` of a cell's configuration file: its
    registered architecture with the fields its family reads from the
    file (every published size, the assumed ones), and f32."""
    from repro_torch.configs import get_config

    return get_config(cell.config["program_arch"]).with_(
        dtype="float32", **cell.family.program_fields(cell.config))


def train_config(traffic: dict):
    from repro_torch.configs.base import CompressionConfig, TrainConfig

    opt = traffic["optimizer"]
    comp = CompressionConfig(
        compressor=traffic["compressor"], shift_rule=traffic["shift_rule"],
        shift_alpha=traffic["shift_alpha"], comm_mode=traffic["comm_mode"],
        q8_block_rows=traffic["q8_block_rows"],
        moe_wire=traffic["moe_wire"], act_wire=traffic["act_wire"])
    return TrainConfig(learning_rate=opt["lr"], beta1=opt["beta1"],
                       beta2=opt["beta2"], eps=opt["eps"],
                       weight_decay=opt["weight_decay"],
                       warmup_steps=opt["warmup_steps"],
                       total_steps=opt["total_steps"], compression=comp)


def check_layout(cfg, specs) -> None:
    """The program's parameter layout is the reference's ``specs``, leaf
    for leaf."""
    from repro_torch.models.model import param_specs

    got = [(p, tuple(s)) for p, s, _ in param_specs(cfg)]
    want = [(p, tuple(s)) for p, s, _ in specs]
    if got != want:
        raise SystemExit(f"the program's parameter layout is not the "
                         f"reference's: {got} against {want}")


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------


@dataclass
class Run:
    """What a metric's ``read`` sees."""
    summary: Optional[trace.Summary]
    flops_per_step: float
    window_steps: int
    window_s: float
    q8_launches: list
    notes: List[str] = field(default_factory=list)

    def phase_ms(self, name: str) -> Optional[float]:
        return None if self.summary is None else \
            self.summary.phase_ms_per_step(name)

    def note(self, line: str) -> None:
        self.notes.append(line)


def _norms(tree: Dict[str, torch.Tensor], scale: float = 1.0
           ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) * scale
            for k, v in tree.items()}


def gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of the leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep)


def kept_leaves(ref: dict) -> List[str]:
    """The leaves whose change is compared: those whose reference gradient
    is at least a thousandth of the median leaf's (the others move under
    AdamW by round-off alone)."""
    med = statistics.median(ref["grad1"].values())
    return [k for k, v in ref["grad1"].items() if v >= 1e-3 * med]


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, the worst
    kept leaf's gap of the first gradient's norm and of the parameters'
    change, the wire bits' difference."""
    keep = kept_leaves(ref)
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                         ref["loss"])),
        "grad1": gap(prog["grad1"], ref["grad1"], keep),
        "change": gap(prog["change"], ref["change"], keep),
        "bits": abs(prog["bits"] - ref["bits"]),
    }


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: Optional[float] = None,
             log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.train import build_train_step, init_state

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise SystemExit("TF32 products are on; the cells state f32")
    tr, fam = cell.traffic, cell.family
    m = fam.model_of(cell.config)
    specs = fam.param_specs(m)
    cfg, tcfg = program_config(cell), train_config(tr)
    check_layout(cfg, specs)
    w, b, s = tr["workers"], tr["batch"], tr["seq"]
    mesh = HostMesh(data=w, device=dev)

    def feed(i: int):
        return inputs.batch(seed, i, b, s, m.vocab, dev)

    # set-up: the state with the benchmark's params and draws
    state = init_state(0, cfg, tcfg, w, dev)
    start = inputs.make_params(specs, seed, dev)
    for k, p in state.params.items():
        p.copy_(start[k])
    del start
    state = state._replace(
        noise=inputs.SeedDraws(inputs.draws_seed(seed), dev))
    step = build_train_step(cfg, tcfg, w, mesh)
    prog = {"loss": []}
    for i in range(CHECKED_STEPS):
        state, metrics = step(state, feed(i))
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad1"] = _norms(state.opt.m, 1.0 / (1.0 - tcfg.beta1))
    start = inputs.make_params(specs, seed, dev)
    prog["change"] = {k: float(torch.linalg.vector_norm(
        (state.params[k] - start[k]).to(torch.float64))) for k in start}
    prog["bits"] = float(state.bits)
    del start
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    # the window
    losses, n = [], CHECKED_STEPS
    t0 = time.perf_counter()
    while True:
        state, metrics = step(state, feed(n))
        losses.append(metrics["loss"])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    steps = n - CHECKED_STEPS
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    summary = None
    if traced:
        per = max(window_s / steps, 1e-3)
        k = int(min(8, max(2, math.ceil(TRACE_SECONDS / per))))
        summary = profile(step, state, feed, n, k, dev)
        n += k + 1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state, step, metrics, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from perfbench.reference.train import readings
    ref = readings(fam, cell.config, cell.traffic, seed, dev, CHECKED_STEPS)
    log("loss by step: program " + " ".join(map(repr, prog["loss"]))
        + "; reference " + " ".join(map(repr, ref["loss"])))
    left_out = sorted(set(ref["grad1"]) - set(kept_leaves(ref)))
    log(f"leaves compared: {len(ref['grad1']) - len(left_out)} of "
        f"{len(ref['grad1'])}; left out {left_out}")
    numbers = compare(prog, ref)
    # a number whose limit is null has no reading that separates sound
    # runs from faulty ones (PERF.md): it is printed, not compared
    for k, v in numbers.items():
        if cell.limits[k] is None:
            log(f"not compared: {k} {v!r}")
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items() if cell.limits[k] is not None}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    tokens = b * s
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": steps, "failed": failed}
    if not traced:
        values = {"tokens_per_s": tokens * steps / window_s,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        out["metrics"] = {e["name"]: {"value": values[e["name"]],
                                      "unit": e["unit"]}
                          for e in cell.end_to_end}
    else:
        run = Run(summary, fam.step_flops(m, b, s), steps, window_s,
                  q8.step_launches([math.prod(sh) for _, sh, _ in specs], w,
                                   w if tr["comm_mode"] != "dense" else 0,
                                   tr["compressor"] == "q8_block"))
        got = {}
        for metric in cell.per_layer:
            v = reader(metric["name"])(run)
            if v is not None:
                got[metric["name"]] = {"value": v, "unit": metric["unit"]}
        for line in run.notes:
            log(line)
        out["metrics"] = got
        device_info.update(busy_s=summary.busy_s if summary else 0.0,
                           window_s=summary.window_s if summary else 0.0)
        if summary is not None:
            out["breakdown"] = {"device_ops": summary.device_ops(),
                                "idle_gaps": [list(g) for g in summary.gaps]}
    out["device"] = device_info
    out["checks"] = checks
    return out


def profile(step, state, feed, first: int, k: int, dev) -> trace.Summary:
    """``k`` steps under the profiler, after one step it records and
    drops (the profiler's own start-up); the timeline goes through a file
    in the temporary directory, deleted once read."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function, schedule

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch_profile(activities=acts,
                           schedule=schedule(wait=0, warmup=1, active=k),
                           on_trace_ready=lambda p: p.export_chrome_trace(
                               path)) as prof:
            for i in range(k + 1):
                with record_function(trace.STEP_TAG):
                    state, _ = step(state, feed(first + i))
                    if i == k and dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                prof.step()
        with open(path) as f:
            timeline = json.load(f)
    finally:
        os.unlink(path)
    return trace.reduce_trace(timeline)
