"""The profiled timeline reduced by the program's own spans, and the host's
issue time by span.

The program marks where it issues work with spans (``repro_torch.spans``):
the step's phases (``train/*``), each worker's passes (``grads/forward``,
``grads/backward``), the round's parts (``round/message``,
``round/aggregate``, ``round/apply``), each wire send (``wire/<name>``)
and Python's garbage collections (``host/gc``).  Under the profiler each
is a ``user_annotation`` range on the host, and spans nest.  ``reduce``
reads the same timeline as ``trace.reduce_trace``:

* device time: each device activity goes to every span whose host
  interval holds its launch (the CUDA API call with its correlation id),
  on any thread, so the autograd engine's launches from its own thread
  fall inside ``grads/backward``; a span's device time is inclusive, its
  self time that of the activities whose innermost span it is.  An
  activity whose launch the timeline lacks goes to the innermost span
  whose matched activities span its start on the device, as in
  ``trace.py``;
* launches: the host's launch calls, once per correlation id, so a graph
  launch that feeds many kernels counts once;
* idle gaps: the ten largest, each labelled by the spans open at its
  midpoint (outermost first), the innermost host op and CUDA API call
  open there, or else the host op that ended last before it.

``host_issue`` times a few more steps with a ``SpanRecorder`` active and
no profiler (the profiler inflates the host's time): the host's issue
time by span, with a device synchronisation before each step, outside
the spans.

``metrics`` gives the per-layer numbers these readings make.  The
benchmark's harness does not call this module yet; ``main`` runs one
cell with it, hooking the harness's ``profile`` from outside:

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

prints the table by span and the labelled gaps on standard error and one
JSON line last (the metrics, the checks against ``trace.reduce_trace``
on the same timeline, and the harness's result).  With ``--host-spans
recorder|gc|both|none`` it runs the cell untraced instead, with a
``SpanRecorder`` active, ``host/gc`` on, both, or neither (the control
from the same entry point), which measures what the spans cost when
they are on, and prints the recorder's spans over the whole run beside
the result.

``traced_run`` and ``main`` are temporary: once ``harness.run_cell``
keeps the profiled timeline and calls ``reduce`` and ``host_issue``
itself (PERF.md, open questions), delete both rather than keep two
traced-run paths; until then ``test_perfbench_spans.py`` guards the
hook.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: process start, where a run's set-up starts (``run.py``'s)
T_START = time.perf_counter()

if __name__ == "__main__":     # run as a script: the checkout's packages
    _ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from perfbench import trace  # noqa: E402

#: ranges on the timeline that are not the program's spans
NOT_SPANS = (trace.STEP_TAG, "ProfilerStep#")
#: the step's phases, whose host time is the step's issue time
PHASES = ("train/grads", "train/round", "train/apply")
#: steps timed by ``host_issue``
HOST_STEPS = 2


@dataclass
class Spans:
    steps: int                          # profiled steps
    device_s: Dict[str, float]          # inclusive device s by span name
    self_s: Dict[str, float]            # device s whose innermost span it is
    launches: Dict[str, int]            # launches inside each span
    total_launches: int                 # launches in the profiled stretch
    gaps: List[Tuple[str, float]]       # (label, s), largest first

    def ms(self, name: str) -> Optional[float]:
        """Inclusive device ms a step of the span ``name``."""
        if name not in self.device_s or not self.steps:
            return None
        return 1e3 * self.device_s[name] / self.steps

    def ms_of(self, prefix: str) -> Optional[float]:
        """Device ms a step of the spans named ``prefix...`` (spans of one
        prefix do not nest)."""
        names = [n for n in self.device_s if n.startswith(prefix)]
        if not names or not self.steps:
            return None
        return 1e3 * sum(self.device_s[n] for n in names) / self.steps

    def launches_per_step(self) -> Optional[float]:
        return self.total_launches / self.steps if self.steps else None


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _iv(e) -> Tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e["dur"])


def reduce(timeline: dict) -> Spans:
    events = timeline["traceEvents"]
    notes = _x(events, ("user_annotation",))
    steps = sorted(_iv(e) for e in notes if e.get("name") == trace.STEP_TAG)
    spans = sorted((*_iv(e), e["name"]) for e in notes
                   if not e.get("name", "").startswith(NOT_SPANS))
    device = _x(events, trace.DEVICE_CATS)
    if steps:
        device = [e for e in device if _iv(e)[1] >= steps[0][0]]
    calls, launch_at = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat", "").startswith(
                trace.LAUNCH_PREFIX):
            calls.append((*_iv(e), e.get("name", "?")))
            c = trace._corr(e)
            if c is not None:
                launch_at[c] = float(e["ts"])

    # one sweep over span starts, launches and span ends, in time order
    # (a start before a launch at the same time, an outer span before an
    # inner one that starts with it, an end after both)
    START, LAUNCH, END = 0, 1, 2
    sweep = []
    for i, (a, b, _) in enumerate(spans):
        sweep.append((a, START, -b, i))
        sweep.append((b, END, 0.0, i))
    unmatched = []
    for j, e in enumerate(device):
        t = launch_at.get(trace._corr(e))
        if t is None:
            unmatched.append(e)
        else:
            sweep.append((t, LAUNCH, 0.0, j))
    sweep.sort()
    device_s: Dict[str, float] = {}
    self_s: Dict[str, float] = {}
    corrs: Dict[str, set] = {}
    on_device: Dict[int, List[float]] = {}     # span -> its device span
    outer: Dict[int, List[int]] = {}           # span -> spans holding it
    active: List[int] = []
    for _, kind, _, i in sweep:
        if kind == START:
            outer[i] = [k for k in active if spans[k][1] >= spans[i][1]]
            active.append(i)
        elif kind == END:
            active.remove(i)
        elif active:
            e = device[i]
            ts, te = _iv(e)
            dur = te - ts
            for name in {spans[k][2] for k in active}:
                device_s[name] = device_s.get(name, 0.0) + dur * 1e-6
                corrs.setdefault(name, set()).add(trace._corr(e))
            inner = spans[active[-1]][2]
            self_s[inner] = self_s.get(inner, 0.0) + dur * 1e-6
            for k in active:
                sp = on_device.setdefault(k, [ts, te])
                sp[0], sp[1] = min(sp[0], ts), max(sp[1], te)
    for e in unmatched:
        ts, te = _iv(e)
        holding = [k for k, (a, b) in on_device.items() if a <= ts <= b]
        if not holding:
            continue
        k = max(holding, key=lambda k: (spans[k][0], -spans[k][1]))
        for name in {spans[o][2] for o in outer[k]} | {spans[k][2]}:
            device_s[name] = device_s.get(name, 0.0) + (te - ts) * 1e-6
        self_s[spans[k][2]] = self_s.get(spans[k][2], 0.0) + (te - ts) * 1e-6

    launched = {trace._corr(e) for e in device} & set(launch_at)
    gaps = _gaps(device, steps)
    ops = sorted(_iv(e) + (e.get("name", "?"),)
                 for e in _x(events, ("cpu_op",)))
    labelled = [(_label((a + b) / 2, spans, ops, sorted(calls)),
                 (b - a) * 1e-6) for a, b in gaps[:10]]
    return Spans(len(steps), device_s, self_s,
                 {n: len(c) for n, c in corrs.items()}, len(launched),
                 labelled)


def _gaps(device, steps) -> List[Tuple[float, float]]:
    """The stretch's idle intervals, largest first, as ``trace.py``
    finds them."""
    merged: List[List[float]] = []
    for a, b in sorted(_iv(e) for e in device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if steps:
        lo = steps[0][0]
        hi = max(steps[-1][1], merged[-1][1] if merged else steps[-1][1])
    elif merged:
        lo, hi = merged[0][0], merged[-1][1]
    else:
        return []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda ab: ab[0] - ab[1])
    return gaps


def _open_at(t: float, intervals) -> List[tuple]:
    """The intervals (sorted by start) open at ``t``, outermost first."""
    hi = bisect.bisect_right(intervals, (t, float("inf")))
    return sorted((iv for iv in intervals[:hi] if iv[1] >= t),
                  key=lambda iv: (iv[0], -iv[1]))


def _label(t: float, spans, ops, calls) -> str:
    where = [iv[2] for iv in _open_at(t, spans)]
    parts = [">".join(where) if where else "outside the spans"]
    op = _open_at(t, ops)
    call = _open_at(t, calls)
    if op:
        parts.append(f"op {op[-1][2]}")
    if call:
        parts.append(f"cuda {call[-1][2]}")
    if not op and not call:
        hi = bisect.bisect_right(ops, (t, float("inf")))
        before = [iv for iv in ops[:hi] if iv[1] < t]
        if before:
            last = max(before, key=lambda iv: iv[1])
            parts.append(f"after op {last[2]} ({(t - last[1]) * 1e-3:.3f} "
                         f"ms before the midpoint)")
    return "; ".join(parts)


def host_issue(step, state, feed, first: int, dev,
               k: int = HOST_STEPS) -> dict:
    """``k`` steps with a ``SpanRecorder`` active and ``host/gc`` on, no
    profiler, a device synchronisation before each step and after the
    last, outside the spans.  Returns ``{"steps": k, "spans": the
    recorder's snapshot}``."""
    import torch

    from repro_torch.obs.trace import SpanRecorder, gc_spans, recording

    cuda = torch.device(dev).type == "cuda"
    rec = SpanRecorder()
    with recording(rec), gc_spans():
        for i in range(k):
            if cuda:
                torch.cuda.synchronize(dev)
            state, _ = step(state, feed(first + i))
        if cuda:
            torch.cuda.synchronize(dev)
    return {"steps": k, "spans": rec.snapshot()}


def host_ms(host: Optional[dict], name: str, key: str = "total_s"
            ) -> Optional[float]:
    """Host ms a step of span ``name`` in ``host_issue``'s result."""
    if not host or name not in host["spans"]:
        return None
    return 1e3 * host["spans"][name][key] / host["steps"]


def metrics(s: Optional[Spans], host: Optional[dict]) -> Dict[str, float]:
    """The per-layer numbers, those there is something to read for."""
    got: Dict[str, Optional[float]] = {}
    if s is not None:
        got.update(message_ms=s.ms("round/message"),
                   aggregation_ms=s.ms("round/aggregate"),
                   shift_apply_ms=s.ms("round/apply"),
                   forward_ms=s.ms("grads/forward"),
                   backward_ms=s.ms("grads/backward"),
                   wire_ms=s.ms_of("wire/"),
                   launches_per_step=s.launches_per_step())
    issue = [host_ms(host, n) for n in PHASES]
    if issue and all(v is not None for v in issue):
        got["host_issue_ms"] = sum(issue)
    return {k: v for k, v in got.items() if v is not None}


def table(s: Spans, host: Optional[dict]) -> List[str]:
    """Lines: by span, device ms a step (inclusive, self), launches a step
    and host ms a step (total, self); then the labelled gaps."""
    names = sorted(set(s.device_s) | set((host or {}).get("spans", {})))
    rows = [("span", "device_ms", "self_ms", "launches", "host_ms",
             "host_self_ms")]

    def f(v):
        return "-" if v is None else f"{v:.3f}"

    for n in names:
        rows.append((n, f(s.ms(n)),
                     f(1e3 * s.self_s[n] / s.steps if n in s.self_s else None),
                     f(s.launches[n] / s.steps if n in s.launches else None),
                     f(host_ms(host, n)), f(host_ms(host, n, "self_s"))))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    out.append(f"launches a step: {f(s.launches_per_step())}")
    out.append("largest idle gaps:")
    out += [f"  {1e3 * sec:.3f} ms  {label}" for label, sec in s.gaps]
    return out


def checks(s: Spans, summary: trace.Summary) -> Dict[str, float]:
    """Ratios on one timeline: the spans' ``train/*`` against
    ``trace.reduce_trace``'s, the round's parts against the round, the
    passes against the gradients, the wires against the forward passes."""
    out = {}
    for name in PHASES:
        want = summary.phase_ms_per_step(name)
        if want:
            out[f"{name} spans/trace"] = (s.ms(name) or 0.0) / want
    round_ms, grads_ms = (summary.phase_ms_per_step("train/round"),
                          summary.phase_ms_per_step("train/grads"))
    parts = [s.ms(n) or 0.0 for n in ("round/message", "round/aggregate",
                                      "round/apply")]
    if round_ms:
        out["round parts/round"] = sum(parts) / round_ms
    if grads_ms:
        out["passes/grads"] = ((s.ms("grads/forward") or 0.0)
                               + (s.ms("grads/backward") or 0.0)) / grads_ms
    if s.ms_of("wire/") is not None and s.ms("grads/forward"):
        out["wire/forward"] = s.ms_of("wire/") / s.ms("grads/forward")
    return out


def traced_run(cell, seed: int, seconds: float, *, device="cuda",
               t_start=None, log=print) -> dict:
    """The harness's traced run of ``cell``, with ``host/gc`` on in the
    profiled steps, the profiled timeline also reduced by ``reduce``, and
    ``host_issue``'s steps after it: the harness's ``profile`` is hooked
    from outside for the run.  Returns ``{"result", "summary", "spans",
    "host"}``."""
    from perfbench import harness
    from repro_torch.obs.trace import gc_spans

    seen = {}
    profile, reduce_trace = harness.profile, trace.reduce_trace

    def keep(timeline, *a, **kw):
        seen["timeline"] = timeline
        return reduce_trace(timeline, *a, **kw)

    def traced(step, state, feed, first, k, dev):
        trace.reduce_trace = keep
        try:
            with gc_spans():
                summary = profile(step, state, feed, first, k, dev)
        finally:
            trace.reduce_trace = reduce_trace
        seen["spans"] = reduce(seen.pop("timeline"))
        seen["summary"] = summary
        # the profiled steps' last state is the profile's own; the state
        # passed in is stepped again (its tensors are updated in place)
        seen["host"] = host_issue(step, state, feed, first + k + 1, dev)
        return summary

    harness.profile = traced
    try:
        seen["result"] = harness.run_cell(cell, seed, seconds, True,
                                          device=device, t_start=t_start,
                                          log=log)
    finally:
        harness.profile = profile
    return seen


def untraced_run(cell, seed: int, seconds: float, host_spans: str, *,
                 device="cuda", t_start=None, log=print):
    """The harness's untraced run of ``cell`` with a ``SpanRecorder``
    active (``host_spans`` "recorder"), ``host/gc`` on ("gc"), both
    ("both") or neither ("none").  Returns the harness's result and the
    recorder's snapshot (empty unless the recorder was active)."""
    from contextlib import ExitStack

    from perfbench import harness
    from repro_torch.obs.trace import SpanRecorder, gc_spans, recording

    rec = SpanRecorder()
    with ExitStack() as on:
        if host_spans in ("recorder", "both"):
            on.enter_context(recording(rec))
        if host_spans in ("gc", "both"):
            on.enter_context(gc_spans())
        result = harness.run_cell(cell, seed, seconds, False, device=device,
                                  t_start=t_start, log=log)
    return result, rec.snapshot()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--host-spans", choices=("recorder", "gc", "both",
                                              "none"))
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)

    def log(line):
        print(line, file=sys.stderr)

    if args.host_spans is not None:
        result, host_spans = untraced_run(cell, args.seed, args.seconds,
                                          args.host_spans, t_start=T_START,
                                          log=log)
        print(json.dumps({"workload": args.workload,
                          "host_spans_on": args.host_spans,
                          "host_spans": host_spans, "result": result}))
        return 0

    seen = traced_run(cell, args.seed, args.seconds, t_start=T_START,
                      log=log)
    s, host = seen["spans"], seen["host"]
    for line in table(s, host):
        log(line)
    ratios = checks(s, seen["summary"])
    for k, v in ratios.items():
        log(f"ratio {k}: {v:.5f}")
    print(json.dumps({"workload": args.workload, "host_spans_on": None,
                      "spans": metrics(s, host), "ratios": ratios,
                      "gaps": [list(g) for g in s.gaps],
                      "host_spans": host["spans"],
                      "result": seen["result"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
