"""The reduction of a profiled stretch of training steps to what the
per-layer metrics read.

Input: the profiler's timeline as a Chrome trace (``traceEvents``, times
in microseconds).  Device activity is every kernel, copy and fill.  A
device activity belongs to the host annotation (``train/grads``,
``train/round``, ...) that was open when the host launched it: its
launch is the host's CUDA API call with the same correlation id, and
that call's start lies inside the annotation.  An activity whose launch
the timeline does not show is given to the annotation whose matched
activities span its start on the device.  The stretch is the span of
the ``bench/step`` annotations that bracket each profiled step, to the
end of the last device activity.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host's CUDA API calls (runtime and lower-level), which carry the
#: correlation id of what they launched
LAUNCH_PREFIX = "cuda_"
STEP_TAG = "bench/step"


@dataclass
class Summary:
    steps: int                                  # profiled steps
    window_s: float                             # the stretch's wall time
    busy_s: float                               # union of device activity
    phase_s: Dict[str, float]                   # device s by annotation
    kernels: Dict[str, List[float]]             # name -> [count, device s]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def phase_ms_per_step(self, name: str) -> Optional[float]:
        if name not in self.phase_s or not self.steps:
            return None
        return 1e3 * self.phase_s[name] / self.steps

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, s] for name, (_, s) in top]


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _corr(e) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


def reduce_trace(trace: dict, phases=("train/",)) -> Summary:
    events = trace["traceEvents"]
    host = _x(events, ("user_annotation", "cpu_op"))
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in host if e.get("name") == STEP_TAG)
    annos = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in host
                   if e.get("cat") == "user_annotation"
                   and any(e.get("name", "").startswith(p) for p in phases))
    device = _x(events, DEVICE_CATS)
    if steps:
        lo = steps[0][0]
        device = [e for e in device if float(e["ts"]) + float(e["dur"]) >= lo]
    launch_at = {}
    for e in events:
        if e.get("ph") != "X" or not e.get("cat", "").startswith(LAUNCH_PREFIX):
            continue
        c = _corr(e)
        if c is not None:
            launch_at[c] = float(e["ts"])

    starts = [a[0] for a in annos]

    def anno_index(t: float) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and annos[i][0] <= t <= annos[i][1]:
            return i
        return None

    def anno_at(t: float) -> Optional[str]:
        i = anno_index(t)
        return None if i is None else annos[i][2]

    phase_s: Dict[str, float] = {}
    spans: Dict[int, List[float]] = {}      # annotation -> its device span
    unmatched = []
    kernels: Dict[str, List[float]] = {}
    for e in device:
        ts, dur = float(e["ts"]), float(e["dur"])
        k = kernels.setdefault(e.get("name", "?"), [0, 0.0])
        k[0] += 1
        k[1] += dur * 1e-6
        t = launch_at.get(_corr(e))
        if t is None:
            unmatched.append(e)
            continue
        i = anno_index(t)
        if i is None:
            continue
        phase_s[annos[i][2]] = phase_s.get(annos[i][2], 0.0) + dur * 1e-6
        sp = spans.setdefault(i, [ts, ts + dur])
        sp[0], sp[1] = min(sp[0], ts), max(sp[1], ts + dur)
    for e in unmatched:
        ts = float(e["ts"])
        for i, (a, b) in spans.items():
            if a <= ts <= b:
                name = annos[i][2]
                phase_s[name] = phase_s.get(name, 0.0) + float(e["dur"]) * 1e-6
                break

    intervals = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in device)
    merged: List[List[float]] = []
    for a, b in intervals:
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
        lo = hi = 0.0
    busy = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)

    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda ab: ab[0] - ab[1])
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "?")) for e in host
                 if e.get("cat") == "cpu_op")

    def host_at(t: float) -> str:
        inner = None
        for a, b, name in ops:
            if a > t:
                break
            if b >= t and (inner is None or b - a < inner[1] - inner[0]):
                inner = (a, b, name)
        where = anno_at(t) or "outside the step's phases"
        return where + ("" if inner is None else f": {inner[2]}")

    labelled = [(host_at((a + b) / 2), (b - a) * 1e-6) for a, b in gaps[:10]]
    return Summary(len(steps), (hi - lo) * 1e-6, busy * 1e-6, phase_s,
                   kernels, labelled)
