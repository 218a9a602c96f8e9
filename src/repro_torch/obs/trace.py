"""Span API: profiler annotations around device work + host wall-clock
spans -- the port of the reference's ``repro/obs/trace.py``.

Two kinds of time live in a train step and they need different tools:

  * DEVICE time.  The port's step is eager: PyTorch returns from a call
    once its kernels are queued, so a host clock around a phase inside
    the step measures the launches, not the work.  ``annotate(name)``
    therefore only tags the region for a running profiler
    (``torch.profiler.record_function``): no host clock, no
    synchronisation and no op, so annotating a phase can never change
    the math -- the counterpart of the reference's ``jax.named_scope``
    + ``TraceAnnotation`` inside jit.  The step's phases
    (``train/grads``, ``train/reduce``, ``train/round``,
    ``train/apply``) are annotated so.
  * HOST time around work that ends in a device synchronisation (the
    trainer's ``host/step``, which waits for the step's state as the
    reference's waits with ``block_until_ready``) is real wall clock.
    ``span(name)`` annotates the region too and, when a
    ``SpanRecorder`` is active, accumulates its ``perf_counter``
    duration into it; the caller synchronises inside the span.  With no
    recorder active the host path is a single ``is None`` check.

``StampRecorder`` is the raw begin/end-timestamp variant the overlap
channel uses: ``AsyncChannel.reduce_start``/``finish`` stamp their call
windows so ``repro_torch.tune.measure.measure_overlap_hide`` can derive
a MEASURED hide fraction from the same handles the runtime schedules.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

#: the active host-span recorder (None = host timing off; module-level
#: because spans are annotated at call sites that never see the trainer's
#: loop)
_ACTIVE: Optional["SpanRecorder"] = None


class SpanRecorder:
    """Accumulated ``{name: (count, total_seconds)}`` host spans."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        cur = self.spans.setdefault(name, [0, 0.0])
        cur[0] += 1
        cur[1] += seconds

    def snapshot(self) -> dict:
        """{name: {count, total_s, mean_s}} — drops into a record."""
        return {
            name: {
                "count": int(c),
                "total_s": float(t),
                "mean_s": float(t) / c if c else None,
            }
            for name, (c, t) in self.spans.items()
        }

    def clear(self) -> None:
        self.spans.clear()


@contextmanager
def recording(recorder: SpanRecorder):
    """Activate ``recorder`` for host spans within the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, recorder
    try:
        yield recorder
    finally:
        _ACTIVE = prev


def active_recorder() -> Optional[SpanRecorder]:
    return _ACTIVE


@contextmanager
def annotate(name: str):
    """Tag a region of device work for the profiler, and nothing else
    (module docstring): no clock, no synchronisation, no op; with no
    profiler running, not even the tag."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextmanager
def span(name: str):
    """Annotate one host phase (see module docstring) and, with a
    ``SpanRecorder`` active, wall-clock it into the recorder.  The
    caller ends the region with a device synchronisation when the span
    is meant to hold the device's work."""
    rec = _ACTIVE
    t0 = time.perf_counter() if rec is not None else 0.0
    with annotate(name):
        yield
    if rec is not None:
        rec.add(name, time.perf_counter() - t0)


class StampRecorder:
    """Raw ``(name, t_begin, t_end)`` call-window stamps.

    The overlap channel's ``reduce_start``/``finish`` stamp here (host
    side only: a stamp reads the clock around the call and touches
    nothing the call computes, so attaching a recorder never changes a
    round).
    """

    def __init__(self):
        self.events: List[Tuple[str, float, float]] = []

    @contextmanager
    def stamp(self, name: str):
        t0 = time.perf_counter()
        yield
        self.events.append((name, t0, time.perf_counter()))

    def clear(self) -> None:
        self.events.clear()

    def windows(self, name: str) -> List[Tuple[float, float]]:
        return [(t0, t1) for n, t0, t1 in self.events if n == name]

    def total(self, name: str) -> float:
        return sum(t1 - t0 for t0, t1 in self.windows(name))
