"""Span API: spans at the step's layer boundaries, for the profiler and
for host wall-clock -- the port of the reference's ``repro/obs/trace.py``.

``span(name)`` is the one primitive (it lives in the leaf module
``repro_torch.spans``, so the step's call sites use it without
importing ``obs``; re-exported here).  Two kinds of time live in a
train step and a span serves both:

  * DEVICE time.  The port's step is eager: PyTorch returns from a call
    once its kernels are queued.  With ``torch.profiler`` running, a
    span is a profiler range (``record_function``) on the device
    trace's clock, and the device activities launched inside it are
    its device time -- the counterpart of the reference's
    ``jax.named_scope`` + ``TraceAnnotation`` inside jit.  The step's
    phases (``train/grads``, ``train/reduce``, ``train/round``,
    ``train/apply``), each worker's passes (``grads/forward``,
    ``grads/backward``), the round's parts (``round/message``,
    ``round/aggregate``, ``round/apply``) and each wire send
    (``wire/<name>``) are spans.
  * HOST time.  With a ``SpanRecorder`` active (``recording``), a span
    adds its ``perf_counter`` duration into it, and the recorder keeps
    each name's count, total, self time (the total less the spans
    opened inside it) and enclosing span.  Inside the step that is the
    host's issue time; around work that ends in a device
    synchronisation (the trainer's ``host/step``, which waits for the
    step's state as the reference's waits with ``block_until_ready``)
    it is the step's wall clock.  ``gc_spans()`` adds ``host/gc``, one
    span a Python garbage collection.

With neither the profiler nor a recorder, a span is a shared no-op
context: no clock read, no synchronisation and no op, so a span can
never change the math.

``StampRecorder`` is the raw begin/end-timestamp variant the overlap
channel uses: ``AsyncChannel.reduce_start``/``finish`` stamp their call
windows so ``repro_torch.tune.measure.measure_overlap_hide`` can derive
a MEASURED hide fraction from the same handles the runtime schedules.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Tuple

from repro_torch.spans import (  # noqa: F401  (re-exported)
    GC_SPAN,
    SpanRecorder,
    active_recorder,
    gc_spans,
    recording,
    span,
)


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
