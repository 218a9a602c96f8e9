"""The span primitive: ``span(name)`` marks one region of the step where
work is issued, for a running profiler and for an active
``SpanRecorder``; with neither, it is free.

The step is eager: PyTorch returns from a call once its kernels are
queued, so a host clock around a region inside the step measures the
host's issue time, not the device's work.  ``span`` therefore

  * with ``torch.profiler`` running, opens a profiler range
    (``record_function``), which lies on the device trace's clock: the
    device activities launched inside it are the region's device time;
  * with a ``SpanRecorder`` active (``recording``), adds the region's
    ``perf_counter`` duration to it, with the time of the spans opened
    inside it on the same thread, so the recorder keeps each span's
    self time beside its total;
  * with neither, returns a shared no-op context: no clock read, no
    synchronisation, no tensor op.  Nothing a span does touches what
    the step computes.

``count(name, n)`` is a counter beside the spans: with a recorder
active it adds ``n`` to the recorder's entry ``name``, a count with no
time of its own (so the recorder's tables show it as a span), and
with none it does nothing.

``gc_spans()`` adds the ``host/gc`` span: each Python garbage
collection inside the block is a span, through ``gc.callbacks``.

This module is a leaf (it imports only ``torch``), so the step's call
sites use it without importing ``repro_torch.obs``, which re-exports it
(``obs.trace``).
"""

from __future__ import annotations

import gc
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

#: the active recorder (None = host timing off; module-level because
#: spans are opened at call sites that never see the trainer's loop)
_ACTIVE: Optional["SpanRecorder"] = None
_OFF = nullcontext()
GC_SPAN = "host/gc"


class SpanRecorder:
    """Host time by span name: ``{name: [count, total_s, self_s,
    parents]}``, ``parents`` the names of the spans it was opened in
    (``None`` at the top).  Self time is the total less the spans opened
    inside it on its thread.  Bounded by the number of span names: no
    per-event list."""

    def __init__(self):
        self.spans: Dict[str, list] = {}
        self._local = threading.local()

    def _stack(self) -> List[list]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> None:
        self._stack().append([name, 0.0])

    def close(self, seconds: float) -> None:
        """Close the span opened last on this thread, ``seconds`` long."""
        stack = self._stack()
        name, inner = stack.pop()
        parent = None
        if stack:
            parent = stack[-1][0]
            stack[-1][1] += seconds
        cur = self.spans.setdefault(name, [0, 0.0, 0.0, set()])
        cur[0] += 1
        cur[1] += seconds
        cur[2] += seconds - inner
        cur[3].add(parent)

    def count(self, name: str, n: int) -> None:
        """A counter: ``n`` more under ``name``, no time, its parent the
        span open last on this thread."""
        stack = self._stack()
        cur = self.spans.setdefault(name, [0, 0.0, 0.0, set()])
        cur[0] += n
        cur[3].add(stack[-1][0] if stack else None)

    def snapshot(self) -> dict:
        """{name: {count, total_s, mean_s, self_s, parent}} -- drops into
        a record; ``parent`` is the enclosing span's name (None at the
        top; names joined by ``|`` where it was opened in several)."""
        return {
            name: {
                "count": int(c),
                "total_s": float(t),
                "mean_s": float(t) / c if c else None,
                "self_s": float(s),
                "parent": _parent(parents),
            }
            for name, (c, t, s, parents) in self.spans.items()
        }

    def clear(self) -> None:
        self.spans.clear()


def _parent(parents: set) -> Optional[str]:
    named = sorted(p for p in parents if p is not None)
    if not named:
        return None
    return "|".join(named + (["(top)"] if None in parents else []))


@contextmanager
def recording(recorder: SpanRecorder):
    """Activate ``recorder`` for spans within the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, recorder
    try:
        yield recorder
    finally:
        _ACTIVE = prev


def active_recorder() -> Optional[SpanRecorder]:
    return _ACTIVE


class _Span:
    __slots__ = ("name", "rec", "range", "t0")

    def __init__(self, name: str, rec: Optional[SpanRecorder]):
        self.name, self.rec, self.range = name, rec, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.rec is not None:
            self.rec.open(self.name)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.close(time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """The context of one span (module docstring): a profiler range while
    the profiler runs, host time into the active recorder, else
    nothing."""
    rec = _ACTIVE
    if rec is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, rec)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the active recorder, if any
    (module docstring)."""
    if _ACTIVE is not None:
        _ACTIVE.count(name, n)


#: the ``host/gc`` span of the collection under way (collections do not
#: nest)
_gc_open: List = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        s = span(GC_SPAN)
        s.__enter__()
        _gc_open.append(s)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


@contextmanager
def gc_spans():
    """Within the block, each Python garbage collection is a ``host/gc``
    span (a profiler range, and host time into the active recorder).
    Nested blocks register it once."""
    if _on_gc in gc.callbacks:
        yield
        return
    gc.callbacks.append(_on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(_on_gc)
