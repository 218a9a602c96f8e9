"""The obs record schema: typed metrics + versioned strict-JSON records
-- the port of the reference's ``repro/obs/metrics.py``.

Everything the observability layer emits (trainer steps, transport wire
accounting, serving-fleet events, summaries) is ONE record shape: a flat
dict with a schema version (``v``), a ``kind`` from ``RECORD_KINDS``,
the kind's identity fields (``step`` / ``name`` / ``run``) and a
``data`` dict of JSON scalars and nested dicts/lists.
``validate_record`` enforces the shape strictly (unknown top-level keys,
a wrong version and non-finite floats are all errors), so a JSONL file
that validates here validates in the reference too, and the other way
round; ``sanitize_tree`` is where inf/nan becomes ``null`` before that.
No record field holds wall-clock time of day.

The typed metric classes (``Counter`` / ``Gauge`` / ``Histogram``) are
host-side aggregation state for the training loops; ``Metrics`` is a tiny
registry whose ``snapshot()`` drops straight into a record's ``data``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

#: bump when the record shape changes — old readers must fail loudly,
#: not misparse (v1: initial schema — run/step/event/summary kinds)
SCHEMA_VERSION = 1

#: every record kind the schema admits
RECORD_KINDS = ("run", "step", "event", "summary")

#: top-level keys a record may carry (everything else rides in ``data``)
_ALLOWED_KEYS = frozenset({"v", "kind", "run", "step", "name", "data"})

#: identity fields each kind REQUIRES beyond ``v``/``kind``/``data``
_REQUIRED_BY_KIND = {
    "run": ("run",),
    "step": ("step",),
    "event": ("name", "step"),
    "summary": ("name",),
}


def finite_or_none(x) -> Optional[float]:
    """inf/nan -> None so artifacts stay STRICT JSON (json.dump would
    happily emit a bare ``Infinity`` token, which RFC 8259 parsers —
    jq, JSON.parse — reject); None means 'no finite value'."""
    x = float(x)
    return x if math.isfinite(x) else None


def sanitize_tree(obj):
    """null-out non-finite floats recursively (dicts/lists/tuples), and
    coerce numpy/torch scalars to Python scalars — the one strict-JSON
    normalization pass every writer shares."""
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        return finite_or_none(obj)
    if isinstance(obj, dict):
        return {str(k): sanitize_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_tree(v) for v in obj]
    # numpy / torch scalar-likes: anything float()-able becomes a float
    try:
        return finite_or_none(float(obj))
    except (TypeError, ValueError):
        return str(obj)


def _check_finite(obj, path: str) -> None:
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return
    if isinstance(obj, float):
        if not math.isfinite(obj):
            raise ValueError(
                f"record field {path} is non-finite ({obj!r}); run "
                "sanitize_tree before validating"
            )
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"record key {path}.{k!r} is not a string")
            _check_finite(v, f"{path}.{k}")
        return
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_finite(v, f"{path}[{i}]")
        return
    raise ValueError(
        f"record field {path} has non-JSON type {type(obj).__name__}; "
        "run sanitize_tree before validating"
    )


def validate_record(rec: dict) -> dict:
    """STRICT schema check; returns ``rec`` unchanged or raises
    ``ValueError`` naming the offending field.

    Pins: ``v == SCHEMA_VERSION`` exactly, ``kind`` in ``RECORD_KINDS``,
    the kind's required identity fields present and typed, no unknown
    top-level keys, and every float finite (records must be sanitized
    before they are validated/written).
    """
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a dict, got {type(rec).__name__}")
    v = rec.get("v")
    if v != SCHEMA_VERSION:
        raise ValueError(
            f"record version {v!r} != {SCHEMA_VERSION} (obs schema is "
            "pinned; re-emit with the current writer)"
        )
    kind = rec.get("kind")
    if kind not in RECORD_KINDS:
        raise ValueError(
            f"unknown record kind {kind!r}; have {RECORD_KINDS}"
        )
    unknown = set(rec) - _ALLOWED_KEYS
    if unknown:
        raise ValueError(
            f"unknown record keys {sorted(unknown)}; "
            f"allowed {sorted(_ALLOWED_KEYS)} (payload belongs in 'data')"
        )
    for field in _REQUIRED_BY_KIND[kind]:
        if field not in rec:
            raise ValueError(f"{kind} record missing required {field!r}")
    if "step" in rec:
        step = rec["step"]
        if not isinstance(step, int) or isinstance(step, bool) or step < 0:
            raise ValueError(
                f"record step must be an int >= 0, got {step!r}"
            )
    for field in ("run", "name"):
        if field in rec and not isinstance(rec[field], str):
            raise ValueError(
                f"record {field} must be a string, got {rec[field]!r}"
            )
    data = rec.get("data", {})
    if not isinstance(data, dict):
        raise ValueError(
            f"record data must be a dict, got {type(data).__name__}"
        )
    _check_finite(data, "data")
    return rec


def make_record(kind: str, *, run: Optional[str] = None,
                step: Optional[int] = None, name: Optional[str] = None,
                data: Optional[dict] = None) -> dict:
    """Build + sanitize + validate one record (the only constructor the
    emitters use, so an invalid record can never reach a sink)."""
    rec: Dict[str, Any] = {"v": SCHEMA_VERSION, "kind": kind}
    if run is not None:
        rec["run"] = str(run)
    if step is not None:
        rec["step"] = int(step)
    if name is not None:
        rec["name"] = str(name)
    rec["data"] = sanitize_tree(data or {})
    return validate_record(rec)


def step_record(step: int, *, run: Optional[str] = None, **data) -> dict:
    """One per-step record (loss, timings, drift norms, wire bytes...)."""
    return make_record("step", run=run, step=step, data=data)


def event_record(name: str, step: int, **data) -> dict:
    """One structured event (resync, publish, unresolved_whiles...)."""
    return make_record("event", name=name, step=step, data=data)


def run_record(run: str, **data) -> dict:
    """The run header: static facts (arch, comm mode, per-wire
    accounting, measured hide fraction) every step record shares."""
    return make_record("run", run=run, data=data)


def summary_record(name: str, **data) -> dict:
    """An end-of-run / bench aggregate."""
    return make_record("summary", name=name, data=data)


# ---------------------------------------------------------------------------
# Typed host-side metrics
# ---------------------------------------------------------------------------


class Counter:
    """Monotone count (events, resyncs, publishes)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc of negative {n} (use a Gauge)")
        self.value += n

    def to_value(self):
        return self.value


class Gauge:
    """Last-write-wins level (staleness, hide fraction, loss)."""

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, x: float) -> None:
        self.value = float(x)

    def to_value(self):
        return None if self.value is None else finite_or_none(self.value)


class Histogram:
    """Streaming summary (count/sum/min/max) of an observed series —
    enough for p50-free step-time accounting without storing samples."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            return
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    @property
    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def to_value(self):
        return {
            "count": self.count,
            "sum": finite_or_none(self.total),
            "min": None if self.min is None else finite_or_none(self.min),
            "max": None if self.max is None else finite_or_none(self.max),
            "mean": None if self.mean is None else finite_or_none(self.mean),
        }


class Metrics:
    """A tiny named registry of the typed metrics above.

    ``snapshot()`` returns a plain dict ready for a record's ``data``;
    metric names are created on first touch (``m.counter("resyncs")``).
    """

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        return {name: m.to_value() for name, m in self._metrics.items()}
