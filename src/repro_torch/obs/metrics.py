"""The obs record schema: versioned strict-JSON records -- the part of
the reference's ``repro/obs/metrics.py`` the serving fleet emits through
(``event_record``), copied without its typed host metrics.

A record is a flat dict with a schema version (``v``), a ``kind`` from
``RECORD_KINDS``, the kind's identity fields (``step`` / ``name`` /
``run``) and a ``data`` dict of JSON scalars and nested dicts/lists.
``validate_record`` enforces the shape strictly (unknown top-level keys,
a wrong version and non-finite floats are all errors); ``sanitize_tree``
is where inf/nan becomes ``null`` before that.
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


def event_record(name: str, step: int, **data) -> dict:
    """One structured event (resync, publish, unresolved_whiles...)."""
    return make_record("event", name=name, step=step, data=data)
