"""Record sinks: rotating strict-JSONL on disk, memory, tee, null -- the
port of the reference's ``repro/obs/sink.py``.

Every sink enforces the same discipline: records are sanitized
(``sanitize_tree``) and validated (``validate_record``) BEFORE they are
serialized with ``allow_nan=False`` -- an artifact a downstream RFC 8259
parser rejects is a bug here, not there.

``JsonlSink`` rotates by size: when the live file would exceed
``rotate_bytes`` the existing files shift ``path -> path.1 -> path.2``
up to ``keep`` generations (newest rotation is ``.1``).  ``MemorySink``
keeps validated records in order: the fleet bridge's stats and the tests
read from it.  ``NullSink`` swallows everything (the obs-off path).
``write_strict_json`` is the one-shot whole-artifact writer.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from repro_torch.obs.metrics import sanitize_tree, validate_record


class NullSink:
    """Swallows every record — the disabled-observability path."""

    def emit(self, rec: dict) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink:
    """Keeps validated records in order (tests, serving-bridge stats)."""

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, rec: dict) -> None:
        self.records.append(validate_record(sanitize_tree(rec)))

    def close(self) -> None:
        pass

    def by_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r.get("kind") == kind]

    def events(self, name: Optional[str] = None) -> List[dict]:
        return [r for r in self.by_kind("event")
                if name is None or r.get("name") == name]


class TeeSink:
    """Fans one emit out to several sinks (the serving bridge keeps a
    MemorySink for its stats AND forwards to the run's JSONL sink)."""

    def __init__(self, *sinks):
        self.sinks = tuple(s for s in sinks if s is not None)

    def emit(self, rec: dict) -> None:
        for s in self.sinks:
            s.emit(rec)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class JsonlSink:
    """Append-only strict-JSONL file with size rotation (docstring)."""

    def __init__(self, path: str, *, rotate_bytes: int = 64 << 20,
                 keep: int = 3):
        if rotate_bytes <= 0:
            raise ValueError(
                f"rotate_bytes must be positive, got {rotate_bytes}"
            )
        self.path = path
        self.rotate_bytes = rotate_bytes
        self.keep = max(1, keep)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._nbytes = self._f.tell()

    def _rotate(self) -> None:
        self._f.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a")
        self._nbytes = 0

    def emit(self, rec: dict) -> None:
        rec = validate_record(sanitize_tree(rec))
        line = json.dumps(rec, sort_keys=True, allow_nan=False) + "\n"
        if self._nbytes and self._nbytes + len(line) > self.rotate_bytes:
            self._rotate()
        self._f.write(line)
        self._f.flush()
        self._nbytes += len(line)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_jsonl(path: str, *, validate: bool = True) -> List[dict]:
    """Load one JSONL file; with ``validate`` every record must pass the
    schema check (the CI ``--check`` path reads through here)."""
    out: List[dict] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from e
            if validate:
                try:
                    validate_record(rec)
                except ValueError as e:
                    raise ValueError(f"{path}:{i}: {e}") from e
            out.append(rec)
    return out


def check_jsonl(path: str) -> Tuple[int, List[str]]:
    """Schema-check every line: ``(n_valid, errors)``.  Unlike
    ``read_jsonl`` this collects ALL failures (CI prints them in one
    pass instead of dying on the first)."""
    n_valid = 0
    errors: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                validate_record(json.loads(line))
                n_valid += 1
            except (json.JSONDecodeError, ValueError) as e:
                errors.append(f"{path}:{i}: {e}")
    return n_valid, errors


def write_strict_json(path: str, obj) -> str:
    """Whole-artifact strict-JSON writer (sanitize, then
    ``allow_nan=False`` as the backstop)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(sanitize_tree(obj), f, indent=2, sort_keys=True,
                  allow_nan=False)
    return path
