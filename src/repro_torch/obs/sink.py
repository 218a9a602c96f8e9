"""Record sinks: memory, tee, null -- the part of the reference's
``repro/obs/sink.py`` the serving fleet uses (the rotating JSONL sink
comes with ROADMAP queue 1, item 11).  ``MemorySink`` keeps validated
records in order: the fleet bridge's stats and the tests read from it.
"""

from __future__ import annotations

from typing import List, Optional

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
