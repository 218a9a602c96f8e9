"""Observability, the part the serving fleet uses: the versioned
strict-JSON record schema (``metrics``: ``event_record``) and the
memory, tee and null sinks (``sink``) -- the port of that much of the
reference's ``repro/obs``.  The JSONL sink, spans, export, quality,
history and regress come with ROADMAP queue 1, item 11."""

from repro_torch.obs.metrics import (
    RECORD_KINDS,
    SCHEMA_VERSION,
    event_record,
    finite_or_none,
    make_record,
    sanitize_tree,
    validate_record,
)
from repro_torch.obs.sink import MemorySink, NullSink, TeeSink

__all__ = [
    "MemorySink",
    "NullSink",
    "RECORD_KINDS",
    "SCHEMA_VERSION",
    "TeeSink",
    "event_record",
    "finite_or_none",
    "make_record",
    "sanitize_tree",
    "validate_record",
]
