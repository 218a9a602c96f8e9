"""repro_torch.obs — unified observability: per-wire telemetry, step
tracing, and measured-vs-predicted accounting -- the port of the
reference's ``repro/obs``.

One record schema (``metrics``), one span API (``trace``), one sink
discipline (``sink``), one export surface (``export``):

  ``metrics``  typed counters/gauges/histograms + the versioned
               strict-JSON record schema and the ``finite_or_none`` /
               ``sanitize_tree`` helpers.
  ``trace``    ``span(name)``: a profiler annotation plus a host
               wall-clock span into an active ``SpanRecorder``
               (``annotate(name)``, the annotation alone, tags device
               work inside the eager step: no clock, no op);
               ``StampRecorder`` for the overlap channel's
               reduce_start/finish call windows.
  ``sink``     rotating strict-JSONL, memory, tee, null sinks; every
               record is sanitized + schema-validated before it is
               serialized.
  ``export``   end-of-run summary table, Prometheus text exposition,
               and the CI ``--check`` schema gate.
  ``quality``  measured distortion: ``omega_hat``/NMSE through the
               codecs' real encode paths (on the card, the q8 kernels).
  ``history``  the bench trajectory ledger: BENCH_*.json flattened into
               ``history.jsonl`` keyed by git sha x config fingerprint.
  ``regress``  the CI regression gate over that ledger's baselines
               (per-metric-class tolerance bands, non-zero exit).

THE CONTRACT (tested): with observability off, the trainer step does
exactly what it does without it and this package is not imported; with
it on, the train state is bitwise the state without it -- spans are
profiler tags, the diagnostics consume no draws, and the probes draw
from their own noise.
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Metrics,
    RECORD_KINDS,
    SCHEMA_VERSION,
    event_record,
    finite_or_none,
    make_record,
    run_record,
    sanitize_tree,
    step_record,
    summary_record,
    validate_record,
)
from repro_torch.obs.sink import (
    JsonlSink,
    MemorySink,
    NullSink,
    TeeSink,
    check_jsonl,
    read_jsonl,
    write_strict_json,
)
from repro_torch.obs.trace import (
    SpanRecorder,
    StampRecorder,
    active_recorder,
    recording,
    span,
)
from repro_torch.obs.export import (
    format_table,
    prometheus_text,
    summarize,
    summary_table,
)
from repro_torch.obs.quality import (
    array_distortion,
    distortion_floats,
    tree_distortion,
)

# NOTE: ``history`` and ``regress`` are CLI-first submodules (``python -m
# repro_torch.obs.history`` / ``.regress``) — import them explicitly; an eager
# import here would trip runpy's double-import warning under ``-m``.

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MemorySink",
    "Metrics",
    "NullSink",
    "RECORD_KINDS",
    "SCHEMA_VERSION",
    "SpanRecorder",
    "StampRecorder",
    "TeeSink",
    "active_recorder",
    "array_distortion",
    "check_jsonl",
    "distortion_floats",
    "event_record",
    "finite_or_none",
    "format_table",
    "make_record",
    "tree_distortion",
    "prometheus_text",
    "read_jsonl",
    "recording",
    "run_record",
    "sanitize_tree",
    "span",
    "step_record",
    "summarize",
    "summary_record",
    "summary_table",
    "validate_record",
    "write_strict_json",
]
