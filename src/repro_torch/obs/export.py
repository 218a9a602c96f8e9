"""End-of-run exports: summary table, Prometheus text, CI schema check --
the port of the reference's ``repro/obs/export.py`` (same strings from
the same records).

    PYTHONPATH=src python -m repro_torch.obs.export --check run.jsonl
    PYTHONPATH=src python -m repro_torch.obs.export --summary run.jsonl
    PYTHONPATH=src python -m repro_torch.obs.export --prom run.jsonl

``summarize`` folds a record stream into one ``summary`` record:
step-time statistics (measured AND predicted, plus their ratio — the
continuously tracked version of the ``BENCH_autotune.json`` predictor
gap), final loss/bits, per-wire byte totals from the run header, the
measured overlap hide fraction, and event counts by name.

``prometheus_text`` renders the same aggregate in the Prometheus text
exposition format (``# TYPE`` + ``name{labels} value`` lines) so a
scrape-based dashboard can ingest a finished run without a custom
parser.  ``--check`` is the CI gate: exit 1 unless every line of the
JSONL validates against the pinned schema.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Histogram, finite_or_none, summary_record
from repro_torch.obs.sink import check_jsonl, read_jsonl


def _num(x) -> Optional[float]:
    return None if x is None else finite_or_none(x)


def summarize(records: List[dict], *, name: str = "run") -> dict:
    """Fold a record stream into one ``summary`` record (docstring)."""
    steps = [r for r in records if r.get("kind") == "step"]
    runs = [r for r in records if r.get("kind") == "run"]
    events = [r for r in records if r.get("kind") == "event"]

    h_step = Histogram()
    h_pred = Histogram()
    h_ratio = Histogram()
    h_resid = Histogram()
    h_resid_ratio = Histogram()
    last_loss = None
    last_bits = None
    resid_first = None
    resid_last = None
    for r in steps:
        d = r.get("data", {})
        t = _num(d.get("step_s"))
        p = _num(d.get("predicted_step_s"))
        if t is not None:
            h_step.observe(t)
        if p is not None:
            h_pred.observe(p)
        if t is not None and p is not None and t > 0:
            h_ratio.observe(p / t)
        if d.get("loss") is not None:
            last_loss = _num(d.get("loss"))
        if d.get("bits") is not None:
            last_bits = _num(d.get("bits"))
        # the shift-residual trajectory ||g - h||^2 (vs ||g||^2): the
        # paper's headline effect — shrinking under DIANA/EF-BV, flat
        # (ratio 1) under plain DCGD
        rs = _num(d.get("shift_residual_sq"))
        gs = _num(d.get("grad_sq"))
        if rs is not None:
            h_resid.observe(rs)
            if resid_first is None:
                resid_first = rs
            resid_last = rs
        if rs is not None and gs is not None and gs > 0:
            h_resid_ratio.observe(rs / gs)

    wires = {}
    hide = None
    hide_source = None
    omega = None
    omega_source = None
    for r in runs:
        d = r.get("data", {})
        wires.update(d.get("wires") or {})
        if d.get("hide_fraction") is not None:
            hide = _num(d.get("hide_fraction"))
            hide_source = d.get("hide_source")
        if d.get("omega") is not None:
            omega = _num(d.get("omega"))
        if d.get("omega_source") is not None:
            omega_source = d.get("omega_source")

    by_event: Dict[str, int] = {}
    for r in events:
        by_event[r["name"]] = by_event.get(r["name"], 0) + 1

    return summary_record(
        name,
        n_steps=len(steps),
        step_s=h_step.to_value(),
        predicted_step_s=h_pred.to_value(),
        predicted_over_actual=h_ratio.to_value(),
        final_loss=last_loss,
        final_bits=last_bits,
        wires=wires,
        hide_fraction=hide,
        hide_source=hide_source,
        omega=omega,
        omega_source=omega_source,
        shift_residual_sq=h_resid.to_value(),
        shift_residual_over_grad=h_resid_ratio.to_value(),
        shift_residual_first=resid_first,
        shift_residual_last=resid_last,
        events=by_event,
    )


def _fmt(x) -> str:
    if x is None:
        return "n/a"
    if isinstance(x, float):
        return f"{x:.3e}" if (abs(x) >= 1e4 or 0 < abs(x) < 1e-3) else f"{x:.4g}"
    return str(x)


def format_table(title: str, header: List[str], rows: List[tuple]) -> str:
    """The repo's bench-table look, as a string (the reference's
    ``benchmarks/common.print_table`` prints the same table)."""
    out = [f"\n## {title}"]
    widths = [max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
              for i, h in enumerate(header)]
    out.append("  ".join(str(h).ljust(w) for h, w in zip(header, widths)))
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def summary_table(records: List[dict], *, name: str = "run") -> str:
    """Human-readable end-of-run table from a record stream."""
    s = summarize(records, name=name)["data"]
    rows = [
        ("steps", s["n_steps"], ""),
        ("step_s (mean)", _fmt((s["step_s"] or {}).get("mean")),
         f"min {_fmt((s['step_s'] or {}).get('min'))} / "
         f"max {_fmt((s['step_s'] or {}).get('max'))}"),
        ("predicted_step_s (mean)",
         _fmt((s["predicted_step_s"] or {}).get("mean")), ""),
        ("predicted/actual (mean)",
         _fmt((s["predicted_over_actual"] or {}).get("mean")),
         "the tracked tuner-predictor gap"),
        ("final loss", _fmt(s["final_loss"]), ""),
        ("final bits", _fmt(s["final_bits"]), ""),
        ("overlap hide fraction", _fmt(s["hide_fraction"]),
         s["hide_source"] or ""),
        ("omega", _fmt(s.get("omega")), s.get("omega_source") or ""),
        ("shift resid/grad (mean)",
         _fmt((s.get("shift_residual_over_grad") or {}).get("mean")),
         f"||g-h||^2: first {_fmt(s.get('shift_residual_first'))} -> "
         f"last {_fmt(s.get('shift_residual_last'))}"),
    ]
    for wname, w in sorted((s["wires"] or {}).items()):
        rows.append((
            f"wire {wname}",
            f"{_fmt((w or {}).get('payload_bytes'))} B/step payload",
            f"enc {_fmt((w or {}).get('encode_s'))}s / "
            f"dec {_fmt((w or {}).get('decode_s'))}s / "
            f"omega_hat {_fmt((w or {}).get('omega_hat'))}",
        ))
    for ev, n in sorted((s["events"] or {}).items()):
        rows.append((f"event {ev}", n, ""))
    return format_table(f"obs summary [{name}]",
                        ["metric", "value", "notes"], rows)


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(records: List[dict], *, name: str = "run") -> str:
    """Prometheus text exposition of the run aggregate (docstring)."""
    s = summarize(records, name=name)["data"]
    run = _prom_escape(name)
    lines: List[str] = []

    def gauge(metric: str, value, labels: str = "") -> None:
        if value is None:
            return
        lines.append(f"# TYPE {metric} gauge")
        lab = f'run="{run}"' + (f",{labels}" if labels else "")
        lines.append(f"{metric}{{{lab}}} {value}")

    gauge("repro_steps_total", s["n_steps"])
    gauge("repro_step_seconds_mean", (s["step_s"] or {}).get("mean"))
    gauge("repro_predicted_step_seconds_mean",
          (s["predicted_step_s"] or {}).get("mean"))
    gauge("repro_predicted_over_actual_mean",
          (s["predicted_over_actual"] or {}).get("mean"))
    gauge("repro_final_loss", s["final_loss"])
    gauge("repro_uplink_bits_total", s["final_bits"])
    gauge("repro_overlap_hide_fraction", s["hide_fraction"])
    gauge("repro_omega", s.get("omega"))
    gauge("repro_shift_residual_sq",
          (s.get("shift_residual_sq") or {}).get("mean"))
    gauge("repro_shift_residual_over_grad",
          (s.get("shift_residual_over_grad") or {}).get("mean"))
    for wname, w in sorted((s["wires"] or {}).items()):
        lab = f'wire="{_prom_escape(wname)}"'
        gauge("repro_wire_bits_per_step", (w or {}).get("wire_bits"), lab)
        gauge("repro_wire_payload_bytes_per_step",
              (w or {}).get("payload_bytes"), lab)
        gauge("repro_wire_encode_seconds", (w or {}).get("encode_s"), lab)
        gauge("repro_wire_decode_seconds", (w or {}).get("decode_s"), lab)
        gauge("repro_wire_omega_hat", (w or {}).get("omega_hat"), lab)
        gauge("repro_wire_nmse", (w or {}).get("nmse"), lab)
    for ev, n in sorted((s["events"] or {}).items()):
        lines.append("# TYPE repro_events_total counter")
        lines.append(
            f'repro_events_total{{run="{run}",'
            f'event="{_prom_escape(ev)}"}} {n}'
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="obs JSONL exports: schema check / summary / prometheus"
    )
    ap.add_argument("paths", nargs="+", help="obs JSONL file(s)")
    ap.add_argument("--check", action="store_true",
                    help="schema-validate every line; exit 1 on failure")
    ap.add_argument("--summary", action="store_true",
                    help="print the end-of-run summary table")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text exposition")
    args = ap.parse_args(argv)
    if not (args.check or args.summary or args.prom):
        args.summary = True

    rc = 0
    for path in args.paths:
        if args.check:
            n, errors = check_jsonl(path)
            if errors:
                rc = 1
                print(f"{path}: {len(errors)} invalid record(s) "
                      f"({n} valid):", file=sys.stderr)
                for e in errors[:20]:
                    print(f"  {e}", file=sys.stderr)
            else:
                print(f"{path}: {n} records, schema v-pinned OK")
        if args.summary or args.prom:
            records = read_jsonl(path, validate=not args.check)
            if args.summary:
                print(summary_table(records, name=path))
            if args.prom:
                print(prometheus_text(records, name=path), end="")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
