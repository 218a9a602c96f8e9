"""The bench regression gate: current BENCH_*.json vs a recorded baseline
-- the port of the reference's ``repro/obs/regress.py``, which reads the
reference's baseline files (``experiments/obs/baseline.json``) unchanged.

``python -m repro_torch.obs.regress --baseline
experiments/obs/baseline.json BENCH_*.json`` compares every artifact's flattened metrics
(``repro_torch.obs.history``) against the baseline with PER-CLASS tolerance
bands and exits non-zero on any violation — the CI gate that makes a
silent perf/quality regression impossible:

* **timing** metrics (``*_s``, ``*time*``, ``*elapsed*``) — one-sided:
  only a slowdown beyond ``--timing_rtol`` (default +15%) violates;
  getting faster never does.  The COMMITTED baseline strips timings by
  default (``freeze``): CPU CI runners are too noisy to gate absolute
  times across machines, so CI proves the timing band works by freezing
  a same-run baseline and re-checking with ``--inject`` (which scales
  the current timing metrics — a synthetic regression the gate MUST
  catch).
* **structural** metrics (bits, bytes, counts, steps, tokens...) —
  two-sided ``--structural_rtol`` (default 1%): wire accounting is
  deterministic; any drift is a real behavior change.
* everything else (loss, err_rel, omega_hat, ratios) — two-sided
  ``--rtol`` (default 25%): quality numbers jitter across seeds/BLAS
  builds but an order-of-magnitude move must trip.

Artifacts are compared per **config fingerprint**: when the baseline
and current fingerprints differ (the artifact now measures different
things) only the INTERSECTING metrics are compared and a note is
printed; when they match, a metric that DISAPPEARED is itself a
violation.

Exit codes: 0 clean, 1 regression(s), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.obs.history import config_fingerprint, flatten_metrics, git_sha
from repro_torch.obs.sink import write_strict_json

#: baseline artifact schema version — readers must fail loudly on drift
BASELINE_VERSION = 1

_TIMING_MARKS = ("time", "elapsed", "seconds")
_STRUCT_MARKS = ("bits", "bytes", "bucket")
_STRUCT_NAMES = frozenset({
    "count", "steps", "iters", "n", "workers", "replicas", "tokens",
    "publishes", "resyncs", "applied", "entries", "seq", "staleness",
    "rank", "n_buckets", "tokens_served", "requests_done", "d_total",
    "n_leaves",
})


def classify(metric: str) -> str:
    """Tolerance class of one dotted metric path (module docstring)."""
    seg = metric.rsplit(".", 1)[-1]
    if "[" in seg:
        seg = seg.split("[", 1)[0]
    low = seg.lower()
    if low.endswith("_s") or low == "s" or any(m in low
                                               for m in _TIMING_MARKS):
        return "timing"
    if any(m in low for m in _STRUCT_MARKS) or low in _STRUCT_NAMES:
        return "structural"
    return "other"


def freeze(paths, out_path: str, *, keep_timings: bool = False,
           sha: Optional[str] = None) -> dict:
    """Record the given artifacts as the baseline (strict JSON).

    Timing metrics are STRIPPED unless ``keep_timings`` — a committed
    baseline must not gate absolute times across CI machines (the band
    itself is exercised by the ``--inject`` self-test against a
    same-run ``--keep-timings`` freeze).
    """
    artifacts = {}
    for path in paths:
        with open(path) as f:
            payload = json.load(f)
        name = os.path.basename(path)
        metrics = flatten_metrics(payload)
        if not keep_timings:
            metrics = {k: v for k, v in metrics.items()
                       if classify(k) != "timing"}
        artifacts[name] = {
            "fingerprint": config_fingerprint(name, payload),
            "metrics": metrics,
        }
    baseline = {
        "version": BASELINE_VERSION,
        "sha": sha if sha is not None else git_sha(),
        "timings_kept": bool(keep_timings),
        "artifacts": artifacts,
    }
    write_strict_json(out_path, baseline)
    return baseline


def load_baseline(path: str) -> dict:
    with open(path) as f:
        baseline = json.load(f)
    v = baseline.get("version")
    if v != BASELINE_VERSION:
        raise ValueError(
            f"baseline version {v!r} != {BASELINE_VERSION} "
            f"({path}: re-freeze with the current writer)"
        )
    return baseline


def compare_metrics(current: Dict[str, float], base: Dict[str, float], *,
                    timing_rtol: float, structural_rtol: float,
                    other_rtol: float,
                    require_all: bool = True) -> List[dict]:
    """Violations of ``current`` against ``base`` (empty list = clean).

    Each violation dict carries the metric path, its class, both
    values, and the relative excess — machine-checkable evidence, not
    just a log line.
    """
    rtol_by_class = {"timing": timing_rtol, "structural": structural_rtol,
                     "other": other_rtol}
    out: List[dict] = []
    for metric in sorted(base):
        b = base[metric]
        cls = classify(metric)
        rtol = rtol_by_class[cls]
        if metric not in current:
            if require_all:
                out.append({"metric": metric, "class": cls, "base": b,
                            "current": None, "rel": None,
                            "why": "metric disappeared"})
            continue
        c = current[metric]
        if b == 0.0:
            # no relative scale: structural zeros must stay exactly
            # (within float dust) zero; noisy classes get a small slack
            atol = 1e-9 if cls == "structural" else 1e-6
            if abs(c) > atol:
                out.append({"metric": metric, "class": cls, "base": b,
                            "current": c, "rel": None,
                            "why": f"baseline 0, current {c:g}"})
            continue
        rel = (c - b) / abs(b)
        bad = rel > rtol if cls == "timing" else abs(rel) > rtol
        if bad:
            sign = "+" if rel >= 0 else ""
            out.append({"metric": metric, "class": cls, "base": b,
                        "current": c, "rel": rel,
                        "why": f"{sign}{rel * 100:.1f}% vs "
                               f"{'+' if cls == 'timing' else '±'}"
                               f"{rtol * 100:.0f}% band"})
    return out


def run_gate(baseline: dict, paths, *, timing_rtol: float = 0.15,
             structural_rtol: float = 0.01, other_rtol: float = 0.25,
             inject: float = 1.0) -> dict:
    """Gate the given artifacts against a loaded baseline.

    Returns ``{"violations": [...], "compared": n_metrics,
    "skipped": [names], "notes": [...]}`` — ``main`` turns a non-empty
    violations list into exit 1.  ``inject`` scales every CURRENT
    timing metric (the CI self-test that proves the band trips).
    """
    violations: List[dict] = []
    notes: List[str] = []
    skipped: List[str] = []
    compared = 0
    base_artifacts = baseline.get("artifacts", {})
    current_by_name = {}
    for path in paths:
        with open(path) as f:
            payload = json.load(f)
        current_by_name[os.path.basename(path)] = payload

    for name, payload in sorted(current_by_name.items()):
        if name not in base_artifacts:
            skipped.append(name)
            notes.append(f"{name}: not in baseline (new coverage) — "
                         "skipped")
            continue
        entry = base_artifacts[name]
        metrics = flatten_metrics(payload)
        if inject != 1.0:
            metrics = {k: (v * inject if classify(k) == "timing" else v)
                       for k, v in metrics.items()}
        fp = config_fingerprint(name, payload)
        same_config = fp == entry.get("fingerprint")
        if not same_config:
            notes.append(f"{name}: config fingerprint changed — "
                         "comparing intersecting metrics only")
        vs = compare_metrics(
            metrics, entry.get("metrics", {}),
            timing_rtol=timing_rtol, structural_rtol=structural_rtol,
            other_rtol=other_rtol, require_all=same_config,
        )
        for v in vs:
            v["artifact"] = name
        violations.extend(vs)
        compared += len(entry.get("metrics", {}))
    for name in sorted(set(base_artifacts) - set(current_by_name)):
        notes.append(f"{name}: in baseline but not under test — skipped")
    return {"violations": violations, "compared": compared,
            "skipped": skipped, "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="compare BENCH_*.json artifacts against a recorded "
                    "baseline; non-zero exit on regression")
    ap.add_argument("artifacts", nargs="*", help="BENCH_*.json paths")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (see --freeze)")
    ap.add_argument("--freeze", default=None, metavar="OUT",
                    help="record the given artifacts as the baseline at "
                         "OUT and exit (no gating)")
    ap.add_argument("--keep-timings", "--keep_timings",
                    dest="keep_timings", action="store_true",
                    help="keep timing metrics in a frozen baseline "
                         "(same-machine self-tests only)")
    ap.add_argument("--timing_rtol", "--timing-rtol", dest="timing_rtol",
                    type=float, default=0.15,
                    help="one-sided slowdown band for timing metrics")
    ap.add_argument("--structural_rtol", "--structural-rtol",
                    dest="structural_rtol", type=float, default=0.01,
                    help="two-sided band for bits/bytes/count metrics")
    ap.add_argument("--rtol", type=float, default=0.25,
                    help="two-sided band for everything else")
    ap.add_argument("--inject", type=float, default=1.0,
                    help="scale current timing metrics by this factor "
                         "(CI self-test: the gate must catch it)")
    ap.add_argument("--sha", default=None,
                    help="override the recorded git sha when freezing")
    args = ap.parse_args(argv)

    if not args.artifacts:
        ap.error("no artifacts given")
    missing = [p for p in args.artifacts if not os.path.exists(p)]
    if missing:
        print(f"regress: missing artifacts: {missing}", file=sys.stderr)
        return 2

    if args.freeze:
        baseline = freeze(args.artifacts, args.freeze,
                          keep_timings=args.keep_timings, sha=args.sha)
        n = sum(len(a["metrics"]) for a in baseline["artifacts"].values())
        print(f"regress: froze {len(baseline['artifacts'])} artifacts "
              f"({n} metrics, timings_kept={baseline['timings_kept']}) "
              f"-> {args.freeze}")
        return 0

    if not args.baseline:
        ap.error("--baseline is required (or use --freeze)")
    try:
        baseline = load_baseline(args.baseline)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"regress: cannot load baseline: {e}", file=sys.stderr)
        return 2

    result = run_gate(
        baseline, args.artifacts, timing_rtol=args.timing_rtol,
        structural_rtol=args.structural_rtol, other_rtol=args.rtol,
        inject=args.inject,
    )
    for note in result["notes"]:
        print(f"regress: note: {note}")
    violations = result["violations"]
    if violations:
        print(f"regress: {len(violations)} violation(s) over "
              f"{result['compared']} baseline metrics "
              f"(baseline sha {str(baseline.get('sha'))[:12]}):")
        for v in violations:
            cur = "missing" if v["current"] is None else f"{v['current']:g}"
            print(f"  REGRESSION {v['artifact']} :: {v['metric']} "
                  f"[{v['class']}]  base {v['base']:g} -> {cur}  "
                  f"({v['why']})")
        return 1
    print(f"regress: OK — {result['compared']} baseline metrics within "
          f"bands (baseline sha {str(baseline.get('sha'))[:12]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
