"""The bench trajectory ledger: every BENCH_*.json, keyed and appended --
the port of the reference's ``repro/obs/history.py``.

Every benchmark run ends as a point-in-time ``BENCH_*.json`` snapshot —
and until now that is ALL it was: no artifact knew what the previous run
measured, so a perf or quality regression could only be caught by a
human diffing CI artifacts.  This module turns the snapshots into a
trajectory:

* ``ingest`` flattens each artifact's numeric payload into dotted metric
  paths (``fused.step_s``, ``modes.q8.bytes_per_step``) and appends ONE
  obs ``summary`` record per artifact to ``experiments/obs/history.jsonl``
  — schema-valid JSONL (``repro_torch.obs.metrics``), so the CI ``--check``
  gate and every export consumer read it unchanged.
* Records are keyed by **git sha x config fingerprint**: the sha names
  the code revision, the fingerprint hashes the artifact's metric-name
  set plus its non-numeric config scalars — two runs with the same
  fingerprint measured the same thing and are comparable point-to-point
  (``repro_torch.obs.regress`` refuses to compare across fingerprints).

CLI::

    python -m repro_torch.obs.history BENCH_autotune.json ... [--out PATH]
    python -m repro_torch.obs.history --list [--path PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

from repro_torch.obs.metrics import summary_record
from repro_torch.obs.sink import JsonlSink, read_jsonl

#: default on-disk home of the ledger (CI uploads it as an artifact)
DEFAULT_HISTORY_PATH = os.path.join("experiments", "obs", "history.jsonl")

#: history files grow forever by design — rotate far later than the
#: per-run metrics JSONL so the trajectory stays in one file
HISTORY_ROTATE_BYTES = 256 << 20


def git_sha(cwd: Optional[str] = None) -> str:
    """The commit the metrics were measured at: ``git rev-parse HEAD``,
    falling back to the CI-provided ``GITHUB_SHA``, then ``"unknown"``
    (a ledger outside a checkout is still a ledger)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return os.environ.get("GITHUB_SHA", "unknown")


def flatten_metrics(payload, prefix: str = "") -> Dict[str, float]:
    """Every NUMERIC leaf of a bench payload as a dotted path.

    Lists index as ``name[i]``; bools are config, not metrics, and are
    skipped (they belong to the fingerprint's config half).
    """
    out: Dict[str, float] = {}
    if isinstance(payload, dict):
        for k in sorted(payload):
            p = f"{prefix}.{k}" if prefix else str(k)
            out.update(flatten_metrics(payload[k], p))
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            out.update(flatten_metrics(v, f"{prefix}[{i}]"))
    elif isinstance(payload, bool):
        pass
    elif isinstance(payload, (int, float)):
        out[prefix] = float(payload)
    return out


def _config_scalars(payload, prefix: str = "") -> Dict[str, str]:
    """The non-numeric scalars (strings, bools) — the artifact's CONFIG
    half, hashed into the fingerprint so a changed arch/mode/flag makes
    runs incomparable instead of silently compared."""
    out: Dict[str, str] = {}
    if isinstance(payload, dict):
        for k in sorted(payload):
            p = f"{prefix}.{k}" if prefix else str(k)
            out.update(_config_scalars(payload[k], p))
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            out.update(_config_scalars(v, f"{prefix}[{i}]"))
    elif isinstance(payload, (bool, str)):
        out[prefix] = str(payload)
    return out


def config_fingerprint(name: str, payload) -> str:
    """sha256 over the artifact name, its metric-name SET, and its
    config scalars — the 'same experiment' key of the ledger."""
    blob = json.dumps(
        {
            "name": name,
            "metrics": sorted(flatten_metrics(payload)),
            "config": sorted(_config_scalars(payload).items()),
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()


def artifact_record(path: str, *, sha: Optional[str] = None) -> dict:
    """One BENCH_*.json -> one obs ``summary`` record (validated)."""
    with open(path) as f:
        payload = json.load(f)
    name = os.path.basename(path)
    return summary_record(
        name,
        sha=sha if sha is not None else git_sha(os.path.dirname(
            os.path.abspath(path)) or None),
        fingerprint=config_fingerprint(name, payload),
        metrics=flatten_metrics(payload),
    )


def ingest(paths, out_path: str = DEFAULT_HISTORY_PATH, *,
           sha: Optional[str] = None) -> List[dict]:
    """Append one record per artifact to the ledger; returns them."""
    records = [artifact_record(p, sha=sha) for p in paths]
    sink = JsonlSink(out_path, rotate_bytes=HISTORY_ROTATE_BYTES)
    try:
        for rec in records:
            sink.emit(rec)
    finally:
        sink.close()
    return records


def load_history(path: str = DEFAULT_HISTORY_PATH) -> List[dict]:
    return read_jsonl(path) if os.path.exists(path) else []


def latest_by_artifact(records) -> Dict[str, dict]:
    """Last ledger entry per artifact name (file order IS time order)."""
    out: Dict[str, dict] = {}
    for rec in records:
        if rec.get("kind") == "summary" and "fingerprint" in rec.get(
                "data", {}):
            out[rec["name"]] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ingest BENCH_*.json artifacts into the obs history "
                    "ledger (or --list what it holds)")
    ap.add_argument("artifacts", nargs="*", help="BENCH_*.json paths")
    ap.add_argument("--out", default=DEFAULT_HISTORY_PATH,
                    help="ledger path (append-only strict JSONL)")
    ap.add_argument("--sha", default=None,
                    help="override the recorded git sha")
    ap.add_argument("--list", action="store_true",
                    help="print the ledger's latest entry per artifact")
    args = ap.parse_args(argv)

    if args.list:
        latest = latest_by_artifact(load_history(args.out))
        if not latest:
            print(f"history: {args.out} is empty")
            return 0
        for name, rec in sorted(latest.items()):
            d = rec["data"]
            print(f"{name}  sha={str(d.get('sha'))[:12]}  "
                  f"fp={str(d.get('fingerprint'))[:12]}  "
                  f"{len(d.get('metrics') or {})} metrics")
        return 0
    if not args.artifacts:
        ap.error("no artifacts given (and --list not set)")
    recs = ingest(args.artifacts, args.out, sha=args.sha)
    print(f"history: ingested {len(recs)} artifacts -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
