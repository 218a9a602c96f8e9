"""Smoke-sized cells for the tests on the CPU: each of the benchmark's
cells with its configuration cut to its family's small widths
(``SMOKE`` of ``reference/<model_type>.py``), its traffic to short
sequences and its limits to ``LIMITS``, everything else (workers, codec,
aggregation, wires, optimizer) as committed."""

from pathlib import Path
from typing import Optional

from perfbench import harness

#: at smoke sizes on the CPU the program and the reference agree to f32
#: rounding: every number is compared, far below what a fault reads (the
#: cells' own limits are set from chip readings at their own sizes)
LIMITS = {"loss": 1e-6, "grad1": 1e-4, "change": 1e-4, "bits": 0.0}

#: every cell of the benchmark
CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT.parent / "BENCHMARK.json")["workloads"]]


def smoke_cell(name: str, seq: int = 16, bench: Optional[dict] = None,
               root: Path = harness.ROOT) -> harness.Cell:
    cell = harness.load_cell(name, bench, root)
    cell.config.update(cell.family.SMOKE)
    cell.traffic.update(seq=seq)
    cell.limits = dict(LIMITS)
    return cell
