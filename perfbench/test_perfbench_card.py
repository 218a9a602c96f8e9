"""On the card: the control of each cell (the plain reference in TF32
put in the program's place, ``control.py``) comes out not correct
against the cell's limits, at the cell's own size."""

import json
from pathlib import Path

import pytest

from perfbench import harness

BENCH = json.loads((Path(__file__).resolve().parent.parent /
                    "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(card, name):
    from perfbench.control import control_numbers

    cell = harness.load_cell(name)
    numbers = control_numbers(cell, 2**31 + 99, card)
    assert any(v > cell.limits[k] for k, v in numbers.items()
               if cell.limits[k] is not None), numbers
