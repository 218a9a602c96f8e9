"""The plain reference against the program, on the CPU at smoke sizes:
each cell's traffic (workers, codec, aggregation, wires, optimizer)
through the harness's own run, three steps, every number compared
within ``smoke.LIMITS``."""

import pytest
import torch

from perfbench import harness
from perfbench.smoke import CELLS, LIMITS, smoke_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_program(name):
    cell = smoke_cell(name)
    out = harness.run_cell(cell, 2**31 + 7, 0.05, False, device="cpu")
    assert set(out["checks"]) == set(LIMITS)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"tokens_per_s", "peak_mem_gib", "setup_s"}
    assert list(out)[-1] == "checks"


def test_same_seed_same_inputs():
    from perfbench import inputs
    from perfbench.reference import model as RM

    cell = smoke_cell("qwen3-natural-s128")
    m = RM.model_of(cell.config)
    a = inputs.make_params(RM.param_specs(m), 2**33 + 5, "cpu")
    b = inputs.make_params(RM.param_specs(m), 2**33 + 5, "cpu")
    c = inputs.make_params(RM.param_specs(m), 2**33 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed/table"], c["embed/table"])
    d1 = inputs.SeedDraws(9, "cpu").uniform(3, 1, (4, 5), part="q")
    d0 = inputs.SeedDraws(9, "cpu")
    d0.uniform(0, 0, (7,))
    assert torch.equal(d1, d0.uniform(3, 1, (4, 5), part="q"))
