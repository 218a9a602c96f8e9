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

    cell = smoke_cell("qwen3-natural-s128")
    specs = cell.family.param_specs(cell.family.model_of(cell.config))
    a = inputs.make_params(specs, 2**33 + 5, "cpu")
    b = inputs.make_params(specs, 2**33 + 5, "cpu")
    c = inputs.make_params(specs, 2**33 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed/table"], c["embed/table"])
    d1 = inputs.SeedDraws(9, "cpu").uniform(3, 1, (4, 5), part="q")
    d0 = inputs.SeedDraws(9, "cpu")
    d0.uniform(0, 0, (7,))
    assert torch.equal(d1, d0.uniform(3, 1, (4, 5), part="q"))


@pytest.mark.parametrize("init", [("full", -4.6), ("log_linspace", 1.0, 16.0)])
def test_fixed_inits_are_exact(init):
    from perfbench import inputs

    specs = [("w", (3, 5), 0.02), ("a_log", (2, 24), init), ("v", (7,), 0.5)]
    got = inputs.make_params(specs, 11, "cpu")
    if init[0] == "full":
        want = torch.full((24,), -4.6)
    else:
        want = torch.log(torch.linspace(1.0, 16.0, 24, dtype=torch.float32))
    assert torch.equal(got["a_log"], want.expand(2, 24))
    # the normal leaves are cut from the one draw as without the fixed leaf
    plain = inputs.make_params([specs[0], specs[2]], 11, "cpu")
    assert torch.equal(got["w"], plain["w"]) and torch.equal(got["v"],
                                                             plain["v"])


@pytest.mark.parametrize("init", [("ones",), ("full", 1.0, 2.0),
                                  ("log_linspace", 1.0)])
def test_unknown_init_raises(init):
    from perfbench import inputs

    with pytest.raises(ValueError, match="a_log"):
        inputs.make_params([("a_log", (4,), init)], 11, "cpu")
