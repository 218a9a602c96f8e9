"""The benchmark's own counts, held against the program's and the
kernel table's: the model FLOPs of a step against the program's cost
pass (the step run on the meta device) for qwen3-0.6b at full size, the
q8 bounds at the kernel table's shapes, and the q8 launches of a step of
each q8 cell against ``chip_smoke.py``'s expected launches."""

import math
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.counts import flops, q8
from perfbench.reference import model as RM

REPO = Path(__file__).resolve().parent.parent
Q8_CELLS = ["dsv2lite-wires-s128", "qwen3-q8ring-s1024",
            "dsv2lite-q8ring-s128"]


def test_flops_against_the_cost_pass():
    from repro_torch.configs.base import CompressionConfig, TrainConfig
    from repro_torch.launch.train import step_cost

    cell = harness.load_cell("qwen3-natural-s128")
    m = RM.model_of(cell.config)
    cfg = harness.program_config(cell.config)
    tr = cell.traffic
    tcfg = TrainConfig(compression=CompressionConfig(enabled=False))
    batch = {"tokens": torch.empty((tr["batch"], tr["seq"]),
                                   dtype=torch.int64, device="meta")}
    cost = step_cost(cfg, tcfg, tr["workers"], None, batch)["flops"]
    mine = flops.step_flops(m, tr["batch"], tr["seq"])
    six_nd = 6 * 596_049_920 * tr["batch"] * tr["seq"]
    # the cost pass adds the full (not causal) attention and the
    # elementwise work (1.028 of 6 N D here)
    assert 1.0 < cost / mine < 1.03, cost / mine
    assert 1.0 < mine / six_nd < 1.02, mine / six_nd


def test_flops_of_the_moe_cell_count_active_experts():
    cell = harness.load_cell("dsv2lite-q8ring-s128")
    m = RM.model_of(cell.config)
    head = 2048 * 102400
    per_layer_moe = 6 / 64 * 3 * 64 * 2048 * 1408
    assert flops.matrix_params(m) > head + per_layer_moe
    assert flops.matrix_params(m) < 4e8


@pytest.mark.parametrize("rows, block, acc, kind, want", [
    (1_215_488, 64, None, "quantize", 0.4180),
    (1_215_488, 64, False, "dequant", 0.2322),
    (1_215_488, 64, True, "dequant", 0.4180),
    (303_872, 64, None, "chunk", 0.1045),
])
def test_q8_bounds_at_the_kernel_table(rows, block, acc, kind, want):
    got = {"quantize": lambda: q8.quantize_bound(rows, block),
           "chunk": lambda: q8.chunk_quantize_bound(rows, block),
           "dequant": lambda: q8.dequant_bound(rows, block, acc)}[kind]()
    assert round(got, 4) == want


@pytest.mark.parametrize("name", Q8_CELLS)
def test_q8_launches_as_chip_smoke_expects(name):
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models.model import param_specs

    cell = harness.load_cell(name)
    cfg = harness.program_config(cell.config)
    w = cell.traffic["workers"]
    mesh = HostMesh(data=w, device="cpu")
    n = mesh.data
    rings, stage = chip_smoke.ring_counts(cfg, mesh, w)
    leaves = len(param_specs(cfg))
    msgs = leaves * w
    expect = {"q8_quantize_2d": msgs + stage,
              "q8_quantize_chunk_3d": rings * n * n,
              "q8_dequant_add_2d": msgs + rings * n * n + stage}
    m = RM.model_of(cell.config)
    mine = q8.step_launches([math.prod(s) for _, s, _ in RM.param_specs(m)],
                            w, w, True)
    assert q8.launch_counts(mine) == expect
    layouts = {q8.message_layout(math.prod(s)) for _, s, _ in
               RM.param_specs(m)}
    assert layouts == set(chip_smoke.main_path_layouts(cfg))
