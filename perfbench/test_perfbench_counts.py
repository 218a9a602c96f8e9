"""The benchmark's own counts, held against the program's and the
kernel table's: the model FLOPs of a step against the program's cost
pass (the step run on the meta device) for qwen3-0.6b at full size, the
q8 bounds at the kernel table's shapes, and the q8 launches of a step of
each q8 cell against ``chip_smoke.py``'s expected launches.  Each cell's
leaf layout and step FLOPs at full size are pinned to the values they
had before the families were split into files of their own."""

import math
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.counts import flops, q8

REPO = Path(__file__).resolve().parent.parent
Q8_CELLS = ["dsv2lite-wires-s128", "qwen3-q8ring-s1024",
            "dsv2lite-q8ring-s128"]


def test_flops_against_the_cost_pass():
    from repro_torch.configs.base import CompressionConfig, TrainConfig
    from repro_torch.launch.train import step_cost

    cell = harness.load_cell("qwen3-natural-s128")
    m = cell.family.model_of(cell.config)
    cfg = harness.program_config(cell)
    tr = cell.traffic
    tcfg = TrainConfig(compression=CompressionConfig(enabled=False))
    batch = {"tokens": torch.empty((tr["batch"], tr["seq"]),
                                   dtype=torch.int64, device="meta")}
    cost = step_cost(cfg, tcfg, tr["workers"], None, batch)["flops"]
    mine = cell.family.step_flops(m, tr["batch"], tr["seq"])
    six_nd = 6 * 596_049_920 * tr["batch"] * tr["seq"]
    # the cost pass adds the full (not causal) attention and the
    # elementwise work (1.028 of 6 N D here)
    assert 1.0 < cost / mine < 1.03, cost / mine
    assert 1.0 < mine / six_nd < 1.02, mine / six_nd


def test_flops_of_the_moe_cell_count_active_experts():
    cell = harness.load_cell("dsv2lite-q8ring-s128")
    fam = cell.family
    m = fam.model_of(cell.config)
    head = 2048 * 102400
    per_layer_moe = 6 / 64 * 3 * 64 * 2048 * 1408
    active = flops.matrix_params(fam.param_specs(m), m.tied, fam.on_path(m))
    assert active > head + per_layer_moe
    assert active < 4e8


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
    cfg = harness.program_config(cell)
    w = cell.traffic["workers"]
    mesh = HostMesh(data=w, device="cpu")
    n = mesh.data
    rings, stage = chip_smoke.ring_counts(cfg, mesh, w)
    leaves = len(param_specs(cfg))
    msgs = leaves * w
    expect = {"q8_quantize_2d": msgs + stage,
              "q8_quantize_chunk_3d": rings * n * n,
              "q8_dequant_add_2d": msgs + rings * n * n + stage}
    specs = cell.family.param_specs(cell.family.model_of(cell.config))
    mine = q8.step_launches([math.prod(s) for _, s, _ in specs], w, w, True)
    assert q8.launch_counts(mine) == expect
    layouts = {q8.message_layout(math.prod(s)) for _, s, _ in specs}
    assert layouts == set(chip_smoke.main_path_layouts(cfg))



ONE = ("full", 1.0)
QWEN3_OUT = 0.002672612419124244            # 0.02 / sqrt(2 x 28 layers)
#: (path, shape, init) of every leaf at full size, and the step's FLOPs,
#: as the reference had them before its families were files of their own
LAYOUT = {
    "qwen3-0.6b": [
        ("blocks/attn/k_norm/scale", (28, 128), ONE),
        ("blocks/attn/q_norm/scale", (28, 128), ONE),
        ("blocks/attn/wk", (28, 1024, 1024), 0.02),
        ("blocks/attn/wo", (28, 2048, 1024), QWEN3_OUT),
        ("blocks/attn/wq", (28, 1024, 2048), 0.02),
        ("blocks/attn/wv", (28, 1024, 1024), 0.02),
        ("blocks/attn_norm/scale", (28, 1024), ONE),
        ("blocks/mlp/w_down", (28, 3072, 1024), QWEN3_OUT),
        ("blocks/mlp/w_gate", (28, 1024, 3072), 0.02),
        ("blocks/mlp/w_up", (28, 1024, 3072), 0.02),
        ("blocks/mlp_norm/scale", (28, 1024), ONE),
        ("embed/table", (151936, 1024), 0.02),
        ("final_norm/scale", (1024,), ONE)],
    "deepseek-v2-lite-16b-2l": [
        ("dense_blocks/attn/kv_norm/scale", (1, 512), ONE),
        ("dense_blocks/attn/w_dkv", (1, 2048, 512), 0.02),
        ("dense_blocks/attn/w_kr", (1, 2048, 64), 0.02),
        ("dense_blocks/attn/w_ukv", (1, 512, 16, 256), 0.02),
        ("dense_blocks/attn/wo", (1, 16, 128, 2048), 0.01),
        ("dense_blocks/attn/wq", (1, 2048, 16, 192), 0.02),
        ("dense_blocks/attn_norm/scale", (1, 2048), ONE),
        ("dense_blocks/mlp/w_down", (1, 10944, 2048), 0.01),
        ("dense_blocks/mlp/w_gate", (1, 2048, 10944), 0.02),
        ("dense_blocks/mlp/w_up", (1, 2048, 10944), 0.02),
        ("dense_blocks/mlp_norm/scale", (1, 2048), ONE),
        ("embed/table", (102400, 2048), 0.02),
        ("final_norm/scale", (2048,), ONE),
        ("head/w", (2048, 102400), 0.02),
        ("moe_blocks/attn/kv_norm/scale", (1, 512), ONE),
        ("moe_blocks/attn/w_dkv", (1, 2048, 512), 0.02),
        ("moe_blocks/attn/w_kr", (1, 2048, 64), 0.02),
        ("moe_blocks/attn/w_ukv", (1, 512, 16, 256), 0.02),
        ("moe_blocks/attn/wo", (1, 16, 128, 2048), 0.01),
        ("moe_blocks/attn/wq", (1, 2048, 16, 192), 0.02),
        ("moe_blocks/attn_norm/scale", (1, 2048), ONE),
        ("moe_blocks/mlp_norm/scale", (1, 2048), ONE),
        ("moe_blocks/moe/router", (1, 2048, 64), 0.02),
        ("moe_blocks/moe/shared/w_down", (1, 2816, 2048), 0.01),
        ("moe_blocks/moe/shared/w_gate", (1, 2048, 2816), 0.02),
        ("moe_blocks/moe/shared/w_up", (1, 2048, 2816), 0.02),
        ("moe_blocks/moe/w_down", (1, 64, 1408, 2048), 0.01),
        ("moe_blocks/moe/w_gate", (1, 64, 2048, 1408), 0.02),
        ("moe_blocks/moe/w_up", (1, 64, 2048, 1408), 0.02)],
}
FLOPS = {"qwen3-natural-s128": 3707177533440.0,
         "dsv2lite-wires-s128": 2300791750656.0,
         "qwen3-q8ring-s1024": 16091430518784.0,
         "dsv2lite-q8ring-s128": 2300791750656.0}


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_layout_and_flops_are_pinned(name):
    cell = harness.load_cell(name)
    fam = cell.family
    m = fam.model_of(cell.config)
    config = {w["name"]: w["config"] for w in harness.load_json(
        REPO / "BENCHMARK.json")["workloads"]}[name]
    assert [(p, tuple(s), i) for p, s, i in fam.param_specs(m)] == \
        LAYOUT[config]
    tr = cell.traffic
    assert fam.step_flops(m, tr["batch"], tr["seq"]) == FLOPS[name]
