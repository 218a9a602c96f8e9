"""The benchmark is driven by data: BENCHMARK.json's cells resolve to
files found by name, its names and units fit the contract's characters,
every metric's ``moves`` is reported by each of its cells, and a
configuration, traffic mix, metric and model family dropped in as new
files are found with no code edited."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness, smoke

ROOT = Path(__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1].startswith("perfbench/")
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert "setup_s" in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = harness.load_cell(w["name"], BENCH)
    assert cell.traffic["workers"] >= 1 and cell.config["program_arch"]
    assert set(cell.limits) == {"loss", "grad1", "change", "bits"}
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_every_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        reporting = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(reporting)
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        layers.setdefault(m["layer"], m["name"])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_new_files_are_found_without_code(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "configs" / "qwen3-0.6b.json").read_text())
    cfg["num_hidden_layers"] = 4
    (root / "configs" / "qwen3-0.6b-4l.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "traffic" / "natural-w4-b8-s128.json").read_text())
    mix["seq"] = 256
    (root / "traffic" / "natural-w4-b8-s256.json").write_text(json.dumps(mix))
    (root / "limits" / "new-cell.json").write_text(json.dumps(
        {"loss": 1e-5, "grad1": 1e-3, "change": 1e-3, "bits": 0.0}))
    (root / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(run.window_steps)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="qwen3-0.6b-4l",
                                 file="perfbench/configs/qwen3-0.6b-4l.json"))
    bench["workloads"].append({"name": "new-cell", "config": "qwen3-0.6b-4l",
                               "traffic": "natural-w4-b8-s256", "chips": 1,
                               "why": "a cell added as files"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "tokens_per_s",
                               "workloads": ["new-cell"]})
    cell = harness.load_cell("new-cell", bench, root)
    assert cell.config["num_hidden_layers"] == 4
    assert cell.traffic["seq"] == 256
    assert "steps_seen" in [m["name"] for m in cell.per_layer]
    run = harness.Run(None, 1.0, 7, 1.0, [])
    assert harness.reader("steps_seen", root)(run) == 7.0


#: a family of a new ``model_type``, as a later configuration brings one
DROPIN = """from perfbench.reference.qwen3 import (SMOKE, WIRES, Model, loss,
    model_of, param_specs, program_fields, step_flops)
"""


def _family_cell(tmp_path, model_type, traffic="natural-w4-b8-s128"):
    """A copy of ``perfbench/`` with a configuration of ``model_type``
    (qwen3-0.6b's keys) and a cell ``family-cell`` of it under
    ``traffic``, as new files; returns the copy and its benchmark."""
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "configs" / "qwen3-0.6b.json").read_text())
    cfg["model_type"] = model_type
    (root / "configs" / "qwen3-family.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    (root / "traffic" / "family-mix.json").write_text(json.dumps(mix))
    (root / "limits" / "family-cell.json").write_text(json.dumps(
        {"loss": 1e-5, "grad1": 1e-3, "change": 1e-3, "bits": 0.0}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="qwen3-family",
                                 file="perfbench/configs/qwen3-family.json"))
    bench["workloads"].append({"name": "family-cell", "config": "qwen3-family",
                               "traffic": "family-mix", "chips": 1,
                               "why": "a family added as files"})
    return root, bench


def test_a_new_family_drops_in_as_files(tmp_path):
    root, bench = _family_cell(tmp_path, "qwen3_dropin")
    (root / "reference" / "qwen3_dropin.py").write_text(DROPIN)
    cell = smoke.smoke_cell("family-cell", bench=bench, root=root)
    assert cell.family.__file__ == str(root / "reference" / "qwen3_dropin.py")
    out = harness.run_cell(cell, 2**31 + 7, 0.05, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(smoke.LIMITS)


@pytest.mark.parametrize("case", ["unknown model_type", "wires untaken"])
def test_a_family_is_refused_with_its_path(tmp_path, case):
    if case == "unknown model_type":
        root, bench = _family_cell(tmp_path, "qwen3_unknown")
        said = str(root / "reference" / "qwen3_unknown.py")
    else:
        root, bench = _family_cell(tmp_path, "qwen3",
                                   traffic="q8ring-wires-w2-b8-s128")
        said = str(root / "reference" / "qwen3.py")
    with pytest.raises(SystemExit) as refused:
        harness.load_cell("family-cell", bench, root)
    assert said in str(refused.value)
