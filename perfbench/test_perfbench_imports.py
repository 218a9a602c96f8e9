"""What a run imports: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (``repro_torch`` is
the program and is not ``repro``); and the plain reference imports
nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

GRAPH = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib.util
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
from perfbench import harness, control
from perfbench.reference import train
from repro_torch.launch.train import build_train_step, init_state
from repro_torch.launch.mesh import HostMesh
import repro_torch.kernels.q8ring.kernel, repro_torch.obs.trace
import torch.profiler
for p in sorted((harness.ROOT / "metrics").glob("*.py")):
    harness.reader(p.stem)
for p in sorted((harness.ROOT / "configs").glob("*.json")):
    harness.family(harness.load_json(p))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_run_imports_no_jax():
    code = GRAPH.format(root=str(ROOT.parent), src=str(ROOT.parent / "src"),
                        run=str(ROOT / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "reference").glob("*.py")) + [ROOT / "inputs.py"]
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"repro_torch"}, (path.name, name)
