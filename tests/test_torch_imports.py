"""The port stands alone: no file of ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX or the reference package, and its entry
points never fall back to the CPU silently."""

import ast
import pathlib

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.launch import train as port_train

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "train.py", "kernel.py", "ops.py",
            "ref.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    with pytest.raises(RuntimeError):
        port_train.init_state(0, cfg, TrainConfig(), 1)
    with pytest.raises(RuntimeError):
        port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
