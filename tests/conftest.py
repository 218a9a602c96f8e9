"""Suite-wide setup: fall back to the deterministic mini-hypothesis shim
when the real `hypothesis` is unavailable (hermetic containers).  CI
installs the real package from requirements.txt, so the shim is only a
no-network fallback — see tests/_mini_hypothesis.py.

Also bounds JAX compilation-cache growth across the suite: every jitted
executable a test compiles stays resident in the process-wide pjit
cache, and with the whole suite in one process the accumulated LLVM JIT
state eventually crashes XLA's CPU compiler mid-``backend_compile``.
Dropping the caches between test modules keeps the high-water mark at
one module's worth of executables; modules recompile what they use."""

import pathlib
import sys

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped where there is none")


@pytest.fixture(scope="module", autouse=True)
def _bounded_jit_cache():
    yield
    import jax

    jax.clear_caches()

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import _mini_hypothesis

    _mini_hypothesis.install()
