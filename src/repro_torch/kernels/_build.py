"""Build and load the port's CUDA kernels.

Each kernel source (``*.cu`` under a ``csrc/`` directory of the package)
is compiled on first use by ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes`` -- no PyTorch headers, so a build
takes seconds.  Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17
-O3``, and deliberately no ``--use_fast_math`` or ``-ftz=true`` (the q8
kernels rely on IEEE division and on denormals; the WKV6 kernels on IEEE
roundings; the natural and top-k kernels flush subnormals themselves,
where the reference's arithmetic does).

Libraries land in ``kernels/build/`` next to this file (ignored by git),
named by a hash of their source, so an edited source is rebuilt and a
stale library is never loaded.  Nothing here runs at import time: the
CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"

#: every CUDA source of the port, by library name
SOURCES: Dict[str, Path] = {
    "q8ring": KERNELS_DIR / "q8ring" / "csrc" / "q8ring.cu",
    "wkv6": KERNELS_DIR / "wkv6" / "csrc" / "wkv6.cu",
    "natural": KERNELS_DIR / "natural" / "csrc" / "natural.cu",
    "topk": KERNELS_DIR / "topk" / "csrc" / "topk.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report (registers, shared memory, spills) per library
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _source(name: str, source=None) -> Path:
    return SOURCES[name] if source is None else Path(source)


def _lib_path(name: str, source=None) -> Path:
    digest = hashlib.sha256(_source(name, source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, source=None):
    """Start ``nvcc`` for one library; returns ``(process, tmp, out)``, or
    ``None`` when the library is already built."""
    out = _lib_path(name, source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name, source))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started, source=None) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_source(name, source)}:\n{log}")
    if source is None:
        BUILD_LOG[name] = log
    os.replace(tmp, out)


def build(names: Iterable[str] = tuple(SOURCES)) -> None:
    """Compile the named libraries, one ``nvcc`` per source, all started
    together.  Already built libraries are skipped."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


def load(name: str, source=None) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed; built
    from ``source`` (another version of its ``.cu`` file, with the same C
    interface) instead of the package's when that is given."""
    key = name if source is None else f"{name}:{Path(source).resolve()}"
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            started = _start(name, source)
            if started is not None:
                _finish(name, started, source)
            lib = _LOADED[key] = ctypes.CDLL(str(_lib_path(name, source)))
        return lib
