"""Wrapper for the block Top-K kernel (CUDA C++ for Hopper).

``block_topk_2d`` replaces the reference's Pallas TPU kernel of the same
name (``repro/kernels/topk/kernel.py``).  Its CUDA source is
``csrc/topk.cu``; its plain PyTorch version is
``ref.block_topk_bisect_ref``.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel on the current
stream or raises -- there is no fallback.  ``block_topk_2d.launches``
counts the kernel's launches (a plain int, incremented only where the
kernel is launched).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk.ref import (DEFAULT_BLOCK_ROWS, LANE,
                                          block_topk_bisect_ref)

__all__ = ["DEFAULT_BLOCK_ROWS", "LANE", "MAX_BLOCK_ROWS", "block_topk_2d"]

#: rows of one block the kernel holds: its keys in registers, the block
#: in a shared-memory stage (64 x 128 = 8192 elements)
MAX_BLOCK_ROWS = 64

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


def _lib(source=None) -> ctypes.CDLL:
    """The built library: of ``csrc/topk.cu``, or of ``source``, another
    version of it with the same C interface."""
    lib = _build.load("topk", source)
    if not getattr(lib, "_topk_typed", False):
        lib.block_topk_2d.argtypes = [_VP, _VP, ctypes.c_longlong, _INT, _INT,
                                      _INT, _VP]
        lib.block_topk_2d.restype = _INT
        lib.topk_error_string.argtypes = [_INT]
        lib.topk_error_string.restype = ctypes.c_char_p
        lib._topk_typed = True
    return lib


def block_topk_2d(x: torch.Tensor, *, k: int,
                  block_rows: int = DEFAULT_BLOCK_ROWS,
                  source=None) -> torch.Tensor:
    """x: (R, 128) f32 or bf16, R a multiple of ``block_rows`` (1 to
    MAX_BLOCK_ROWS).  Keeps the top-k magnitudes of each (block_rows, 128)
    block (more on exact ties at the threshold); returns x's dtype.
    ``source``: build the kernel from another version of ``topk.cu``."""
    r, lane = x.shape
    if lane != LANE or r < 1 or block_rows < 1 or r % block_rows:
        raise ValueError(f"expected (R, {LANE}) with R % block_rows == 0; "
                         f"got ({r}, {lane}) and block_rows {block_rows}")
    if block_rows > MAX_BLOCK_ROWS:
        raise ValueError(f"block_rows {block_rows} > {MAX_BLOCK_ROWS}: the "
                         f"kernel holds at most {MAX_BLOCK_ROWS} rows of a "
                         f"block in registers")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if x.device.type == "cpu":
        return block_topk_bisect_ref(x, k=k, block=block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x: data pointer not 16-byte aligned")
    out = torch.empty_like(x)
    lib = _lib(source)
    with torch.cuda.device(x.device):
        err = lib.block_topk_2d(
            x.data_ptr(), out.data_ptr(), r, block_rows, k,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.topk_error_string(err).decode()
        raise RuntimeError(f"block_topk_2d: CUDA launch failed ({err}: "
                           f"{msg})")
    block_topk_2d.launches += 1
    return out


block_topk_2d.launches = 0
