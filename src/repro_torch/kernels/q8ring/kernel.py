"""Wrappers for the blockwise int8 codec kernels (CUDA C++ for Hopper).

``q8_quantize_2d``, ``q8_quantize_chunk_3d`` and ``q8_dequant_add_2d``
replace the reference's Pallas TPU kernels of the same names
(``repro/kernels/q8ring/kernel.py``).  Their CUDA source is
``csrc/q8ring.cu``; their plain PyTorch versions are in ``ref.py``.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs
the plain version (and so does a meta tensor, in the step's cost pass),
a CUDA tensor launches the kernel on the current stream or raises --
there is no fallback.  Each wrapper counts its
kernel launches in ``<wrapper>.launches`` (a plain int, incremented only
where the kernel is launched), so a run can show that its main path went
through the kernel; ``q8_dequant_add_2d.acc_launches`` counts those of
its launches that read an accumulator (the ring's receive side).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.q8ring.ref import (
    DEFAULT_BLOCK_ROWS,
    LANE,
    LEVELS,
    SCALE_FLOOR,
    q8_dequant_add_ref,
    q8_quantize_chunk_ref,
    q8_quantize_ref,
)

__all__ = ["DEFAULT_BLOCK_ROWS", "LANE", "LEVELS", "SCALE_FLOOR",
           "q8_dequant_add_2d", "q8_quantize_2d", "q8_quantize_chunk_3d"]

_VP = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("q8ring")
    if not getattr(lib, "_q8ring_typed", False):
        lib.q8_quantize_2d.argtypes = [_VP, _VP, _VP, _VP, ctypes.c_longlong,
                                       ctypes.c_int, _VP]
        lib.q8_quantize_2d.restype = ctypes.c_int
        lib.q8_quantize_chunk_3d.argtypes = [_VP, _VP, _VP, _VP, _VP,
                                             ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_int, _VP]
        lib.q8_quantize_chunk_3d.restype = ctypes.c_int
        lib.q8_dequant_add_2d.argtypes = [_VP, _VP, _VP, _VP,
                                          ctypes.c_longlong, ctypes.c_int,
                                          _VP]
        lib.q8_dequant_add_2d.restype = ctypes.c_int
        lib.q8ring_error_string.argtypes = [ctypes.c_int]
        lib.q8ring_error_string.restype = ctypes.c_char_p
        lib._q8ring_typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device,
           align: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def _tiles(r: int, lane: int, block_rows: int) -> int:
    if lane != LANE or r < 1 or block_rows < 1 or r % block_rows:
        raise ValueError(
            f"expected (R, {LANE}) with R >= 1 and R % block_rows == 0; got "
            f"({r}, {lane}) and block_rows {block_rows}"
        )
    return r // block_rows


def _device_kind(t: torch.Tensor) -> str:
    """``cuda`` launches the kernel; ``cpu`` runs the plain version, and
    so does ``meta`` (the step's cost pass, ``launch.hlo_cost``: the
    plain version's arithmetic on shapes)."""
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {t.device}")
    return "cpu" if t.device.type == "meta" else t.device.type


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.q8ring_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def q8_quantize_2d(x: torch.Tensor, u: torch.Tensor, *,
                   block_rows: int = DEFAULT_BLOCK_ROWS):
    """x, u: (R, 128) f32 (u uniform in [0, 1)).  Returns (q: (R, 128)
    int8, scales: (R // block_rows, 1) f32) -- one scale per
    (block_rows, 128) tile."""
    r, lane = x.shape
    nb = _tiles(r, lane, block_rows)
    _check("x", x, torch.float32, (r, LANE), x.device, 16)
    _check("u", u, torch.float32, (r, LANE), x.device, 16)
    if _device_kind(x) == "cpu":
        return q8_quantize_ref(x, u, block=block_rows)
    q = torch.empty((r, LANE), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.q8_quantize_2d(
            x.data_ptr(), u.data_ptr(), q.data_ptr(), scales.data_ptr(), r,
            block_rows, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "q8_quantize_2d")
    q8_quantize_2d.launches += 1
    return q, scales


def q8_quantize_chunk_3d(chunks: torch.Tensor, u: torch.Tensor,
                         chunk_id: torch.Tensor, *,
                         block_rows: int = DEFAULT_BLOCK_ROWS):
    """The ring hop's send side: ``q8_quantize_2d(chunks[chunk_id], u)``
    read in place from the (n, R, 128) f32 ring buffer, no chunk copy.
    ``chunk_id`` is a one-element int32 tensor on ``chunks``' device,
    which the kernel reads from device memory.  An id outside [0, n)
    raises ``IndexError`` on the CPU; on the card it does NOT raise (the
    id is never brought to the host): the kernel reads nothing and
    returns q = 0 and NaN scales.  Returns (q: (R, 128) int8, scales:
    (R // block_rows, 1) f32)."""
    n, r, lane = chunks.shape
    nb = _tiles(r, lane, block_rows)
    _check("chunks", chunks, torch.float32, (n, r, LANE), chunks.device, 16)
    _check("u", u, torch.float32, (r, LANE), chunks.device, 16)
    _check("chunk_id", chunk_id.reshape(-1), torch.int32, (1,),
           chunks.device, 4)
    if chunks.device.type == "meta":   # no id to read: any chunk's cost
        return q8_quantize_ref(chunks[0], u, block=block_rows)
    if _device_kind(chunks) == "cpu":
        return q8_quantize_chunk_ref(chunks, u, chunk_id.item(),
                                     block=block_rows)
    q = torch.empty((r, LANE), dtype=torch.int8, device=chunks.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=chunks.device)
    lib = _lib()
    with torch.cuda.device(chunks.device):
        err = lib.q8_quantize_chunk_3d(
            chunks.data_ptr(), u.data_ptr(), chunk_id.data_ptr(),
            q.data_ptr(), scales.data_ptr(), n, r, block_rows,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "q8_quantize_chunk_3d")
    q8_quantize_chunk_3d.launches += 1
    return q, scales


def q8_dequant_add_2d(q: torch.Tensor, scales: torch.Tensor,
                      acc: Optional[torch.Tensor], *,
                      block_rows: int = DEFAULT_BLOCK_ROWS):
    """``acc + q * scale`` in one pass (one rounding: fma).  q: (R, 128)
    int8, scales: (R // block_rows, 1) f32, acc: (R, 128) f32 or ``None``
    for a zero accumulator, in which case it is not read."""
    r, lane = q.shape
    nb = _tiles(r, lane, block_rows)
    _check("q", q, torch.int8, (r, LANE), q.device, 4)
    _check("scales", scales, torch.float32, (nb, 1), q.device, 4)
    if acc is not None:
        _check("acc", acc, torch.float32, (r, LANE), q.device, 16)
    if _device_kind(q) == "cpu":
        return q8_dequant_add_ref(q, scales, acc, block=block_rows)
    out = torch.empty((r, LANE), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.q8_dequant_add_2d(
            q.data_ptr(), scales.data_ptr(),
            None if acc is None else acc.data_ptr(), out.data_ptr(), r,
            block_rows, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "q8_dequant_add_2d")
    q8_dequant_add_2d.launches += 1
    q8_dequant_add_2d.acc_launches += acc is not None
    return out


q8_quantize_2d.launches = 0
q8_quantize_chunk_3d.launches = 0
q8_dequant_add_2d.launches = 0
q8_dequant_add_2d.acc_launches = 0
