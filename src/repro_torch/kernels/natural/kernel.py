"""Wrappers for the natural-compression kernels (CUDA C++ for Hopper).

``shifted_natural_2d`` replaces the reference's Pallas TPU kernel of the
same name (``repro/kernels/natural/kernel.py``); its plain PyTorch
version is ``ref.py``.  ``natural_message`` is the port's own: one
worker's row of DIANA's message, ``decode(encode(g - h))`` of the plain
``NaturalCompression`` codec, whose round trip is its plain version.
Both kernels are in ``csrc/natural.cu``.

``shifted_natural_2d`` dispatches by the tensor's device and nothing
else: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel on the current stream or raises -- there is no fallback.
``natural_message`` takes CUDA tensors only: the codec
(``NaturalCompression.shifted_round_trip``) chooses it on the card and
runs itself elsewhere.  Each wrapper's ``launches`` counts its kernel's
launches (a plain int, incremented only where the kernel is launched);
``natural_message`` also counts them as the span counter
``round/natural_message`` (``spans.count``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels.natural.ref import (DEFAULT_BLOCK_ROWS, LANE,
                                             shifted_natural_ref)

__all__ = ["DEFAULT_BLOCK_ROWS", "LANE", "natural_message",
           "shifted_natural_2d"]

_VP = ctypes.c_void_p
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("natural")
    if not getattr(lib, "_natural_typed", False):
        lib.shifted_natural_2d.argtypes = [_VP, _VP, _VP, _VP,
                                           ctypes.c_longlong, ctypes.c_int,
                                           _VP]
        lib.shifted_natural_2d.restype = ctypes.c_int
        lib.natural_message.argtypes = [_VP, _VP, _VP, _VP,
                                        ctypes.c_longlong, ctypes.c_int, _VP]
        lib.natural_message.restype = ctypes.c_int
        lib.natural_error_string.argtypes = [ctypes.c_int]
        lib.natural_error_string.restype = ctypes.c_char_p
        lib._natural_typed = True
    return lib


def _check(name, t, dtypes, shape, device, aligned=True) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))},"
                        f" got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def shifted_natural_2d(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor, *,
                       block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """``h + C_nat(g - h)``.  g, h: (R, 128), both f32 or both bf16; u:
    (R, 128) f32 uniforms in [0, 1).  Returns (R, 128) in g's dtype.
    ``block_rows`` is the reference's tile and must divide R; the result
    does not depend on it."""
    r, lane = g.shape
    if lane != LANE or r < 1 or block_rows < 1 or r % block_rows:
        raise ValueError(f"expected (R, {LANE}) with R % block_rows == 0; "
                         f"got ({r}, {lane}) and block_rows {block_rows}")
    dev = g.device
    _check("g", g, _DTYPES, (r, LANE), dev)
    _check("h", h, (g.dtype,), (r, LANE), dev)
    _check("u", u, (torch.float32,), (r, LANE), dev)
    if dev.type == "cpu":
        return shifted_natural_ref(g, h, u)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(g)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.shifted_natural_2d(
            g.data_ptr(), h.data_ptr(), u.data_ptr(), out.data_ptr(), r,
            int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.natural_error_string(err).decode()
        raise RuntimeError(f"shifted_natural_2d: CUDA launch failed ({err}: "
                           f"{msg})")
    shifted_natural_2d.launches += 1
    return out


shifted_natural_2d.launches = 0


def natural_message(g: torch.Tensor, h: torch.Tensor, u: torch.Tensor, *,
                    out: torch.Tensor = None) -> torch.Tensor:
    """``NaturalCompression``'s ``decode(encode(g - h))`` with the uniforms
    ``u``, on the card: one worker's DIANA message.  g, h: one shape,
    both f32 or both bf16; u: f32 of that shape; all CUDA tensors on one
    device, contiguous, in any alignment of their element type.  Written
    into ``out`` (g's shape and dtype, contiguous) when given, else into
    a new tensor; returns it."""
    dev = g.device
    shape = tuple(g.shape)
    _check("g", g, _DTYPES, shape, dev, aligned=False)
    _check("h", h, (g.dtype,), shape, dev, aligned=False)
    _check("u", u, (torch.float32,), shape, dev, aligned=False)
    if out is None:
        out = torch.empty_like(g)
    else:
        _check("out", out, (g.dtype,), shape, dev, aligned=False)
    if dev.type != "cuda":
        raise ValueError(f"natural_message: a CUDA kernel; got {dev}")
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.natural_message(
            g.data_ptr(), h.data_ptr(), u.data_ptr(), out.data_ptr(),
            g.numel(), int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.natural_error_string(err).decode()
        raise RuntimeError(f"natural_message: CUDA launch failed ({err}: "
                           f"{msg})")
    natural_message.launches += 1
    spans.count("round/natural_message")
    return out


natural_message.launches = 0
