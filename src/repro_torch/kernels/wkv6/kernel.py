"""Wrappers for the WKV6 kernels (CUDA C++ for Hopper), forward and
backward, on the kernel layout: r, k, w (BH, T, K); v (BH, T, V);
u (BH, K).

``wkv6_forward`` replaces the reference's Pallas TPU kernel
``wkv6_pallas`` (``repro/kernels/wkv6/kernel.py``); ``wkv6_backward`` is
the port's own (the TPU kernel has none).  Their CUDA source is
``csrc/wkv6.cu``; their plain PyTorch versions are in ``ref.py``.

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain versions, CUDA tensors launch the kernel on the current stream or
raise -- there is no fallback.  Meta tensors (the step's cost pass,
``launch.hlo_cost``) trace one step of the plain recurrence, charged T
times.  Each wrapper counts its kernel launches
in ``<wrapper>.launches`` (a plain int, incremented only where the kernel
is launched).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import (CKPT_EVERY, wkv6_bwd_ref,
                                          wkv6_fwd_ref)

__all__ = ["CKPT_EVERY", "DIMS", "n_ckpt", "wkv6_backward", "wkv6_forward"]

#: the head widths K and V the kernels are built for
DIMS = (16, 32, 64)

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib(source=None) -> ctypes.CDLL:
    """The built library: of ``csrc/wkv6.cu``, or of ``source``, another
    version of it with the same C interface."""
    lib = _build.load("wkv6", source)
    if not getattr(lib, "_wkv6_typed", False):
        lib.wkv6_forward.argtypes = [_VP] * 8 + [_INT] * 5 + [_VP]
        lib.wkv6_forward.restype = _INT
        lib.wkv6_backward.argtypes = [_VP] * 13 + [_INT] * 4 + [_VP]
        lib.wkv6_backward.restype = _INT
        lib.wkv6_error_string.argtypes = [_INT]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        lib._wkv6_typed = True
    return lib


def n_ckpt(t: int) -> int:
    """Saved states of a length-``t`` forward: one every CKPT_EVERY steps."""
    return -(-t // CKPT_EVERY)


def _check(name, x, dtypes, shape, device) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, "
                        f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _aligned(x):
    """``x``, or a copy of it on its device where its data does not start
    on a 16-byte boundary (a view such as ``x[1:]``): the kernels read
    their sequences and checkpoints 16 bytes at a time."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _shapes(r, v):
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, T, K) and (BH, T, V); got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    bh, t, dk = r.shape
    dv = v.shape[-1]
    if bh < 1 or t < 1 or dk not in DIMS or dv not in DIMS:
        raise ValueError(f"expected BH, T >= 1 and K, V in {DIMS}; got "
                         f"BH={bh}, T={t}, K={dk}, V={dv}")
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {r.device}")
    return bh, t, dk, dv


def _meta_steps(ref, t: int, outs, xs, rest=()):
    """The step's cost pass (``launch.hlo_cost``, meta tensors): the plain
    recurrence's T steps dispatch identical ops, so one step (the inputs'
    first time slice) is traced and charged T times; returns empty
    outputs shaped ``outs`` (``(shape, dtype)``; None stays None)."""
    from repro_torch.launch import hlo_cost

    with hlo_cost.repeated(t, "wkv6_steps"):
        ref(*(x[:, :1] for x in xs), *rest)
    return tuple(None if o is None else
                 torch.empty(o[0], dtype=o[1], device="meta") for o in outs)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.wkv6_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def wkv6_forward(r, k, v, w, u, *, checkpoints: bool = False,
                 source=None):
    """The recurrence from a zero state.  r, k, w: (BH, T, K) and v: (BH,
    T, V), all f32 or all bf16; u: (BH, K) f32.  Returns ``(y (BH, T, V)
    f32, s_final (BH, K, V) f32, ckpt)``, where ``ckpt`` holds the states
    the backward starts from, (BH, n_ckpt(T), K, V) f32, when
    ``checkpoints`` is set, else ``None``.  ``source``: launch the build
    of another version of ``csrc/wkv6.cu`` (same C interface) instead, to
    time one version against another."""
    bh, t, dk, dv = _shapes(r, v)
    dev = r.device
    dtypes = (torch.float32, torch.bfloat16)
    _check("r", r, dtypes, (bh, t, dk), dev)
    for name, x, shape in (("k", k, (bh, t, dk)), ("v", v, (bh, t, dv)),
                           ("w", w, (bh, t, dk))):
        _check(name, x, (r.dtype,), shape, dev)
    _check("u", u, (torch.float32,), (bh, dk), dev)
    if dev.type == "meta":
        f32 = torch.float32
        return _meta_steps(
            lambda *a: wkv6_fwd_ref(*a, checkpoints=checkpoints), t,
            (((bh, t, dv), f32), ((bh, dk, dv), f32),
             ((bh, n_ckpt(t), dk, dv), f32) if checkpoints else None),
            (r, k, v, w), (u,))
    if dev.type == "cpu":
        return wkv6_fwd_ref(r, k, v, w, u, checkpoints=checkpoints)
    r, k, v, w = map(_aligned, (r, k, v, w))
    y = torch.empty((bh, t, dv), dtype=torch.float32, device=dev)
    s = torch.empty((bh, dk, dv), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((bh, n_ckpt(t), dk, dv), dtype=torch.float32,
                        device=dev) if checkpoints else None)
    lib = _lib(source)
    with torch.cuda.device(dev):
        err = lib.wkv6_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), bh, t, dk, dv,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "wkv6_forward")
    wkv6_forward.launches += 1
    return y, s, ckpt


def wkv6_backward(r, k, v, w, u, ckpt, dy,
                  ds_fin: Optional[torch.Tensor] = None, *, source=None):
    """Gradients of the recurrence (``ref.wkv6_bwd_ref``), all f32: the
    forward's inputs, its ``ckpt``, the output gradient ``dy`` (BH, T, V)
    and the final state's ``ds_fin`` (BH, K, V) or ``None`` (zero).
    Returns ``(dr, dk, dv, dw, du)``; ``du`` is (BH, K), one row per
    (batch, head): the caller sums it over the batch.  ``source`` as for
    ``wkv6_forward``."""
    bh, t, dk, dv = _shapes(r, v)
    dev = r.device
    f32 = (torch.float32,)
    for name, x, shape in (("r", r, (bh, t, dk)), ("k", k, (bh, t, dk)),
                           ("v", v, (bh, t, dv)), ("w", w, (bh, t, dk)),
                           ("u", u, (bh, dk)),
                           ("ckpt", ckpt, (bh, n_ckpt(t), dk, dv)),
                           ("dy", dy, (bh, t, dv))):
        _check(name, x, f32, shape, dev)
    if ds_fin is not None:
        _check("ds_fin", ds_fin, f32, (bh, dk, dv), dev)
    if dev.type == "meta":
        return _meta_steps(
            lambda r_, k_, v_, w_, dy_: wkv6_bwd_ref(r_, k_, v_, w_, u, dy_,
                                                     ds_fin), t,
            tuple((tuple(x.shape), x.dtype) for x in (r, k, v, w, u)),
            (r, k, v, w, dy))
    if dev.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, dy, ds_fin)
    r, k, v, w, ckpt, dy = map(_aligned, (r, k, v, w, ckpt, dy))
    grads = [torch.empty_like(x) for x in (r, k, v, w, u)]
    lib = _lib(source)
    with torch.cuda.device(dev):
        err = lib.wkv6_backward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
            None if ds_fin is None else ds_fin.data_ptr(),
            *(g.data_ptr() for g in grads), bh, t, dk, dv,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "wkv6_backward")
    wkv6_backward.launches += 1
    return tuple(grads)


wkv6_forward.launches = 0
wkv6_backward.launches = 0
