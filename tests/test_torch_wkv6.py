"""Port parity for the WKV6 recurrence: the port's plain versions
(``repro_torch.kernels.wkv6.ref``) and its model-layout ``ops.wkv6``
(its autograd Function, whose kernel wrappers run the plain versions on
the CPU) against the reference's ``repro.kernels.wkv6.ref``,
its Pallas kernel through ``repro.kernels.wkv6.ops.wkv6`` (interpreted,
chunk 32 and 128) and the model's ``repro.models.rwkv6.wkv_scan``; and
the gradients, ``wkv6_bwd_ref`` (the reverse recurrence the backward
kernel computes), autograd through ``wkv6_ref`` and through ``ops.wkv6``,
against ``jax.grad``
through ``wkv_scan``.  Inputs are unit normal, decays exp(-exp(N(0, 1))),
made with numpy from a seed.

Tolerances: the reference's own kernel test's, 1e-4 (rtol and atol) for
f32 inputs and 3e-2 for bf16 ones; both sides upcast bf16 to f32, so the
bf16 bound is loose.  Gradients: the same f32 arithmetic summed in other
orders over T = 40 steps; measured within 3e-7 of each output's largest
entry, held to 1e-5 of it (and rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv6 import wkv_scan as jax_wkv_scan
from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import (CKPT_EVERY, wkv6_bwd_ref,
                                          wkv6_fwd_ref, wkv6_ref)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [                      # b, t, h, dk, dv (tests/test_kernels.py)
    (2, 64, 2, 64, 64),
    (1, 128, 4, 64, 64),
    (2, 96, 1, 32, 64),         # rectangular K != V
    (1, 32, 2, 16, 16),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_RTOL = 1e-5


def _inputs(seed, b, t, h, dk, dv):
    """Model-layout r, k, v, w (B, T, H, .) and u (H, K), f32 numpy."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, t, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, t, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    w = np.exp(-np.exp(rng.standard_normal((b, t, h, dk)))).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    return r, k, v, w, u


def _to_bh(x):
    b, t, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))


def _bh_inputs(seed, b, t, h, dk, dv):
    r, k, v, w, u = _inputs(seed, b, t, h, dk, dv)
    ub = np.broadcast_to(u[None], (b, h, dk)).reshape(b * h, dk).copy()
    return (*map(_to_bh, (r, k, v, w)), ub)


def _torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _jax(xs, dtype=jnp.float32):
    return [jnp.asarray(x).astype(dtype) for x in xs]


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wkv6_ref_matches_reference(shape, dtype):
    """Kernel layout (BH, T, K): the port's plain recurrence against the
    reference's, r/k/v/w in ``dtype``, u f32."""
    xs = _bh_inputs(0, *shape)
    yj, sj = jax_wkv6_ref(*_jax(xs[:4], getattr(jnp, dtype)), xs[4])
    yt, st = wkv6_ref(*_torch(xs[:4], getattr(torch, dtype)),
                      torch.from_numpy(xs[4]))
    assert yt.dtype == st.dtype == torch.float32
    _close(yt, yj, TOL[dtype])
    _close(st, sj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wkv6_ops_matches_reference_kernel(shape, chunk, dtype):
    """Model layout: the port's ``ops.wkv6`` on the CPU against the
    reference's Pallas kernel, interpreted, at two time chunks."""
    r, k, v, w, u = _inputs(1, *shape)
    yj, sj = jax_wkv6(*_jax((r, k, v, w), getattr(jnp, dtype)), u,
                      chunk=chunk, interpret=True)
    yt, st = wkv6(*_torch((r, k, v, w), getattr(torch, dtype)),
                  torch.from_numpy(u))
    assert tuple(yt.shape) == tuple(yj.shape)
    assert tuple(st.shape) == tuple(sj.shape)
    _close(yt, yj, TOL[dtype])
    _close(st, sj, TOL[dtype])


def test_wkv6_matches_model_scan():
    r, k, v, w, u = _inputs(2, 2, 64, 2, 64, 64)
    yj, sj = jax_wkv_scan(*_jax((r, k, v, w, u)))
    yt, st = wkv6(*_torch((r, k, v, w, u)))
    _close(yt, yj, TOL["float32"])
    _close(st, sj, TOL["float32"])


@pytest.mark.parametrize("with_ds", [False, True])
def test_wkv6_gradients_match_jax(with_ds):
    """d/d(r, k, v, w, u) of sum(y * c) (+ sum(s_final * d)) with seeded
    cotangents: ``wkv6_bwd_ref``, autograd through ``wkv6_ref`` and
    through the port's ``ops.wkv6`` against ``jax.grad`` through the
    model's ``wkv_scan``."""
    b, t, h, dk, dv = 2, 40, 2, 32, 64
    xs = _inputs(3, b, t, h, dk, dv)
    rng = np.random.default_rng(4)
    c = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    d = (rng.standard_normal((b, h, dk, dv)).astype(np.float32) if with_ds
         else np.zeros((b, h, dk, dv), np.float32))

    def loss(r, k, v, w, u):
        y, s = jax_wkv_scan(r, k, v, w, u)
        return jnp.sum(y * c) + jnp.sum(s * d)

    ref = [np.asarray(g) for g in
           jax.grad(loss, argnums=tuple(range(5)))(*_jax(xs))]

    # autograd through the port's model-layout op
    leaves = [x.requires_grad_(True) for x in _torch(xs)]
    y, s = wkv6(*leaves)
    ((y * torch.from_numpy(c)).sum() + (s * torch.from_numpy(d)).sum()
     ).backward()
    op = [x.grad.numpy() for x in leaves]

    def model_layout(g):
        return g.numpy().reshape(b, h, t, -1).transpose(0, 2, 1, 3)

    # autograd through the plain recurrence, on the kernel layout
    bh = _bh_inputs(3, b, t, h, dk, dv)
    leaves = [x.requires_grad_(True) for x in _torch(bh)]
    y, s = wkv6_ref(*leaves)
    ((y * torch.from_numpy(_to_bh(c))).sum()
     + (s * torch.from_numpy(d.reshape(b * h, dk, dv))).sum()).backward()
    auto = [*(model_layout(x.grad) for x in leaves[:4]),
            leaves[4].grad.numpy().reshape(b, h, dk).sum(0)]

    # the explicit reverse recurrence, on the kernel layout
    dr, dk_, dv_, dw, du = wkv6_bwd_ref(
        *_torch(bh), torch.from_numpy(_to_bh(c)),
        torch.from_numpy(d.reshape(b * h, dk, dv)) if with_ds else None)

    explicit = [*map(model_layout, (dr, dk_, dv_, dw)),
                du.numpy().reshape(b, h, dk).sum(0)]
    for name, rj, go, ga, ge in zip("rkvwu", ref, op, auto, explicit):
        atol = GRAD_RTOL * np.abs(rj).max()
        np.testing.assert_allclose(go, rj, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"ops.wkv6 d{name}")
        np.testing.assert_allclose(ga, rj, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"wkv6_ref autograd d{name}")
        np.testing.assert_allclose(ge, rj, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"wkv6_bwd_ref d{name}")


def test_checkpoints_are_the_states_before_their_steps():
    """``wkv6_fwd_ref``'s ``ckpt[:, c]`` is the state after the first
    c * CKPT_EVERY steps (zero for c = 0), at a T that the checkpoint
    chunk does not divide, and its y and s_final are ``wkv6_ref``'s; the
    CPU wrapper returns the same."""
    r, k, v, w, u = _torch(_bh_inputs(5, 1, 21, 2, 16, 32))
    y, s, ckpt = wkv6_fwd_ref(r, k, v, w, u, checkpoints=True)
    yr, sr = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(s, sr, rtol=0, atol=0)
    assert wkv6_fwd_ref(r, k, v, w, u)[2] is None
    assert tuple(ckpt.shape) == (2, K.n_ckpt(21), 16, 32) == (2, 3, 16, 32)
    assert not ckpt[:, 0].any()
    for c in range(1, ckpt.shape[1]):
        n = c * CKPT_EVERY
        _, s = wkv6_ref(r[:, :n], k[:, :n], v[:, :n], w[:, :n], u)
        torch.testing.assert_close(ckpt[:, c], s, rtol=0, atol=0)
    y, s, got = K.wkv6_forward(r, k, v, w, u, checkpoints=True)
    torch.testing.assert_close(got, ckpt, rtol=0, atol=0)
    assert K.wkv6_forward(r, k, v, w, u)[2] is None


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the kernel wrappers are the plain versions and
    launch nothing."""
    r, k, v, w, u = _torch(_bh_inputs(6, 2, 19, 1, 32, 16))
    launches = (K.wkv6_forward.launches, K.wkv6_backward.launches)
    y, s, ckpt = K.wkv6_forward(r, k, v, w, u, checkpoints=True)
    yr, sr = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(s, sr, rtol=0, atol=0)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    ds = torch.randn(s.shape, generator=torch.Generator().manual_seed(1))
    for got, ref in zip(K.wkv6_backward(r, k, v, w, u, ckpt, dy, ds),
                        wkv6_bwd_ref(r, k, v, w, u, dy, ds)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert (K.wkv6_forward.launches, K.wkv6_backward.launches) == launches


def test_wrappers_reject_what_the_kernels_do_not_take():
    r, k, v, w, u = _torch(_bh_inputs(7, 1, 9, 2, 16, 16))
    with pytest.raises(ValueError, match="K, V in"):
        K.wkv6_forward(*(torch.zeros(2, 9, 48) for _ in range(4)),
                       torch.zeros(2, 48))
    with pytest.raises(TypeError):
        K.wkv6_forward(r, k.double(), v, w, u)
    with pytest.raises(TypeError):
        K.wkv6_forward(r, k, v, w, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K.wkv6_forward(r, k, v.transpose(1, 2).contiguous().transpose(1, 2),
                       w, u)
    with pytest.raises(ValueError, match="shape"):
        K.wkv6_forward(r, k, v, w, u[:1])
    _, _, ckpt = K.wkv6_forward(r, k, v, w, u, checkpoints=True)
    dy = torch.zeros((2, 9, 16))
    with pytest.raises(TypeError):
        K.wkv6_backward(r.to(torch.bfloat16), k, v, w, u, ckpt, dy)
    with pytest.raises(ValueError, match="shape"):
        K.wkv6_backward(r, k, v, w, u, ckpt[:, :1], dy)


@pytest.mark.parametrize("with_ds", [False, True])
def test_autograd_function_matches_plain_autograd(with_ds):
    """The autograd Function that carries CUDA tensors through the two
    kernels, run here on CPU tensors (its wrappers then run the plain
    versions): the same outputs as ``wkv6_ref`` and the gradients of
    autograd through it, with and without a final-state gradient."""
    from repro_torch.kernels.wkv6.ops import _WKV6

    xs = _bh_inputs(8, 2, 27, 2, 32, 16)
    rng = np.random.default_rng(9)
    c = torch.from_numpy(rng.standard_normal((4, 27, 16)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((4, 32, 16)).astype(np.float32))
    grads = []
    for fn in (_WKV6.apply, wkv6_ref):
        leaves = [x.requires_grad_(True) for x in _torch(xs)]
        y, s = fn(*leaves)
        loss = (y * c).sum() + ((s * d).sum() if with_ds else 0.0)
        loss.backward()
        grads.append(([y.detach(), s.detach()], [x.grad for x in leaves]))
    (out_f, g_f), (out_r, g_r) = grads
    for got, ref in zip(out_f, out_r):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for name, got, ref in zip("rkvwu", g_f, g_r):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * ref.abs().max().item(),
                                   err_msg=f"d{name}")


def _extreme(w):
    """``w`` (BH >= 5, T, K) with the decays the kernels are held to at
    their extremes on the card: rows of all 0, all 1e-30, all 1 - 2^-24
    (the largest f32 below 1), all 1, and the four mixed along K."""
    w = w.copy()
    values = np.array([0.0, 1e-30, 1.0 - 2.0 ** -24, 1.0], np.float32)
    w[:4] = values[:, None, None]
    w[4] = np.tile(values, w.shape[-1] // 4)
    return w


def test_plain_versions_at_extreme_decays():
    """The port's plain recurrence against the reference's where the
    decays are 0, 1e-30, 1 - 2^-24 and 1, and its explicit reverse
    recurrence against autograd through it there, with a final-state
    gradient."""
    r, k, v, w, u = _bh_inputs(10, 6, 40, 1, 32, 16)
    w = _extreme(w)
    yj, sj = jax_wkv6_ref(*_jax((r, k, v, w)), u)
    yt, st = wkv6_ref(*_torch((r, k, v, w, u)))
    _close(yt, yj, TOL["float32"])
    _close(st, sj, TOL["float32"])
    rng = np.random.default_rng(11)
    c = torch.from_numpy(rng.standard_normal(yt.shape).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal(st.shape).astype(np.float32))
    leaves = [x.requires_grad_(True) for x in _torch((r, k, v, w, u))]
    y, s = wkv6_ref(*leaves)
    ((y * c).sum() + (s * d).sum()).backward()
    explicit = wkv6_bwd_ref(*_torch((r, k, v, w, u)), c, d)
    for name, x, got in zip("rkvwu", leaves, explicit):
        ref = x.grad.numpy()
        np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=f"d{name}")


def test_misaligned_views_are_copied_for_the_kernels():
    """The kernels read their sequences 16 bytes at a time; the wrappers
    hand them a copy of a tensor whose data does not start 16-byte aligned
    and the tensor itself otherwise (the choice is on the pointer, so it
    is exercised here on CPU views)."""
    base = torch.arange(68, dtype=torch.float32)
    aligned = base[4:]
    assert K._aligned(aligned) is aligned
    view = base[1:]
    copy = K._aligned(view)
    assert copy.data_ptr() % 16 == 0 and copy.data_ptr() != view.data_ptr()
    assert torch.equal(copy, view)


def _misaligned(x):
    view = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    return view.view(x.shape).copy_(x)


def test_autograd_function_takes_misaligned_views():
    """``_WKV6`` through views that start off a 16-byte boundary gives what
    it gives through fresh tensors, values and gradients."""
    from repro_torch.kernels.wkv6.ops import _WKV6

    r, k, v, w, u = _torch(_bh_inputs(13, 2, 19, 1, 16, 32))
    rng = np.random.default_rng(14)
    c = torch.from_numpy(rng.standard_normal((2, 19, 32)).astype(np.float32))
    out = {}
    for label, prep in (("fresh", torch.clone), ("view", _misaligned)):
        leaves = [prep(x).requires_grad_(True) for x in (r, k, v, w, u)]
        if label == "view":
            assert all(x.data_ptr() % 16 for x in leaves[:4])
        y, s = _WKV6.apply(*leaves)
        ((y * c).sum() + s.sum()).backward()
        out[label] = [y.detach(), s.detach()] + [x.grad for x in leaves]
    for a, b in zip(out["fresh"], out["view"]):
        assert torch.equal(a, b)


def test_build_names_a_library_by_its_source():
    """Another version of a kernel source is built into a library of its
    own, named by its contents (so an unchanged copy reuses the build)."""
    import tempfile
    from pathlib import Path

    from repro_torch.kernels import _build

    src = _build.SOURCES["wkv6"]
    with tempfile.TemporaryDirectory() as d:
        same, other = Path(d) / "same.cu", Path(d) / "other.cu"
        same.write_bytes(src.read_bytes())
        other.write_bytes(src.read_bytes() + b"\n// another version\n")
        assert _build._lib_path("wkv6", same) == _build._lib_path("wkv6")
        assert _build._lib_path("wkv6", other) != _build._lib_path("wkv6")
        assert _build._lib_path("wkv6", other).parent == _build.BUILD_DIR


def test_chip_smoke_wkv6_against_needs_a_card(monkeypatch, capsys):
    """The old-against-new timing mode fails without CUDA rather than
    timing anything on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        _chip_smoke().main(["--wkv6-against", "old.cu"])
    assert exit_.value.code == 1
    assert "needs a GPU" in capsys.readouterr().err


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_extreme_decays_match_the_tests():
    """``chip_smoke.py`` holds the kernels to the same extreme decays as
    ``_extreme`` here."""
    w = np.random.default_rng(12).random((7, 3, 16)).astype(np.float32)
    got = _chip_smoke().extreme_decays(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, _extreme(w))


def test_chip_smoke_backward_shared_memory():
    """The backward's shared memory as ``chip_smoke.py`` prints it: the
    layout of ``bwd_smem_floats`` in wkv6.cu, within the 227 KB a block may
    take at every (K, V)."""
    smoke = _chip_smoke()
    assert smoke.wkv6_bwd_smem_bytes(64, 64) == 213312
    assert smoke.wkv6_bwd_smem_bytes(16, 16) == 26752
    assert max(smoke.wkv6_bwd_smem_bytes(a, b) for a in K.DIMS
               for b in K.DIMS) <= 232448


def test_chip_smoke_reads_the_ptxas_report():
    """Registers, spills and shared memory per kernel from an ``nvcc
    -Xptxas=-v`` log, with the names shortened."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115wkv6_"
        "bwd_kernelILi64ELi64EEEvPKfS2_S2_PfS3_i' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115wkv6_"
        "bwd_kernelILi64ELi64EEEvPKfS2_S2_PfS3_i",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 121 registers, used 1 barriers, 480 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115wkv6_"
        "fwd_kernelILi32ELi16E13__nv_bfloat16EEvPKT1_S5_PKfPfS8_i' for "
        "'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 29696 bytes "
        "smem, 424 bytes cmem[0]",
    ])
    assert _chip_smoke().ptxas_report(log) == [
        ("wkv6_bwd_kernel<64, 64>", 121, 0, 0, 0),
        ("wkv6_fwd_kernel<32, 16, bf16>", 72, 4, 4, 29696)]
