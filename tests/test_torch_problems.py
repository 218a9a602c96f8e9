"""Port parity for the convex problems (``repro_torch.data.problems``)
and the step sizes of Theorems 1-6 and EF21/EF-BV: the same constructor
arguments through the reference and the port.

* The data, ``x_star``, ``L``, ``L_max`` and ``mu`` are BITWISE the
  reference's (the numpy code is the reference's; ``L_max`` comes from
  the worker slices cast to f32, as the reference's ``np.asarray`` of
  its f32 array gives them).
* The step sizes are plain Python floats: EQUAL.
* ``worker_grads`` and ``full_grad`` are NOT bitwise: XLA sums the
  products of its dots in an order of its own, and the port's
  ``torch.matmul`` in another.  Measured over 50 random x of norm ~90
  (this file's inputs): at most 2.3e-7 (ridge) and 3.2e-7 (logreg) of
  the largest entry.  The test holds them within TOL = 1e-6 of the
  largest entry, and the loss within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.core import iterate_comp as JI
from repro.data import problems as JP
from repro_torch.core import algorithms as TA
from repro_torch.core import iterate_comp as TI
from repro_torch.data import problems as TP


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-6

PROBLEMS = {
    "ridge_theorems": ("make_ridge", dict(m=100, d=80, n_workers=10, seed=0,
                                          noise=10.0)),
    "ridge_algorithms": ("make_ridge", dict(lam=0.3, noise=10.0)),
    "ridge_noiseless": ("make_ridge", dict(seed=5)),
    "logreg_test": ("make_logreg", dict(m=200, d=40)),
    "logreg_fig4": ("make_logreg", dict(m=300, d=60, n_workers=10)),
}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def pair(request):
    fn, kw = PROBLEMS[request.param]
    return getattr(JP, fn)(**kw), getattr(TP, fn)(device="cpu", **kw)


def test_constants_bitwise(pair):
    ref, port = pair
    assert (port.name, port.d, port.n_workers) == (ref.name, ref.d,
                                                   ref.n_workers)
    assert port.L == ref.L and port.L_max == ref.L_max and port.mu == ref.mu
    assert port.kappa == ref.kappa
    assert port.x_star.dtype == torch.float32
    np.testing.assert_array_equal(port.x_star.numpy().view(np.int32),
                                  np.asarray(ref.x_star).view(np.int32))


def test_oracles_within_tolerance(pair):
    ref, port = pair
    wg, fg, loss = (jax.jit(f) for f in (ref.worker_grads, ref.full_grad,
                                         ref.loss))
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(50):
        x = (rng.standard_normal(ref.d) * 10).astype(np.float32)
        a = np.asarray(wg(jnp.asarray(x)))
        b = port.worker_grads(torch.from_numpy(x)).numpy()
        assert b.shape == (ref.n_workers, ref.d) and b.dtype == np.float32
        worst = max(worst, np.abs(a - b).max() / np.abs(a).max())
        a, b = np.asarray(fg(jnp.asarray(x))), port.full_grad(
            torch.from_numpy(x)).numpy()
        assert np.abs(a - b).max() <= TOL * np.abs(a).max()
        la, lb = float(loss(jnp.asarray(x))), port.loss(
            torch.from_numpy(x)).item()
        assert abs(la - lb) <= TOL * abs(la)
    assert worst <= TOL, worst
    assert torch.equal(port.star_grads(), port.worker_grads(port.x_star))


def test_ridge_star_grads_as_accurate_as_reference():
    """At x_star the ridge residual cancels, so the f32 gradients there
    carry large relative rounding error on both sides: the port's error
    against the f64 gradients is held within twice the reference's."""
    kw = PROBLEMS["ridge_theorems"][1]
    ref, port = JP.make_ridge(**kw), TP.make_ridge(device="cpu", **kw)
    a, y = JP._make_regression(kw["m"], kw["d"], kw["seed"], kw["noise"])
    x = np.asarray(ref.x_star, np.float64)
    ai, yi = a.reshape(10, 10, -1), y.reshape(10, 10)
    exact = np.stack([10 * ai[i].T @ (ai[i] @ x - yi[i]) + 0.01 * x
                      for i in range(10)])
    err_ref = np.abs(np.asarray(ref.star_grads()) - exact).max()
    err_port = np.abs(port.star_grads().numpy() - exact).max()
    assert err_port <= 2 * err_ref, (err_port, err_ref)


def test_f64_problem_matches_numpy():
    """``dtype=torch.float64`` (the reference's ``jax_enable_x64``): the
    data and the optimum in f64, ``L_max`` from the f64 slices, and the
    worker gradients average to the full gradient, which vanishes at
    x_star."""
    port = TP.make_ridge(device="cpu", dtype=torch.float64, noise=10.0)
    a, y = JP._make_regression(100, 80, 0, 10.0)
    x_star = np.linalg.solve(a.T @ a + np.eye(80) / 100, a.T @ y)
    np.testing.assert_array_equal(port.x_star.numpy(), x_star)
    l_is = [10 * np.linalg.eigvalsh(ai.T @ ai)[-1] + 0.01
            for ai in a.reshape(10, 10, 80)]
    assert port.L_max == float(max(l_is))
    g = port.worker_grads(port.x_star)
    assert g.dtype == torch.float64
    np.testing.assert_allclose(g.mean(0).numpy(),
                               port.full_grad(port.x_star).numpy(),
                               atol=1e-8)
    assert port.full_grad(port.x_star).abs().max().item() < 1e-6


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.make_ridge()


OMEGAS = (0.0, 0.125, 3.0, 9.0)


@pytest.mark.parametrize("omega", OMEGAS)
def test_stepsizes_equal(pair, omega):
    ref, port = pair
    L, Lm, mu, n = port.L, port.L_max, port.mu, port.n_workers
    for delta in (0.0, 0.25, 1.0):
        assert (TA.stepsize_dcgd_star(L, Lm, omega, delta, n)
                == JA.stepsize_dcgd_star(L, Lm, omega, delta, n))
        assert (TA.stepsize_diana(Lm, omega, delta, n)
                == JA.stepsize_diana(Lm, omega, delta, n))
        assert TA.stepsize_ef21(L, Lm, delta) == JA.stepsize_ef21(L, Lm, delta)
        for om in (None, omega):
            assert TA.efbv_params(delta, om) == JA.efbv_params(delta, om)
            for eta in (1.0, 0.5, 1.0 / (1.0 + omega)):
                assert (TA._efbv_contraction(eta, delta, om)
                        == JA._efbv_contraction(eta, delta, om))
                for nu in (1.0, 0.7):
                    assert (TA.stepsize_efbv(L, Lm, delta, om, eta, nu)
                            == JA.stepsize_efbv(L, Lm, delta, om, eta, nu))
    assert (TA.stepsize_dcgd_fixed(L, Lm, omega, n)
            == JA.stepsize_dcgd_fixed(L, Lm, omega, n))
    p = TA.rand_diana_default_p(omega)
    assert p == JA.rand_diana_default_p(omega)
    assert (TA.stepsize_rand_diana(Lm, omega, n, p)
            == JA.stepsize_rand_diana(Lm, omega, n, p))
    assert (TI.stepsize_gdci(L, Lm, mu, omega, n)
            == JI.stepsize_gdci(L, Lm, mu, omega, n))
    assert (TI.stepsize_vr_gdci(L, Lm, mu, omega, n)
            == JI.stepsize_vr_gdci(L, Lm, mu, omega, n))
