"""The paper's theorems on the port: the claims of ``tests/test_theorems.py``
(the paper's ridge instance, noise 10), each with the reference test's
fixture, compressor, step size, step count, seed and assertion, run
through ``repro_torch.core.simulate`` on the CPU with the port's own
draws (``GeneratorNoise``) and its own default x0.  The claims of
``tests/test_algorithms.py`` are in ``test_torch_algorithms.py``.
"""

import numpy as np
import pytest

from repro_torch.core import (
    DCGDShift,
    DianaShift,
    EF21Shift,
    EFBVShift,
    FixedShift,
    GDCI,
    Identity,
    RandDianaShift,
    RandK,
    StarShift,
    TopK,
    VRGDCI,
    efbv_params,
    rand_diana_default_p,
    stepsize_dcgd_fixed,
    stepsize_dcgd_star,
    stepsize_diana,
    stepsize_ef21,
    stepsize_efbv,
    stepsize_gdci,
    stepsize_rand_diana,
    stepsize_vr_gdci,
)
from repro_torch.core.simulate import run_dcgd_shift, run_gdci
from repro_torch.data.problems import make_ridge


@pytest.fixture(scope="module")
def ridge():
    """test_theorems.py's fixture: the paper's instance, noise = 10."""
    return make_ridge(m=100, d=80, n_workers=10, seed=0, noise=10.0,
                      device="cpu")


# -- tests/test_theorems.py ------------------------------------------------


def test_theorem1_dcgd_neighborhood(ridge):
    q = RandK(0.25)
    omega = q.omega(ridge.d)
    gamma = stepsize_dcgd_fixed(ridge.L, ridge.L_max, omega, ridge.n_workers)
    tr = run_dcgd_shift(ridge, DCGDShift(q=q, rule=FixedShift()),
                        gamma, 4000, seed=0)
    tail = tr.rel_err[-500:]
    assert tail.mean() < 1e-2
    assert tail.mean() > 1e-12


def test_theorem2_dcgd_star_exact(ridge):
    q = RandK(0.25)
    omega = q.omega(ridge.d)
    gamma = stepsize_dcgd_star(ridge.L, ridge.L_max, omega, 0.0,
                               ridge.n_workers)
    tr = run_dcgd_shift(ridge, DCGDShift(q=q, rule=StarShift()),
                        gamma, 6000, seed=0, use_star=True)
    assert tr.rel_err[-1] < 1e-9, tr.rel_err[-1]


def test_theorem2_star_beats_dcgd(ridge):
    q = RandK(0.25)
    omega = q.omega(ridge.d)
    g1 = stepsize_dcgd_fixed(ridge.L, ridge.L_max, omega, ridge.n_workers)
    t_dcgd = run_dcgd_shift(ridge, DCGDShift(q=q, rule=FixedShift()),
                            g1, 3000, seed=0)
    g2 = stepsize_dcgd_star(ridge.L, ridge.L_max, omega, 0.0, ridge.n_workers)
    t_star = run_dcgd_shift(ridge, DCGDShift(q=q, rule=StarShift()),
                            g2, 3000, seed=0, use_star=True)
    assert t_star.rel_err[-1] < t_dcgd.rel_err[-1] * 1e-2


def test_theorem3_diana_exact(ridge):
    q = RandK(0.25)
    omega = q.omega(ridge.d)
    alpha, gamma = stepsize_diana(ridge.L_max, omega, 0.0, ridge.n_workers)
    tr = run_dcgd_shift(ridge, DCGDShift(q=q, rule=DianaShift(alpha=alpha)),
                        gamma, 8000, seed=0)
    assert tr.rel_err[-1] < 1e-6, tr.rel_err[-1]
    assert tr.rel_err[-1] < 0.05 * tr.rel_err[4000]


def test_theorem3_generalized_diana_biased_c(ridge):
    q = RandK(0.25)
    omega = q.omega(ridge.d)
    delta = TopK(0.25).delta(ridge.d)
    alpha, gamma = stepsize_diana(ridge.L_max, omega, delta, ridge.n_workers)
    tr = run_dcgd_shift(
        ridge, DCGDShift(q=q, rule=DianaShift(alpha=alpha, c=TopK(0.25))),
        gamma, 8000, seed=0)
    assert tr.rel_err[-1] < 1e-6, tr.rel_err[-1]
    assert tr.rel_err[-1] < 0.05 * tr.rel_err[4000]


def test_theorem4_rand_diana_exact(ridge):
    q = RandK(0.25)
    omega = q.omega(ridge.d)
    p = rand_diana_default_p(omega)
    _, gamma = stepsize_rand_diana(ridge.L_max, omega, ridge.n_workers, p)
    tr = run_dcgd_shift(ridge, DCGDShift(q=q, rule=RandDianaShift(p=p)),
                        gamma, 20000, seed=0)
    assert tr.rel_err[-1] < 1e-6, tr.rel_err[-1]
    assert tr.rel_err[-1] < 0.05 * tr.rel_err[8000]


def test_ef21_topk_converges_where_dcgd_topk_stalls(ridge):
    c = TopK(0.1)
    gamma = 16.0 * stepsize_ef21(ridge.L, ridge.L_max, c.delta(ridge.d))
    tr_ef = run_dcgd_shift(ridge, DCGDShift(q=c, rule=EF21Shift()),
                           gamma, 12000, seed=0)
    tr_dc = run_dcgd_shift(ridge, DCGDShift(q=c, rule=FixedShift()),
                           gamma, 12000, seed=0)
    assert tr_ef.rel_err[-1] < 1e-8, tr_ef.rel_err[-1]
    assert tr_ef.rel_err[-1] < 0.05 * tr_ef.rel_err[6000]
    dcgd_tail = float(np.median(tr_dc.rel_err[-1000:]))
    assert dcgd_tail > 1e-4, dcgd_tail
    assert tr_ef.rel_err[-1] < 1e-3 * dcgd_tail


def test_efbv_unit_knobs_trajectory_identical_to_ef21(ridge):
    c = TopK(0.1)
    gamma = 16.0 * stepsize_ef21(ridge.L, ridge.L_max, c.delta(ridge.d))
    tr_ef = run_dcgd_shift(ridge, DCGDShift(q=c, rule=EF21Shift()),
                           gamma, 2000, seed=0)
    tr_bv = run_dcgd_shift(
        ridge, DCGDShift(q=c, rule=EFBVShift(eta=1.0, nu=1.0)),
        gamma, 2000, seed=0)
    np.testing.assert_array_equal(tr_ef.rel_err, tr_bv.rel_err)
    np.testing.assert_array_equal(tr_ef.bits, tr_bv.bits)


def test_efbv_biased_topk_converges_exactly(ridge):
    c = TopK(0.1)
    eta, nu = efbv_params(delta=c.delta(ridge.d))
    gamma = 16.0 * stepsize_efbv(ridge.L, ridge.L_max,
                                 delta=c.delta(ridge.d), eta=eta, nu=nu)
    tr = run_dcgd_shift(ridge, DCGDShift(q=c, rule=EFBVShift(eta=eta, nu=nu)),
                        gamma, 12000, seed=0)
    assert tr.rel_err[-1] < 1e-8, tr.rel_err[-1]
    assert tr.rel_err[-1] < 0.05 * tr.rel_err[6000]


def test_efbv_damped_unbiased_randk_converges_exactly(ridge):
    u = RandK(0.25)
    omega = u.omega(ridge.d)
    assert stepsize_efbv(ridge.L, ridge.L_max, omega=omega, eta=1.0) == 0.0
    eta, nu = efbv_params(omega=omega)
    gamma = 16.0 * stepsize_efbv(ridge.L, ridge.L_max, omega=omega,
                                 eta=eta, nu=nu)
    tr = run_dcgd_shift(ridge, DCGDShift(q=u, rule=EFBVShift(eta=eta, nu=nu)),
                        gamma, 12000, seed=0)
    assert tr.steps_to_tol(1e-6) < 4000, tr.rel_err[-1]
    assert tr.rel_err[-1] < 1e-10, tr.rel_err[-1]


def test_theorem5_gdci_neighborhood(ridge):
    q = RandK(0.5)
    omega = q.omega(ridge.d)
    eta, gamma = stepsize_gdci(ridge.L, ridge.L_max, ridge.mu, omega,
                               ridge.n_workers)
    tr = run_gdci(ridge, GDCI(q=q, gamma=gamma, eta=eta), 6000, seed=0)
    tail = tr.rel_err[-200:]
    assert tail.mean() < 1e-1
    assert tail.mean() > 1e-14


def test_theorem6_vr_gdci_exact(ridge):
    q = RandK(0.5)
    omega = q.omega(ridge.d)
    alpha, eta, gamma = stepsize_vr_gdci(ridge.L, ridge.L_max, ridge.mu,
                                         omega, ridge.n_workers)
    tr = run_gdci(ridge, VRGDCI(q=q, gamma=gamma, eta=eta, alpha=alpha),
                  20000, seed=0)
    assert tr.rel_err[-1] < 1e-8, tr.rel_err[-1]
    eta2, gamma2 = stepsize_gdci(ridge.L, ridge.L_max, ridge.mu, omega,
                                 ridge.n_workers)
    tr2 = run_gdci(ridge, GDCI(q=q, gamma=gamma2, eta=eta2), 20000, seed=0)
    assert tr.rel_err[-1] < tr2.rel_err[-1]


def test_rate_scaling_with_omega(ridge):
    steps_needed = []
    for qfrac in (1.0, 0.25):
        q = Identity() if qfrac == 1.0 else RandK(qfrac)
        omega = 0.0 if qfrac == 1.0 else q.omega(ridge.d)
        alpha, gamma = stepsize_diana(ridge.L_max, omega, 0.0,
                                      ridge.n_workers)
        if qfrac == 1.0:
            alpha = 1.0
        tr = run_dcgd_shift(ridge, DCGDShift(q=q, rule=DianaShift(alpha=alpha)),
                            gamma, 8000, seed=0)
        steps_needed.append(tr.steps_to_tol(1e-6))
    assert steps_needed[1] > steps_needed[0]
