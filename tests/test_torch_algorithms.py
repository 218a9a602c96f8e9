"""The paper's theorems on the port: the claims of
``tests/test_algorithms.py`` (a ridge instance conditioned for decisive
measurements, lam 0.3 and noise 10, and logistic regression), each with
the reference test's fixture, compressor, step size, step count, seed
and assertion, run through ``repro_torch.core.simulate`` on the CPU
with the port's own draws (``GeneratorNoise``) and its own default x0,
except where said.

Two claims are not carried over as the reference states them:

* ``test_theorem2_dcgd_star_exact`` also asserts that the error sampled
  every 500 steps decreases window after window.  That fails in the
  reference itself: from ~step 4000 the error sits at the f32 floor of
  ``||x - x*||^2`` (~3e-14 to 1e-13 of the start) and moves by rounding
  only (the reference's windows: 6.36e-14 at step 4500, 7.10e-14 at
  5000).  Its counterpart asserts what holds -- the final error below
  5e-5, on the port's own draws and on the reference's -- and holds
  the port's trace against the reference's with the reference's x0
  and draws replayed.
* ``test_diana_beats_dcgd_in_bits`` compares two tails that are close
  under other draws: over seeds 0-3 the reference's DIANA tail is below
  DCGD's at all four (by 1.3x to 6.2x), the port's own draws at three of
  four (seed 0: 5.2e-5 against 4.7e-5).  Its counterpart runs the
  reference's experiment itself, the reference's x0 and draws replayed
  through the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import (
    DCGDShift,
    DianaShift,
    FixedShift,
    GDCI,
    Identity,
    RandDianaShift,
    RandK,
    StarShift,
    TopK,
    VRGDCI,
    rand_diana_default_p,
    stepsize_dcgd_fixed,
    stepsize_dcgd_star,
    stepsize_diana,
    stepsize_gdci,
    stepsize_rand_diana,
    stepsize_vr_gdci,
)
from repro_torch.core.simulate import run_dcgd_shift, run_gdci
from repro_torch.data.problems import make_logreg, make_ridge
from test_torch_convex_round import ReplayNoise, trace_draws


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def prob():
    """test_algorithms.py's fixture: lam = 0.3, noise = 10."""
    return make_ridge(lam=0.3, noise=10.0, device="cpu")


@pytest.fixture(scope="module")
def q():
    return RandK(0.25)


def reference_x0(d, seed):
    """The reference's default x0 (``core/simulate.py``)."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(100 + seed), (d,))
        * jnp.sqrt(10.0)))


def test_uncompressed_gd_is_exact(prob):
    tr = run_dcgd_shift(prob, DCGDShift(Identity(), FixedShift()),
                        1.0 / prob.L, 2000)
    assert tr.rel_err[-1] < 1e-9


def test_theorem1_dcgd_neighborhood(prob, q):
    om = q.omega(prob.d)
    g = stepsize_dcgd_fixed(prob.L, prob.L_max, om, prob.n_workers)
    tr_full = run_dcgd_shift(prob, DCGDShift(q, FixedShift()), g, 4000,
                             seed=1)
    tr_half = run_dcgd_shift(prob, DCGDShift(q, FixedShift()), g / 4, 16000,
                             seed=1)
    tail_full = float(np.median(tr_full.rel_err[-500:]))
    tail_half = float(np.median(tr_half.rel_err[-500:]))
    assert tail_full > 1e-7
    assert tail_half < tail_full / 2.0


STAR_STEPS, STAR_SEED = 6000, 2


def test_theorem2_dcgd_star_exact(prob, q):
    """Thm 2: oracle shifts give exact linear convergence, down to the
    f32 floor: the final error below 5e-5 on the port's own draws and on
    the reference's; with the reference's x0 and draws the port's trace
    within 1e-3 relative of the reference's while it is above 1e-6
    (measured: 9.9e-5; below, the f32 rounding of x is a growing share
    of the error), bits equal.  (The reference test's windowed
    monotonicity is not asserted: see the module docstring.)"""
    from repro.core import DCGDShift as JD
    from repro.core import RandK as JRandK
    from repro.core import StarShift as JStar
    from repro.core.simulate import run_dcgd_shift as jax_run
    from repro.data.problems import make_ridge as jax_ridge

    om = q.omega(prob.d)
    g = stepsize_dcgd_star(prob.L, prob.L_max, om, 0.0, prob.n_workers)
    tr_own = run_dcgd_shift(prob, DCGDShift(q, StarShift()), g, STAR_STEPS,
                            use_star=True, seed=STAR_SEED)
    assert tr_own.rel_err[-1] < 5e-5
    jm = JD(JRandK(0.25), JStar())
    tr_ref = jax_run(jax_ridge(lam=0.3, noise=10.0), jm, g, STAR_STEPS,
                     use_star=True, seed=STAR_SEED)
    noise = ReplayNoise(trace_draws("star", STAR_SEED, STAR_STEPS,
                                    [(prob.d,)], prob.n_workers, jm.q,
                                    jm.rule.c))
    tr_rep = run_dcgd_shift(prob, DCGDShift(q, StarShift()), g, STAR_STEPS,
                            x0=reference_x0(prob.d, STAR_SEED),
                            use_star=True, noise=noise)
    assert noise.done
    assert tr_rep.rel_err[-1] < 5e-5
    np.testing.assert_array_equal(tr_rep.bits, tr_ref.bits)
    a, b = tr_ref.rel_err, tr_rep.rel_err
    hi = a > 1e-6
    assert (np.abs(a[hi] - b[hi]) / a[hi]).max() <= 1e-3


def test_theorem2_star_with_biased_c(prob, q):
    om = q.omega(prob.d)
    c = TopK(0.5)
    g = stepsize_dcgd_star(prob.L, prob.L_max, om, c.delta(prob.d),
                           prob.n_workers)
    tr = run_dcgd_shift(prob, DCGDShift(q, StarShift(c=c)), g, 6000,
                        use_star=True, seed=3)
    assert tr.rel_err[-1] < 5e-4


def test_theorem3_diana_exact(prob, q):
    om = q.omega(prob.d)
    alpha, g = stepsize_diana(prob.L_max, om, 0.0, prob.n_workers)
    tr = run_dcgd_shift(prob, DCGDShift(q, DianaShift(alpha)), g, 12000,
                        seed=4)
    assert tr.rel_err[-1] < 1e-4


def test_theorem3_generalized_diana_with_topk(prob, q):
    om = q.omega(prob.d)
    c = TopK(0.5)
    alpha, g = stepsize_diana(prob.L_max, om, c.delta(prob.d),
                              prob.n_workers)
    tr = run_dcgd_shift(prob, DCGDShift(q, DianaShift(alpha, c=c)), g, 12000,
                        seed=5)
    assert tr.rel_err[-1] < 1e-4


def test_theorem4_rand_diana_exact(prob, q):
    om = q.omega(prob.d)
    p = rand_diana_default_p(om)
    _, g = stepsize_rand_diana(prob.L_max, om, prob.n_workers, p)
    tr = run_dcgd_shift(prob, DCGDShift(q, RandDianaShift(p)), g, 12000,
                        seed=6)
    assert tr.rel_err[-1] < 1e-3
    assert float(np.median(tr.rel_err[-1000:])) < float(
        np.median(tr.rel_err[5000:6000]))


def test_theorem5_gdci_neighborhood(prob, q):
    om = q.omega(prob.d)
    eta, gamma = stepsize_gdci(prob.L, prob.L_max, prob.mu, om,
                               prob.n_workers)
    tr = run_gdci(prob, GDCI(q, gamma=gamma, eta=eta), 6000, seed=7)
    tail = float(np.median(tr.rel_err[-500:]))
    assert tail < 1e-1
    assert tail > 1e-9


def test_theorem6_vr_gdci_exact(prob, q):
    om = q.omega(prob.d)
    alpha, eta, gamma = stepsize_vr_gdci(prob.L, prob.L_max, prob.mu, om,
                                         prob.n_workers)
    tr = run_gdci(prob, VRGDCI(q, gamma=gamma, eta=eta, alpha=alpha), 20000,
                  seed=8)
    assert tr.rel_err[-1] < 1e-4
    eta_g, gamma_g = stepsize_gdci(prob.L, prob.L_max, prob.mu, om,
                                   prob.n_workers)
    tr_g = run_gdci(prob, GDCI(q, gamma=gamma_g, eta=eta_g), 20000, seed=8)
    assert tr.rel_err[-1] < float(np.median(tr_g.rel_err[-500:]))


def test_diana_beats_dcgd_in_bits():
    """The headline practical claim, on the reference's own experiment
    (its x0 and draws replayed; see the module docstring)."""
    from repro.core import RandK as JRandK
    from repro.core import Zero as JZero

    prob = make_ridge(noise=10.0, seed=5, device="cpu")
    q = RandK(0.05)
    om = q.omega(prob.d)
    alpha, g_d = stepsize_diana(prob.L_max, om, 0.0, prob.n_workers)
    g_f = stepsize_dcgd_fixed(prob.L, prob.L_max, om, prob.n_workers)
    steps, x0 = 20000, reference_x0(prob.d, 0)

    def replay(kind):
        return ReplayNoise(trace_draws(kind, 0, steps, [(prob.d,)],
                                       prob.n_workers, JRandK(0.05),
                                       JZero()))

    tr_diana = run_dcgd_shift(prob, DCGDShift(q, DianaShift(alpha)), g_d,
                              steps, x0=x0, noise=replay("diana"))
    tr_dcgd = run_dcgd_shift(prob, DCGDShift(q, FixedShift()), g_f, steps,
                             x0=x0, noise=replay("shift"))
    dcgd_tail = float(np.median(tr_dcgd.rel_err[-2000:]))
    diana_tail = float(np.median(tr_diana.rel_err[-2000:]))
    assert dcgd_tail > 1e-7
    assert diana_tail < dcgd_tail


def test_logreg_problem_wellformed():
    prob = make_logreg(m=200, d=40, device="cpu")
    g = prob.full_grad(prob.x_star)
    assert float(torch.linalg.norm(g)) < 1e-5
    assert abs(prob.kappa - 100.0) < 5.0
    wg = prob.worker_grads(prob.x_star)
    assert wg.shape == (10, 40)
    np.testing.assert_allclose(wg.mean(0).numpy(), g.numpy(), atol=1e-5)


def test_rand_diana_on_logreg():
    prob = make_logreg(m=200, d=40, device="cpu")
    q = RandK(0.25)
    om = q.omega(prob.d)
    p = rand_diana_default_p(om)
    _, g = stepsize_rand_diana(prob.L_max, om, prob.n_workers, p)
    tr = run_dcgd_shift(prob, DCGDShift(q, RandDianaShift(p)), g, 15000,
                        seed=9)
    assert tr.rel_err[-1] < 1e-2
