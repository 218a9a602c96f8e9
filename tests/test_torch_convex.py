"""Port parity for the convex runners: ``run_dcgd_shift`` and
``run_gdci`` traces of every rule on the paper's ridge instance
(``make_ridge(m=100, d=80, n_workers=10, noise=10)``), the port against
the reference, from one x0 (numpy, seed 0) with the reference's draws
replayed along its key chain (``test_torch_convex_round.trace_draws``).

* The bits trace is EXACT (structural, and Rand-DIANA's refresh counts
  come from the replayed draws).
* ``rel_err`` is not bitwise: the worker gradients differ from XLA's in
  the last bits (test_torch_problems.py), and XLA contracts the scan's
  ``x - gamma * g`` as it likes.  Both runs see the same draws, so with
  RandK messages alone they stay within f32 noise of each other: every
  ``rel_err`` of the STEPS steps within RTOL = 1e-4 relative of the
  reference's (measured: at most 1.9e-5, EF-BV; 6.4e-7 Rand-DIANA).
  Where a TopK picks coordinates (STAR and DIANA with C = TopK, EF21)
  a near-tie at the K-th magnitude flips one way on one side and the
  other way on the other, after which the runs part: RTOL over the
  first EXACT_WINDOW = 100 steps (measured: at most 5.9e-7), and
  RTOL_TOPK = 0.1 after them (measured: at most 6.1e-2, STAR + TopK).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.core import compressors as JC
from repro.core import iterate_comp as JI
from repro.core import shift_rules as JS
from repro.core.simulate import run_dcgd_shift as jax_run
from repro.core.simulate import run_gdci as jax_run_gdci
from repro.data.problems import make_ridge as jax_ridge
from repro_torch.core import algorithms as TA
from repro_torch.core import compressors as TC
from repro_torch.core import iterate_comp as TI
from repro_torch.core import shift_rules as TS
from repro_torch.core.simulate import run_dcgd_shift, run_gdci
from repro_torch.data.problems import make_ridge
from test_torch_convex_round import ReplayNoise, trace_draws


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STEPS = 600
RTOL, RTOL_TOPK, EXACT_WINDOW = 1e-4, 0.1, 100
#: the rules whose messages or shifts select coordinates by TopK
TOPK_RULES = ("star_topk", "diana_topk", "ef21")
KW = dict(m=100, d=80, n_workers=10, seed=0, noise=10.0)


@pytest.fixture(scope="module")
def ridge():
    return jax_ridge(**KW), make_ridge(device="cpu", **KW)


def _x0(d):
    return (np.random.default_rng(0).standard_normal(d)
            * np.sqrt(10.0)).astype(np.float32)


def _methods(ref):
    """name -> (draw kind, ref method, port method, gamma, use_star)."""
    n, d = ref.n_workers, ref.d
    q = (JC.RandK(0.25), TC.RandK(0.25))
    om = q[0].omega(d)
    topk = (JC.TopK(0.1), TC.TopK(0.1))
    delta = topk[0].delta(d)
    alpha, g_d = JA.stepsize_diana(ref.L_max, om, 0.0, n)
    alpha_c, g_dc = JA.stepsize_diana(ref.L_max, om, 0.25, n)
    p = JA.rand_diana_default_p(om)
    g_ef = 16.0 * JA.stepsize_ef21(ref.L, ref.L_max, delta)
    eta, nu = JA.efbv_params(omega=om)
    g_bv = 16.0 * JA.stepsize_efbv(ref.L, ref.L_max, omega=om, eta=eta, nu=nu)

    def pair(rule_j, rule_t, codec=q):
        return (JA.DCGDShift(q=codec[0], rule=rule_j),
                TA.DCGDShift(q=codec[1], rule=rule_t))

    return {
        "fixed": ("shift", *pair(JS.FixedShift(), TS.FixedShift()),
                  JA.stepsize_dcgd_fixed(ref.L, ref.L_max, om, n), False),
        "star": ("star", *pair(JS.StarShift(), TS.StarShift()),
                 JA.stepsize_dcgd_star(ref.L, ref.L_max, om, 0.0, n), True),
        "star_topk": ("star", *pair(JS.StarShift(c=JC.TopK(0.5)),
                                    TS.StarShift(c=TC.TopK(0.5))),
                      JA.stepsize_dcgd_star(ref.L, ref.L_max, om, 0.5, n),
                      True),
        "diana": ("diana", *pair(JS.DianaShift(alpha=alpha),
                                 TS.DianaShift(alpha=alpha)), g_d, False),
        "diana_topk": ("diana", *pair(
            JS.DianaShift(alpha=alpha_c, c=JC.TopK(0.25)),
            TS.DianaShift(alpha=alpha_c, c=TC.TopK(0.25))), g_dc, False),
        "rand_diana": ("rand_diana", *pair(JS.RandDianaShift(p=p),
                                           TS.RandDianaShift(p=p)),
                       JA.stepsize_rand_diana(ref.L_max, om, n, p)[1], False),
        "ef21": ("shift", *pair(JS.EF21Shift(), TS.EF21Shift(), topk), g_ef,
                 False),
        "efbv": ("shift", *pair(JS.EFBVShift(eta=eta, nu=nu),
                                TS.EFBVShift(eta=eta, nu=nu)), g_bv, False),
    }


def _compare(tr_ref, tr_port, what):
    np.testing.assert_array_equal(tr_port.bits, tr_ref.bits, err_msg=what)
    a, b = tr_ref.rel_err, tr_port.rel_err
    assert np.isfinite(b).all() and (a > 0).all(), what
    rel = np.abs(a - b) / a
    if what in TOPK_RULES:
        assert rel[EXACT_WINDOW:].max() <= RTOL_TOPK, (what, rel.max())
        rel = rel[:EXACT_WINDOW]
    assert rel.max() <= RTOL, (what, rel.max(), np.argmax(rel))


DCGD = ("fixed", "star", "star_topk", "diana", "diana_topk", "rand_diana",
        "ef21", "efbv")


@pytest.mark.parametrize("name", DCGD)
def test_dcgd_trace_matches_reference(ridge, name):
    ref, port = ridge
    kind, jm, tm, gamma, use_star = _methods(ref)[name]
    x0 = _x0(ref.d)
    tr_ref = jax_run(ref, jm, gamma, STEPS, x0=jnp.asarray(x0), seed=3,
                     use_star=use_star)
    c = getattr(jm.rule, "c", None)
    noise = ReplayNoise(trace_draws(kind, 3, STEPS, [(ref.d,)],
                                    ref.n_workers, jm.q, c))
    tr_port = run_dcgd_shift(port, tm, gamma, STEPS,
                             x0=torch.from_numpy(x0), use_star=use_star,
                             noise=noise)
    assert noise.done
    _compare(tr_ref, tr_port, name)


@pytest.mark.parametrize("vr", [False, True])
def test_gdci_trace_matches_reference(ridge, vr):
    ref, port = ridge
    n = ref.n_workers
    q = (JC.RandK(0.5), TC.RandK(0.5))
    om = q[0].omega(ref.d)
    x0 = _x0(ref.d)
    if vr:
        alpha, eta, gamma = JI.stepsize_vr_gdci(ref.L, ref.L_max, ref.mu, om,
                                                n)
        jm = JI.VRGDCI(q=q[0], gamma=gamma, eta=eta, alpha=alpha)
        tm = TI.VRGDCI(q=q[1], gamma=gamma, eta=eta, alpha=alpha)
    else:
        eta, gamma = JI.stepsize_gdci(ref.L, ref.L_max, ref.mu, om, n)
        jm = JI.GDCI(q=q[0], gamma=gamma, eta=eta)
        tm = TI.GDCI(q=q[1], gamma=gamma, eta=eta)
    tr_ref = jax_run_gdci(ref, jm, STEPS, x0=jnp.asarray(x0), seed=4)
    noise = ReplayNoise(trace_draws("vr_gdci" if vr else "gdci", 4, STEPS,
                                    [(ref.d,)], n, q[0]))
    tr_port = run_gdci(port, tm, STEPS, x0=torch.from_numpy(x0), noise=noise)
    assert noise.done
    _compare(tr_ref, tr_port, "vr_gdci" if vr else "gdci")


def test_default_x0_and_noise_are_the_ports(ridge):
    """Without ``x0`` and ``noise`` a run draws both from torch
    generators seeded from ``seed``: reproducible, and another seed
    gives another trace."""
    _, port = ridge
    m = TA.DCGDShift(q=TC.RandK(0.25), rule=TS.FixedShift())
    a = run_dcgd_shift(port, m, 1e-3, 50, seed=1)
    b = run_dcgd_shift(port, m, 1e-3, 50, seed=1)
    c = run_dcgd_shift(port, m, 1e-3, 50, seed=2)
    np.testing.assert_array_equal(a.rel_err, b.rel_err)
    assert not np.array_equal(a.rel_err, c.rel_err)
    assert a.bits[-1] == 50 * 10 * 20 * (32 + 7)
