"""Port parity: the Mamba-2 (SSD) block (``repro_torch.models.mamba2``)
and the hybrid forward that takes its chunked form.

* ``_ssd_scan`` and ``_ssd_chunked`` against the reference's on the
  inputs of ``tests/test_ssm_chunked.py`` (b 2, t 256, 4 heads of 16, N
  = 8), at chunk 32, 64 and 128: each within TOL = 1e-5 (1 + |reference|)
  of the reference's scan, within CHUNK_TOL = 5e-5 (1 + |reference|) of
  its chunked form (the intra-chunk sums add up to 128 products of
  magnitude up to ~17 in another order, contracted pairwise: measured
  5.4e-6, 7.2e-6 and 2.1e-5 at chunk 32, 64 and 128), and the port's two
  forms within that test's 2e-4 of each other.  The extreme-decay case
  (dt scale 8) finite and within that test's 1e-3 of the scan.  The
  gradient of sum(y^2) through the chunked form against the reference's
  where that is finite, and finite where the reference's overflows
  (ROADMAP queue 3, item 9).
* ``mamba2_apply`` with and without a carried state against the
  reference's, and the init's f32 leaves in a bfloat16 model.
* zamba2-1.2b's smoke config at seq 128, where the model takes the
  chunked form: loss within RTOL = 1e-5 and logits within RTOL of
  their scale of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.weights import flatten_tree, params_from_jax

TOL = 1e-5
CHUNK_TOL = 5e-5
GRAD_TOL = 5e-4
RTOL = 1e-5
ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b=2, t=256, h=4, p=16, n=8, seed=0, dt_scale=1.0):
    """``tests/test_ssm_chunked.py``'s inputs, as numpy arrays."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    x = jax.random.normal(ks[0], (b, t, h, p), jnp.float32)
    bt = jax.random.normal(ks[1], (b, t, n), jnp.float32)
    ct = jax.random.normal(ks[2], (b, t, n), jnp.float32)
    dt = jax.nn.softplus(
        jax.random.normal(ks[3], (b, t, h), jnp.float32) * dt_scale - 2.0)
    a_log = jnp.log(jnp.linspace(1.0, 16.0, h))
    d_skip = jax.random.normal(ks[4], (h,), jnp.float32)
    s0 = jnp.zeros((b, h, n, p), jnp.float32)
    return [np.asarray(a) for a in (x, bt, ct, dt, a_log, d_skip, s0)]


def _t(args):
    return [torch.from_numpy(a.copy()) for a in args]


def _jax_init(cfg_j):
    """The reference's params, its init jitted (faster than op by op)."""
    return jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      cfg_j)


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - np.asarray(want))
    assert (err <= tol * (1 + np.abs(np.asarray(want)))).all(), (
        what, float(err.max()))


@pytest.fixture(scope="module")
def ssd():
    args = _inputs()
    y, s = jax.jit(JM2._ssd_scan)(*args)
    return args, np.asarray(y), np.asarray(s), TM2._ssd_scan(*_t(args))


def test_ssd_scan_matches_reference(ssd):
    _, y_ref, s_ref, (y, s) = ssd
    _close(y, y_ref, "y")
    _close(s, s_ref, "s")


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_chunked_matches_reference(ssd, chunk):
    args, y_scan, s_scan, (yt_scan, st_scan) = ssd
    yj, sj = jax.jit(lambda *a: JM2._ssd_chunked(*a, chunk=chunk))(*args)
    yt, st = TM2._ssd_chunked(*_t(args), chunk=chunk)
    _close(yt, yj, f"y chunk {chunk}", CHUNK_TOL)
    _close(st, sj, f"s chunk {chunk}", CHUNK_TOL)
    np.testing.assert_allclose(yt.numpy(), yt_scan.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st.numpy(), st_scan.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_ssd_chunked_extreme_decay():
    """Huge data-dependent dt (strong decay): finite, and within that
    test's 1e-3 of the exact scan (the reference's own chunked form is
    8.3e-4 off it, the port's 3.8e-4: measured; so the port's is held
    against the reference's scan, not its chunked form)."""
    args = _inputs(dt_scale=8.0, seed=3)
    ys_j, _ = jax.jit(JM2._ssd_scan)(*args)
    ys_t, _ = TM2._ssd_scan(*_t(args))
    yt, _ = TM2._ssd_chunked(*_t(args), chunk=64)
    assert torch.isfinite(yt).all()
    _close(ys_t, ys_j, "scan, extreme decay")
    _close(yt, ys_j, "chunked against the scan, extreme decay", 1e-3)


@pytest.fixture(scope="module")
def ssd_grads():
    """d sum(y^2) / d(x, dt) at t = 128, chunk 32: the reference's through
    its chunked form, the port's through both of its forms."""
    args = _inputs(t=128)

    def loss_j(x, dt):
        y, _ = JM2._ssd_chunked(x, args[1], args[2], dt, *args[4:], chunk=32)
        return jnp.sum(y ** 2)

    gj = [np.asarray(g) for g in jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        args[0], args[3])]
    grads = {}
    for form in ("chunked", "scan"):
        x, dt = (torch.from_numpy(a.copy()).requires_grad_(True)
                 for a in (args[0], args[3]))
        rest = _t(args[4:])
        if form == "chunked":
            y, _ = TM2._ssd_chunked(x, *_t(args[1:3]), dt, *rest, chunk=32)
        else:
            y, _ = TM2._ssd_scan(x, *_t(args[1:3]), dt, *rest)
        grads[form] = [g.numpy() for g in torch.autograd.grad(
            (y ** 2).sum(), (x, dt))]
    return gj, grads


def test_ssd_chunked_gradient(ssd_grads):
    """Against the reference's where its gradient is finite: d/dx within
    1e-4 (1 + |g|), d/d dt (sums of up to 128 terms, |g| up to ~2000)
    within GRAD_TOL = 5e-4 (1 + |g|) (measured 1.1e-5 and 2.4e-4); d/dx
    within that test's 5e-3 of the port's scan."""
    gj, grads = ssd_grads
    for got, want, what, tol in zip(grads["chunked"], gj, ("x", "dt"),
                                    (1e-4, GRAD_TOL)):
        assert np.isfinite(got).all()
        fin = np.isfinite(want)
        _close(got[fin], want[fin], f"d/d{what}", tol)
    np.testing.assert_allclose(grads["chunked"][0], grads["scan"][0],
                               rtol=5e-3, atol=5e-3)


def test_ssd_chunked_gradient_finite_where_reference_overflows(ssd_grads):
    """ROADMAP queue 3, item 9.  The reference's chunked form takes exp of
    the whole pairwise log-decay matrix and then masks its upper
    triangle; where c_t - c_s > 88 there, exp overflows to inf, and the
    masked entries' zero cotangent times inf is NaN in d/d dt.  The port
    masks before exp: the same forward values, and a gradient finite
    everywhere and within GRAD_TOL of the exact scan's."""
    gj, grads = ssd_grads
    assert np.isnan(gj[1]).any() and np.isfinite(gj[0]).all()
    assert np.isfinite(grads["chunked"][1]).all()
    _close(grads["chunked"][1], grads["scan"][1], "d/d dt against the scan",
           GRAD_TOL)


@pytest.fixture(scope="module")
def block():
    """(cfg_j, cfg_t, one Mamba-2 layer's params both sides)."""
    cfg_j = jax_smoke(ARCH).with_(dtype="float32")
    cfg_t = get_smoke_config(ARCH).with_(dtype="float32")
    pj = JM2.init_mamba2(jax.random.PRNGKey(6), cfg_j)
    return cfg_j, cfg_t, pj, params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj))


def test_mamba2_apply_matches_reference(block):
    """From zero (the scan at t = 12) and then 3 more tokens from the
    carried state (conv tail and SSM state)."""
    cfg_j, cfg_t, pj, pt = block
    x = np.random.default_rng(7).standard_normal(
        (2, 15, cfg_j.d_model)).astype(np.float32)
    fn = jax.jit(lambda p, x, s: JM2.mamba2_apply(p, x, cfg_j, s))
    yj, sj = jax.jit(lambda p, x: JM2.mamba2_apply(p, x, cfg_j))(pj, x[:, :12])
    with torch.no_grad():
        yt, st = TM2.mamba2_apply(pt, torch.from_numpy(x[:, :12]), cfg_t)
    _close(yt, yj, "y")
    yj2, sj2 = fn(pj, x[:, 12:], sj)
    with torch.no_grad():
        yt2, st2 = TM2.mamba2_apply(pt, torch.from_numpy(x[:, 12:]), cfg_t,
                                    st)
    _close(yt2, yj2, "y from a state")
    for k in ("conv", "ssm"):
        _close(st2[k], sj2[k], k)
    zero = TM2.make_mamba2_state(cfg_t.with_(dtype="bfloat16"), 2,
                                 torch.bfloat16, "cpu")
    want = JM2.make_mamba2_state(cfg_j.with_(dtype="bfloat16"), 2)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in zero.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_init_keeps_f32_leaves_in_bfloat16():
    """``a_log``, ``dt_bias`` and ``d_skip`` are f32 in a bfloat16 model,
    with the reference's values; the other leaves bfloat16."""
    cfg_j = jax_smoke(ARCH)
    cfg_t = get_smoke_config(ARCH)
    assert cfg_t.dtype == "bfloat16"
    ref = flatten_tree(jax.tree_util.tree_map(
        np.asarray, _jax_init(cfg_j)))
    got = TM.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert list(got) == list(ref)
    for k, v in got.items():
        want = torch.float32 if k.split("/")[-1] in (
            "a_log", "dt_bias", "d_skip") else torch.bfloat16
        assert v.dtype == want, k
        if want == torch.float32:
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6,
                                       err_msg=k)


def test_hybrid_forward_takes_the_chunked_form():
    """zamba2's smoke config at seq 128 (one chunk): loss and logits
    against the reference's, both through the chunked form."""
    cfg_j = jax_smoke(ARCH).with_(dtype="float32")
    cfg_t = get_smoke_config(ARCH).with_(dtype="float32")
    pj = _jax_init(cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.default_rng(8).integers(0, cfg_j.vocab_size, (2, 128))
    bj = {"tokens": toks.astype(np.int32)}
    lj, _ = jax.jit(lambda p, b: JM.forward_train(p, cfg_j, b))(pj, bj)
    calls = []
    chunked = TM2._ssd_chunked

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return chunked(*a, **kw)

    TM2._ssd_chunked = counted
    try:
        with torch.no_grad():
            lt, _ = TM.forward_train(pt, cfg_t,
                                     {"tokens": torch.from_numpy(toks)})
    finally:
        TM2._ssd_chunked = chunked
    assert len(calls) == cfg_t.n_layers
    scale = np.abs(np.asarray(lj)).max()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=RTOL * scale)
