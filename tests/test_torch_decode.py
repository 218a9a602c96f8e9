"""Port parity: the decode path (``repro_torch.models``: the ring KV
cache of ``attention_decode``, the stateful RWKV-6 step, ``decode_step``
and ``make_decode_state``) against the reference's, on the smoke
configs of qwen3-0.6b and rwkv6-3b in float32, params carried from the
reference by ``params_from_jax``.

Tolerances: both sides run the same f32 arithmetic in other summation
orders (matmul blocking, the softmax and norm reductions), so logits,
k/v and recurrent states agree to a few f32 ulps of the values involved,
not bitwise: measured on the CPU, within 1.1e-6 over 12 steps.  The
tests allow 1e-5 (1 + |reference|).  Positions (``kpos``) are integers
and compare bitwise.  Against the port's own ``forward_train`` the same
tolerance holds (measured 4e-7 for qwen3; RWKV-6 decode and forward
both run the plain recurrence on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rwkv6 as JR
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rwkv6 as TR
from repro_torch.weights import decode_state_from_jax, flatten_tree, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5
STEPS = 12
ARCHS = ["qwen3-0.6b", "rwkv6-3b"]


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = np.abs(got - want)
    bound = TOL * (1 + np.abs(want))
    assert (err <= bound).all(), (what, float(err.max()))


def _np_state(state):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, state))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(cfg_j, cfg_t, params_j, params_t, jitted reference decode_step)."""
    arch = request.param
    cfg_j = jax_smoke(arch).with_(dtype="float32")
    cfg_t = get_smoke_config(arch).with_(dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    return cfg_j, cfg_t, params_j, params_t


def _tokens(cfg, b=2, t=STEPS, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


def _jit_step(cfg_j):
    return jax.jit(lambda p, s, tok, pos: JM.decode_step(p, cfg_j, tok, s,
                                                         pos))


@pytest.mark.parametrize("b,cache_len", [(1, 4), (2, 16), (3, 7)])
def test_make_decode_state_layout(model, b, cache_len):
    """Same paths, shapes, dtypes and values (zeros, kpos -1) as the
    reference's zero decode state."""
    cfg_j, cfg_t, _, _ = model
    want = _np_state(JM.make_decode_state(cfg_j, b, cache_len))
    got = TM.make_decode_state(cfg_t, b, cache_len, "cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w)


def _run_both(cfg_j, cfg_t, params_j, params_t, toks, cache_len):
    """Teacher-forced decode of ``toks`` on both sides; yields, per step,
    (reference logits, port logits, reference state, port state)."""
    step = _jit_step(cfg_j)
    sj = JM.make_decode_state(cfg_j, toks.shape[0], cache_len)
    st = TM.make_decode_state(cfg_t, toks.shape[0], cache_len, "cpu")
    for t in range(toks.shape[1]):
        lj, sj = step(params_j, sj, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t))
        lt, st = TM.decode_step(params_t, cfg_t,
                                torch.from_numpy(toks[:, t:t + 1]), st, t)
        yield lj, lt, sj, st


def test_decode_step_matches_reference(model):
    """12 teacher-forced tokens through the reference's JITTED
    decode_step and the port's: logits and every state leaf within TOL at
    every step, kpos bitwise."""
    cfg_j, cfg_t, params_j, params_t = model
    toks = _tokens(cfg_t)
    for t, (lj, lt, sj, st) in enumerate(
            _run_both(cfg_j, cfg_t, params_j, params_t, toks, 16)):
        _close(lt, lj, f"logits step {t}")
        want = _np_state(sj)
        for k, w in want.items():
            if k.endswith("kpos"):
                np.testing.assert_array_equal(st[k].numpy(), w)
            else:
                _close(st[k], w, f"{k} step {t}")


@pytest.mark.parametrize("window,cache_len", [(4, 4), (0, 8), (5, 8)])
def test_ring_cache_shorter_than_steps(window, cache_len):
    """The ring of C < 12 slots, with and without a sliding window: slot
    ``pos % C`` overwritten, the mask from the shared clock's positions;
    logits within TOL, kpos bitwise, at every step."""
    cfg_j = jax_smoke("qwen3-0.6b").with_(dtype="float32",
                                          sliding_window=window)
    cfg_t = get_smoke_config("qwen3-0.6b").with_(dtype="float32",
                                                 sliding_window=window)
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    toks = _tokens(cfg_t, seed=1)
    for t, (lj, lt, sj, st) in enumerate(
            _run_both(cfg_j, cfg_t, params_j, params_t, toks, cache_len)):
        _close(lt, lj, f"logits step {t}")
        np.testing.assert_array_equal(st["kv/kpos"].numpy(),
                                      np.asarray(sj["kv"]["kpos"]))


def test_decode_equals_forward_train(model):
    """Decode at every position equals the port's own full-sequence
    forward on the same tokens, within TOL."""
    _, cfg_t, _, params_t = model
    toks = torch.from_numpy(_tokens(cfg_t, seed=2))
    fwd, _ = TM.forward_train(params_t, cfg_t, {"tokens": toks})
    st = TM.make_decode_state(cfg_t, toks.shape[0], STEPS, "cpu")
    for t in range(STEPS):
        lt, st = TM.decode_step(params_t, cfg_t, toks[:, t:t + 1], st, t)
        _close(lt[:, 0], fwd[:, t].detach().numpy(), f"position {t}")


def test_decode_state_from_jax_round_trip():
    """A reference decode state carried into the port decodes on as the
    reference does (the state is the port's flat {path: tensor})."""
    cfg_j = jax_smoke("rwkv6-3b").with_(dtype="float32")
    cfg_t = get_smoke_config("rwkv6-3b").with_(dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    step = _jit_step(cfg_j)
    sj = JM.make_decode_state(cfg_j, 2, 8)
    toks = _tokens(cfg_t, t=4, seed=3)
    for t in range(3):
        _, sj = step(params_j, sj, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                     jnp.int32(t))
    st = decode_state_from_jax(jax.tree_util.tree_map(np.asarray, sj))
    lj, _ = step(params_j, sj, jnp.asarray(toks[:, 3:4], jnp.int32),
                 jnp.int32(3))
    lt, _ = TM.decode_step(params_t, cfg_t, torch.from_numpy(toks[:, 3:4]),
                           st, 3)
    _close(lt, lj, "logits after the carried state")


@pytest.mark.parametrize("valid_rank", [1, 2])
@pytest.mark.parametrize("sk,chunk", [(7, 512), (40, 16)])
def test_chunked_attention_k_valid(valid_rank, sk, chunk):
    """Per-row key validity, (Sk,) and (B, Sk), on the one-block and the
    chunked (padded) paths, against the reference's."""
    rng = np.random.default_rng(sk + valid_rank)
    b, sq, h, kv, dh = 2, 5, 4, 2, 8
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    shape = (sk,) if valid_rank == 1 else (b, sk)
    valid = rng.random(shape) < 0.7
    valid[..., 0] = True
    kw = dict(causal=True, window=0, q_chunk=chunk)
    want = JL.chunked_attention(q, k, v, q_offset=jnp.int32(sk - sq),
                                k_positions=jnp.arange(sk, dtype=jnp.int32),
                                k_valid=jnp.asarray(valid), **kw)
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_offset=sk - sq,
                               k_positions=torch.arange(sk),
                               k_valid=torch.from_numpy(valid), **kw)
    _close(got, want, "attention")


def test_wkv_step_matches_reference():
    """One decode step of the recurrence from a carried state."""
    rng = np.random.default_rng(4)
    b, h, dk = 2, 3, 8
    r, k, w = (rng.standard_normal((b, h, dk)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(w)).astype(np.float32)
    v = rng.standard_normal((b, h, dk)).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    s = rng.standard_normal((b, h, dk, dk)).astype(np.float32)
    yj, sj = JR.wkv_step(r, k, v, w, u, s)
    yt, st = TR.wkv_step(*(torch.from_numpy(a) for a in (r, k, v, w, u, s)))
    _close(yt, yj, "y")
    _close(st, sj, "s")


def test_unported_family_raises():
    """Every family of the reference is ported: an arch_type the
    reference does not build raises ``ValueError``, as its
    ``init_params`` does."""
    cfg = get_smoke_config("qwen3-0.6b").with_(arch_type="diffusion")
    with pytest.raises(ValueError, match="unknown arch_type 'diffusion'"):
        TM.make_decode_state(cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        JM.init_params(jax.random.PRNGKey(0),
                       jax_smoke("qwen3-0.6b").with_(arch_type="diffusion"))
