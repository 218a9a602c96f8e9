"""Port parity: the dense qwen3-0.6b decoder, per-worker gradients and
AdamW of ``repro_torch`` against the reference, on the smoke config
(2 layers, d 128, vocab 512) in float32 with params carried from the
reference by ``params_from_jax``.

Tolerances: the two sides run the same float32 arithmetic but sum in
different orders (matmul blocking, softmax/mean reductions) and XLA
fuses some multiply-adds into FMAs, so results agree to a few float32
ulps of the largest value involved, not bitwise.  Measured on the CPU:
loss within 3e-7 relative, every gradient leaf within 1e-6 of its
largest entry.  The tests allow 1e-5 relative -- ten times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.dist.worker_grads import per_worker_grads as jax_pwg
from repro.dist.worker_grads import split_batch as jax_split
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import cosine_schedule as jax_cosine
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.dist.worker_grads import per_worker_grads, split_batch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim.optimizers import OptState, adamw, cosine_schedule
from repro_torch.weights import flatten_tree, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5
W = 4


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_smoke("qwen3-0.6b").with_(dtype="float32", attn_q_chunk=256)
    cfg_t = port_smoke("qwen3-0.6b").with_(dtype="float32", attn_q_chunk=256)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (8, 32)).astype(np.int32)
    return cfg_j, cfg_t, pj, pt, toks


def _np_tree(t):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, t))


def test_leaf_order_and_shapes_match_reference(setup):
    cfg_j, cfg_t, pj, pt, _ = setup
    flat, _ = jax.tree_util.tree_flatten_with_path(pj)
    ref = [("/".join(str(k.key) for k in path), tuple(leaf.shape))
           for path, leaf in flat]
    assert [(k, tuple(v.shape)) for k, v in pt.items()] == ref
    assert TM.leaf_paths(cfg_t) == [k for k, _ in ref]
    assert TM.count_params_analytic(cfg_t) == JM.count_params_analytic(cfg_j)


def test_full_size_leaf_layout_matches_reference():
    """The stacked (L, ...) leaves of full-size qwen3-0.6b, by shape only."""
    from repro.configs import get_config as jax_full
    from repro_torch.configs import get_config as port_full

    cfg_j = jax_full("qwen3-0.6b").with_(dtype="float32")
    cfg_t = port_full("qwen3-0.6b").with_(dtype="float32")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ref = [("/".join(str(k.key) for k in path), tuple(leaf.shape))
           for path, leaf in flat]
    assert [(p, s) for p, s, _ in TM.param_specs(cfg_t)] == ref
    assert TM.count_params_analytic(cfg_t) == JM.count_params_analytic(cfg_j)


def test_train_loss_matches_reference(setup):
    cfg_j, cfg_t, pj, pt, toks = setup
    lj, mj = jax.jit(lambda p, t: JM.train_loss(p, cfg_j, {"tokens": t}))(
        pj, toks)
    lt, mt = TM.train_loss(pt, cfg_t, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    np.testing.assert_allclose(float(mt["xent"]), float(mj["xent"]), rtol=RTOL)


def test_per_worker_grads_match_reference(setup):
    cfg_j, cfg_t, pj, pt, toks = setup

    def jloss(p, b):
        return JM.train_loss(p, cfg_j, b)

    gj, lossj, _ = jax.jit(
        lambda p, b: jax_pwg(jloss, p, jax_split(b, W)))(pj, {"tokens": toks})
    gt, losst, _ = per_worker_grads(
        lambda p, b: TM.train_loss(p, cfg_t, b), pt,
        split_batch({"tokens": torch.from_numpy(toks).long()}, W))
    np.testing.assert_allclose(float(losst), float(lossj), rtol=RTOL)
    ref = _np_tree(gj)
    assert list(gt) == list(ref)
    for k, g in gt.items():
        assert tuple(g.shape) == (W, *pt[k].shape)
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=0,
                                   atol=RTOL * scale, err_msg=k)
    # params are untouched and carry no autograd state
    assert all(not p.requires_grad for p in pt.values())


def test_split_batch_matches_reference():
    x = np.arange(8 * 5).reshape(8, 5)
    np.testing.assert_array_equal(
        split_batch({"t": torch.from_numpy(x)}, 4)["t"].numpy(),
        np.asarray(jax_split({"t": x}, 4)["t"]))
    with pytest.raises(ValueError):
        split_batch({"t": torch.zeros((6, 2))}, 4)


@pytest.mark.parametrize("sk,chunk", [(16, 256), (24, 8), (30, 8)])
def test_chunked_attention_matches_reference(sk, chunk):
    """Both branches: one masked softmax (sk <= chunk), and the online
    softmax over key chunks, with a ragged last chunk (30 % 8)."""
    rng = np.random.default_rng(sk)
    q = rng.standard_normal((2, sk, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    kw = dict(causal=True, q_chunk=chunk)
    oj = JL.chunked_attention(q, k, v, q_offset=jnp.int32(0),
                              k_positions=jnp.arange(sk), **kw)
    ot = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_offset=0,
                              k_positions=torch.arange(sk), **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=RTOL * np.abs(np.asarray(oj)).max())


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    yj = JL.rmsnorm({"scale": scale}, x, 1e-5)
    yt = TL.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=RTOL,
                               atol=RTOL)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    rj = JL.apply_rope(x, pos, 1_000_000.0)
    rt = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       1_000_000.0)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RTOL,
                               atol=RTOL)


def test_adamw_matches_reference():
    """Three updates from the same params/grads; the schedule is
    evaluated in f32 on both sides."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7, 5), "b/scale": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    lr_j = jax_cosine(1e-2, 1, 10)
    lr_t = cosine_schedule(1e-2, 1, 10)
    for step in range(0, 12):
        np.testing.assert_allclose(float(lr_t(step)),
                                   float(lr_j(jnp.int32(step))), rtol=1e-6)
    opt_j = jax_adamw(lr=lr_j)
    opt_t = adamw(lr=lr_t)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = opt_j.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt_t.init(pt)
    assert isinstance(st, OptState)
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 1e-2
             for k, s in shapes.items()}
        pj, sj = jax.jit(opt_j.update)({k: jnp.asarray(v) for k, v in g.items()},
                                       sj, pj)
        pt, st = opt_t.update({k: torch.from_numpy(v) for k, v in g.items()},
                              st, pt)
    assert st.step == int(sj.step) == 3
    for k in shapes:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=RTOL, atol=RTOL * 1e-2)
        np.testing.assert_allclose(st.m[k].numpy(), np.asarray(sj.m[k]),
                                   rtol=RTOL, atol=1e-9)
        np.testing.assert_allclose(st.v[k].numpy(), np.asarray(sj.v[k]),
                                   rtol=RTOL, atol=1e-12)
