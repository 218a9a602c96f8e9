"""Port parity for the dense 20-32B configs (internlm2-20b, qwen1.5-32b
with its full MHA and QKV bias, qwen2.5-32b), the vision-prefix VLM
(llava-next-34b) and the MoE family (qwen2-moe-a2.7b), each at its smoke
size in float32 with params
carried from the reference by ``params_from_jax`` -- as
``tests/test_smoke_archs.py`` runs the reference's.

Per arch: the leaf layout (paths, shapes, order, analytic counts, also
at full size); ``train_loss`` and the per-worker gradients at W = 2;
the logits of ``forward_train`` over the text positions; 8 teacher-
forced ``decode_step`` tokens against the reference's jitted decode.
Tolerances as ``tests/test_torch_model.py`` and
``tests/test_torch_decode.py``: the sides sum in other orders (and the
MoE's softmax ``exp`` differs in the last bit), so the loss agrees
within RTOL = 1e-5, each gradient leaf within RTOL of its largest entry,
logits within RTOL of their scale, decode logits and cache leaves within
1e-5 (1 + |reference|), positions bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.data.tokens import synth_batch as jax_synth
from repro.dist.worker_grads import per_worker_grads as jax_pwg
from repro.dist.worker_grads import split_batch as jax_split
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.tokens import TokenStream, synth_batch
from repro_torch.dist.worker_grads import per_worker_grads, split_batch
from repro_torch.models import model as TM
from repro_torch.weights import decode_state_from_jax, flatten_tree, params_from_jax

RTOL = 1e-5
TOL = 1e-5
W = 2
NEW_ARCHS = ["internlm2-20b", "qwen1.5-32b", "qwen2.5-32b",
             "llava-next-34b", "qwen2-moe-a2.7b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch(request):
    """(name, cfg_j, cfg_t, params_j, params_t, reference batch, port batch)."""
    name = request.param
    cfg_j = jax_smoke(name).with_(dtype="float32")
    cfg_t = get_smoke_config(name).with_(dtype="float32")
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    rng = np.random.default_rng(1)
    bj = {"tokens": rng.integers(0, cfg_j.vocab_size, (4, 16)).astype(
        np.int32)}
    if cfg_j.modality == "vision_prefix":
        bj["prefix"] = (rng.standard_normal(
            (4, cfg_j.num_prefix_tokens, cfg_j.d_model)) * 0.02).astype(
            np.float32)
    bt = {k: torch.from_numpy(v.copy()) for k, v in bj.items()}
    bt["tokens"] = bt["tokens"].long()
    return name, cfg_j, cfg_t, pj, pt, bj, bt


def test_registered():
    for name in NEW_ARCHS:
        assert name in ARCH_IDS
        assert get_config(name).source == jax_full(name).source
        assert get_config(name) == get_config(name).with_()


def test_leaf_layout_matches_reference(arch):
    name, cfg_j, cfg_t, pj, pt, _, _ = arch
    flat, _ = jax.tree_util.tree_flatten_with_path(pj)
    ref = [("/".join(str(k.key) for k in path), tuple(leaf.shape),
            np.asarray(leaf).dtype) for path, leaf in flat]
    assert [(k, tuple(v.shape), v.numpy().dtype) for k, v in pt.items()] == ref
    assert [(p, s) for p, s, _ in TM.param_specs(cfg_t)] == [
        (p, s) for p, s, _ in ref]
    assert TM.count_params_analytic(cfg_t) == JM.count_params_analytic(cfg_j)
    full_j = jax_full(name).with_(dtype="float32")
    full_t = get_config(name).with_(dtype="float32")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, full_j),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    fflat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    assert [(p, s) for p, s, _ in TM.param_specs(full_t)] == [
        ("/".join(str(k.key) for k in path), tuple(leaf.shape))
        for path, leaf in fflat]
    assert (TM.count_params_analytic(full_t)
            == JM.count_params_analytic(full_j))


def test_train_loss_and_grads_match_reference(arch):
    name, cfg_j, cfg_t, pj, pt, bj, bt = arch
    lj, mj = jax.jit(lambda p, b: JM.train_loss(p, cfg_j, b))(pj, bj)
    lt, mt = TM.train_loss(pt, cfg_t, bt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    np.testing.assert_allclose(float(mt["aux"]), float(mj["aux"]),
                               rtol=RTOL)
    if cfg_t.is_moe:
        assert float(mt["aux"]) > 0
    gj, lossj, _ = jax.jit(lambda p, b: jax_pwg(
        lambda p, b: JM.train_loss(p, cfg_j, b), p, jax_split(b, W)))(pj, bj)
    gt, losst, _ = per_worker_grads(lambda p, b: TM.train_loss(p, cfg_t, b),
                                    pt, split_batch(bt, W))
    np.testing.assert_allclose(float(losst), float(lossj), rtol=RTOL)
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, gj))
    assert list(gt) == list(ref)
    for k, g in gt.items():
        assert torch.isfinite(g).all(), k
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=0,
                                   atol=RTOL * scale, err_msg=k)


def test_logits_match_reference(arch):
    """Logits over the text positions only: the VLM drops its prefix."""
    name, cfg_j, cfg_t, pj, pt, bj, bt = arch
    lj, _ = jax.jit(lambda p, b: JM.forward_train(p, cfg_j, b))(pj, bj)
    lt, _ = TM.forward_train(pt, cfg_t, bt)
    assert tuple(lt.shape) == (4, 16, cfg_t.vocab_size) == tuple(lj.shape)
    scale = np.abs(np.asarray(lj)).max()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=RTOL * scale)


def _close(got, want, what):
    err = np.abs(got - np.asarray(want))
    assert (err <= TOL * (1 + np.abs(np.asarray(want)))).all(), (
        what, float(err.max()))


def test_decode_matches_reference(arch):
    """8 teacher-forced tokens through a cache of 6 slots (the ring
    wraps): logits and cache leaves within TOL at every step, positions
    bitwise; the zero state's layout is the reference's (the MoE family
    holds ``kv_dense`` of no layers and ``kv_moe``)."""
    name, cfg_j, cfg_t, pj, pt, _, _ = arch
    toks = np.random.default_rng(2).integers(0, cfg_t.vocab_size, (2, 8))
    sj = JM.make_decode_state(cfg_j, 2, 6)
    st = TM.make_decode_state(cfg_t, 2, 6, "cpu")
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, sj))
    assert [(k, tuple(v.shape)) for k, v in st.items()] == [
        (k, v.shape) for k, v in want.items()]
    if cfg_t.is_moe:
        assert st["kv_dense/k"].shape[0] == 0
        assert st["kv_moe/k"].shape[0] == cfg_t.n_layers
    step = jax.jit(lambda p, s, tok, pos: JM.decode_step(p, cfg_j, tok, s,
                                                         pos))
    for t in range(toks.shape[1]):
        lj, sj = step(pj, sj, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t))
        lt, st = TM.decode_step(pt, cfg_t, torch.from_numpy(toks[:, t:t + 1]),
                                st, t)
        _close(lt.numpy(), lj, f"{name} logits step {t}")
        for k, w in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                        sj)).items():
            if k.endswith("kpos"):
                np.testing.assert_array_equal(st[k].numpy(), w)
            else:
                _close(st[k].numpy(), w, f"{name} {k} step {t}")
    # a carried state decodes the same
    st2 = decode_state_from_jax(jax.tree_util.tree_map(np.asarray, sj))
    assert list(st2) == list(st)


def test_vision_prefix_batch():
    """``synth_batch`` for the VLM: ``text_len = max(2, seq -
    num_prefix_tokens)`` tokens and a (B, P, D) f32 prefix of scale 0.02,
    the reference's shapes and dtypes; the audio frontend raises."""
    cfg_j = jax_smoke("llava-next-34b")
    cfg_t = get_smoke_config("llava-next-34b")
    for seq in (40, 10):
        bj = jax_synth(jax.random.PRNGKey(0), cfg_j, seq, 3)
        bt = synth_batch(torch.Generator().manual_seed(0), cfg_t, seq, 3)
        assert {k: tuple(v.shape) for k, v in bt.items()} == {
            k: tuple(v.shape) for k, v in bj.items()}
        assert bt["prefix"].dtype == torch.float32
        assert 0.01 < float(bt["prefix"].std()) < 0.03
        assert int(bt["tokens"].max()) < cfg_t.vocab_size
    b = TokenStream(cfg_t, 24, 2).batch(0)
    assert tuple(b["tokens"].shape) == (2, 8)
    assert tuple(b["prefix"].shape) == (2, 16, cfg_t.d_model)
    with pytest.raises(NotImplementedError, match="item 9f"):
        synth_batch(torch.Generator(), cfg_t.with_(modality="audio_frames"),
                    8, 1)


def test_serve_cli_runs_the_new_arch(arch, capsys):
    """``launch.serve --arch <id> --smoke --device cpu``: an int8 model
    broadcast, then batched greedy decode."""
    from repro_torch.launch import serve

    name = arch[0]
    res = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "2", "--gen-len", "2",
                      "--broadcast-compressor", "int8"])
    assert tuple(res.tokens.shape) == (2, 5) and res.bits > 0
    assert f"{name}: 8 tokens" in capsys.readouterr().out
