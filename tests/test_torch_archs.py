"""Port parity for the dense 20-32B configs (internlm2-20b, qwen1.5-32b
with its full MHA and QKV bias, qwen2.5-32b), the vision-prefix VLM
(llava-next-34b), the MoE family (qwen2-moe-a2.7b, and
deepseek-v2-lite-16b with multi-head latent attention and one leading
dense layer), the Mamba-2 hybrid (zamba2-1.2b, its shared attention
block) and the audio encoder-decoder (seamless-m4t-large-v2), each at
its smoke size in float32 with params carried from the reference by
``params_from_jax`` -- as ``tests/test_smoke_archs.py`` runs the
reference's.

Per arch: the leaf layout (paths, shapes, order, analytic counts, also
at full size in the model's dtype, leaf dtypes included); the
deterministic inits; ``train_loss`` and the per-worker gradients at
W = 2; the logits of ``forward_train`` over the text positions; 8
teacher-forced ``decode_step`` tokens through a cache of 6 slots (the
ring wraps) against the reference's jitted decode, the audio decoder
over random encoder keys and values; the serve CLI.
Tolerances as ``tests/test_torch_model.py`` and
``tests/test_torch_decode.py``: the sides sum in other orders (and the
MoE's softmax ``exp`` differs in the last bit), so the loss agrees
within RTOL = 1e-5, each gradient leaf within RTOL of its largest entry,
logits within RTOL of their scale, decode logits and cache leaves within
1e-5 (1 + |reference|), positions bitwise.
"""

import dataclasses

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
             "llava-next-34b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
             "zamba2-1.2b", "seamless-m4t-large-v2"]
#: full-size params and leaves of the last three families, the
#: reference's ``eval_shape`` counts
FULL = {"deepseek-v2-lite-16b": (15_706_484_224, 29),
        "zamba2-1.2b": (1_170_473_856, 21),
        "seamless-m4t-large-v2": (2_034_783_232, 26)}
ENC_LEN = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(cfg_j):
    """The reference's params, its init jitted (faster than op by op)."""
    return jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      cfg_j)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch(request):
    """(name, cfg_j, cfg_t, params_j, params_t, reference batch, port batch)."""
    name = request.param
    cfg_j = jax_smoke(name).with_(dtype="float32")
    cfg_t = get_smoke_config(name).with_(dtype="float32")
    pj = _jax_init(cfg_j)
    pt = params_from_jax(_np(pj))
    rng = np.random.default_rng(1)
    bj = {"tokens": rng.integers(0, cfg_j.vocab_size, (4, 16)).astype(
        np.int32)}
    if cfg_j.modality == "vision_prefix":
        bj["prefix"] = (rng.standard_normal(
            (4, cfg_j.num_prefix_tokens, cfg_j.d_model)) * 0.02).astype(
            np.float32)
    if cfg_j.is_encoder_decoder:
        bj["frames"] = (rng.standard_normal((4, 16, cfg_j.d_model))
                        * 0.02).astype(np.float32)
    bt = {k: torch.from_numpy(v.copy()) for k, v in bj.items()}
    bt["tokens"] = bt["tokens"].long()
    return name, cfg_j, cfg_t, pj, pt, bj, bt


def test_registered():
    """The reference's ten archs, in its order, each config and smoke
    config field for field the reference's; every family builds."""
    from repro.configs import ARCH_IDS as JAX_IDS

    assert ARCH_IDS == JAX_IDS
    for name in ARCH_IDS:
        for port, ref in ((get_config, jax_full),
                          (get_smoke_config, jax_smoke)):
            assert dataclasses.asdict(port(name)) == dataclasses.asdict(
                ref(name)), name
        assert get_config(name) == get_config(name).with_()
        assert TM.param_specs(get_smoke_config(name))


def test_leaf_layout_matches_reference(arch):
    name, cfg_j, cfg_t, pj, pt, _, _ = arch
    flat, _ = jax.tree_util.tree_flatten_with_path(pj)
    ref = [("/".join(str(k.key) for k in path), tuple(leaf.shape),
            np.asarray(leaf).dtype) for path, leaf in flat]
    assert [(k, tuple(v.shape), v.numpy().dtype) for k, v in pt.items()] == ref
    assert [(p, s) for p, s, _ in TM.param_specs(cfg_t)] == [
        (p, s) for p, s, _ in ref]
    assert TM.count_params_analytic(cfg_t) == JM.count_params_analytic(cfg_j)
    # at full size, in the model's bfloat16: paths, shapes and dtypes (the
    # MoE routers and Mamba-2's a_log, dt_bias, d_skip stay f32)
    full_j, full_t = jax_full(name), get_config(name)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, full_j),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    fflat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    assert [(p, s, str(TM.leaf_dtype(full_t, i)).removeprefix("torch."))
            for p, s, i in TM.param_specs(full_t)] == [
        ("/".join(str(k.key) for k in path), tuple(leaf.shape),
         str(leaf.dtype)) for path, leaf in fflat]
    count, leaves = FULL.get(name, (JM.count_params_analytic(full_j),
                                    len(fflat)))
    assert (TM.count_params_analytic(full_t)
            == JM.count_params_analytic(full_j) == count)
    assert len(fflat) == leaves


def test_init_constants_match_reference(arch):
    """The deterministic inits (norm scales, zero biases, Mamba-2's
    ``a_log``, ``dt_bias``, ``d_skip``) are the reference's values, the
    random ones of the reference's scale."""
    name, cfg_j, cfg_t, pj, _, _, _ = arch
    init = TM.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    ref = flatten_tree(_np(pj))
    for path, _, spec in TM.param_specs(cfg_t):
        assert init[path].dtype == TM.leaf_dtype(cfg_t, spec)
        if isinstance(spec, tuple):
            np.testing.assert_allclose(init[path].numpy(), ref[path],
                                       rtol=1e-6, err_msg=path)
        else:
            assert init[path].std().item() == pytest.approx(
                float(ref[path].std()), rel=0.2), path


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
    ref = flatten_tree(_np(gj))
    assert list(gt) == list(ref)
    for k, g in gt.items():
        assert torch.isfinite(g).all(), k
        scale = np.abs(ref[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=0,
                                   atol=RTOL * scale, err_msg=k)


def test_logits_match_reference(arch):
    """Logits over the text positions only: the VLM drops its prefix."""
    name, cfg_j, cfg_t, pj, pt, bj, bt = arch
    lj, _ = jax.jit(lambda p, b: JM.forward_train(p, cfg_j, b))(pj, bj)
    with torch.no_grad():
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
    wraps): logits and state leaves within TOL at every step, positions
    bitwise; the zero state's layout is the reference's (the MoE family
    holds ``kv_dense`` of its ``first_dense_layers``, none for qwen2-moe,
    and ``kv_moe``, deepseek's latent caches; zamba2's Mamba-2 states
    and the shared block's cache a use; seamless's caches and its
    encoder keys and values, here random)."""
    name, cfg_j, cfg_t, pj, pt, _, _ = arch
    toks = np.random.default_rng(2).integers(0, cfg_t.vocab_size, (2, 8))
    enc_len = ENC_LEN if cfg_t.is_encoder_decoder else 0
    sj = JM.make_decode_state(cfg_j, 2, 6, enc_len)
    st = TM.make_decode_state(cfg_t, 2, 6, "cpu", enc_len=enc_len)
    want = flatten_tree(_np(sj))
    assert [(k, tuple(v.shape), v.dtype) for k, v in st.items()] == [
        (k, v.shape, torch.from_numpy(v.copy()).dtype)
        for k, v in want.items()]
    if cfg_t.is_moe:
        nd = cfg_t.first_dense_layers
        assert st["kv_dense/kpos"].shape[0] == nd
        assert st["kv_moe/kpos"].shape[0] == cfg_t.n_layers - nd
    if cfg_t.is_encoder_decoder:
        rng = np.random.default_rng(3)
        sj = {**sj, "xkv": {k: jnp.asarray(
            rng.standard_normal(v.shape).astype(np.float32))
            for k, v in sj["xkv"].items()}}
        st = decode_state_from_jax(_np(sj))
    step = jax.jit(lambda p, s, tok, pos: JM.decode_step(p, cfg_j, tok, s,
                                                         pos))
    for t in range(toks.shape[1]):
        lj, sj = step(pj, sj, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                      jnp.int32(t))
        lt, st = TM.decode_step(pt, cfg_t, torch.from_numpy(toks[:, t:t + 1]),
                                st, t)
        _close(lt.numpy(), lj, f"{name} logits step {t}")
        for k, w in flatten_tree(_np(sj)).items():
            if k.endswith("kpos"):
                np.testing.assert_array_equal(st[k].numpy(), w)
            else:
                _close(st[k].numpy(), w, f"{name} {k} step {t}")
    # a carried state decodes the same
    assert list(decode_state_from_jax(_np(sj))) == list(st)


def test_vision_prefix_batch():
    """``synth_batch`` for the VLM: ``text_len = max(2, seq -
    num_prefix_tokens)`` tokens and a (B, P, D) f32 prefix of scale 0.02,
    the reference's shapes and dtypes; an encoder-decoder's batch holds
    the audio frontend's (B, seq, D) f32 frames, as the reference's."""
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
    audio_j = jax_smoke("seamless-m4t-large-v2")
    audio_t = get_smoke_config("seamless-m4t-large-v2")
    bj = jax_synth(jax.random.PRNGKey(0), audio_j, 8, 1)
    bt = synth_batch(torch.Generator().manual_seed(0), audio_t, 8, 1)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in bt.items() if k != "tokens"} == {
        "frames": ((1, 8, audio_t.d_model), "float32")} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in bj.items()
        if k != "tokens"}
    assert tuple(bt["tokens"].shape) == tuple(bj["tokens"].shape) == (1, 8)


def test_serve_cli_runs_the_new_arch(arch, capsys):
    """``launch.serve --arch <id> --smoke --device cpu``: an int8 model
    broadcast, then batched greedy decode (the audio decoder over
    ``prompt_len`` zero encoder positions)."""
    from repro_torch.launch import serve

    name = arch[0]
    res = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "2", "--gen-len", "2",
                      "--broadcast-compressor", "int8"])
    assert tuple(res.tokens.shape) == (2, 5) and res.bits > 0
    assert f"{name}: 8 tokens" in capsys.readouterr().out
