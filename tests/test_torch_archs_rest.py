"""What is new in the last three architecture families beyond the
per-arch parity of ``tests/test_torch_archs.py`` (which holds
deepseek-v2-lite-16b, zamba2-1.2b and seamless-m4t-large-v2 against the
reference with the others): the audio decoder against the port's own
forward with the encoder's keys and values in its state, the ``frames``
batch, and the train CLI of each of the three.
"""

import jax
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.tokens import synth_batch as jax_synth
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenStream, synth_batch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

TOL = 1e-5
NEW_ARCHS = ["deepseek-v2-lite-16b", "zamba2-1.2b", "seamless-m4t-large-v2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_audio_decode_against_forward():
    """The audio decoder with the encoder's keys and values in ``xkv``
    (each layer's ``cross_attention_kv`` of the encoder output) decodes
    the training forward's logits at every position."""
    cfg = get_smoke_config("seamless-m4t-large-v2").with_(dtype="float32")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    batch = TokenStream(cfg, 8, 2).batch(0)
    with torch.no_grad():
        fwd, _ = TM.forward_train(params, cfg, batch)
        enc = TM._encode(params, TM._family(cfg), cfg, batch)
        state = TM.make_decode_state(cfg, 2, 8, "cpu", enc_len=8)
        for layer, p in enumerate(TM._layers(params, "blocks/xattn/",
                                             cfg.n_layers)):
            k, v = TL.cross_attention_kv(p, enc, cfg)
            state["xkv/k"][layer] = k
            state["xkv/v"][layer] = v
        for t in range(8):
            logits, state = TM.decode_step(params, cfg,
                                           batch["tokens"][:, t:t + 1],
                                           state, t)
            err = (logits[:, 0] - fwd[:, t]).abs()
            assert (err <= TOL * (1 + fwd[:, t].abs())).all(), (
                t, float(err.max()))


def test_frames_batch():
    """``synth_batch`` for the encoder-decoder: tokens of ``seq_len`` and
    (B, seq_len, D) f32 frames of scale 0.02, the reference's shapes and
    dtypes."""
    cfg_j = jax_smoke("seamless-m4t-large-v2")
    cfg_t = get_smoke_config("seamless-m4t-large-v2")
    for seq in (16, 5):
        bj = jax_synth(jax.random.PRNGKey(0), cfg_j, seq, 3)
        bt = synth_batch(torch.Generator().manual_seed(0), cfg_t, seq, 3)
        assert {k: tuple(v.shape) for k, v in bt.items()} == {
            k: tuple(v.shape) for k, v in bj.items()}
        assert bt["frames"].dtype == torch.float32
        assert 0.01 < float(bt["frames"].std()) < 0.03
        assert int(bt["tokens"].max()) < cfg_t.vocab_size
    b = TokenStream(cfg_t, 24, 2).batch(0)
    assert tuple(b["frames"].shape) == (2, 24, cfg_t.d_model)
    assert torch.equal(TokenStream(cfg_t, 24, 2).batch(0)["frames"],
                       b["frames"])


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_train_cli_runs_the_new_arch(name, capsys):
    """``launch.train --arch <id> --smoke --steps 2 --device cpu``: loss
    finite, bits counted."""
    from repro_torch.launch import train

    state = train.main(["--arch", name, "--smoke", "--steps", "2",
                        "--batch", "2", "--seq", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={name}" in out and "step    1" in out
    assert all(torch.isfinite(p).all() for p in state.params.values())
    assert float(state.bits) > 0
