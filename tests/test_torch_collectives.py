"""Port parity: the worker mean (``repro_torch.dist.collectives.dense_mean``),
the dense resync of the master shift (``comm.channel.resync_h_bar``) and
the training CLI's shift-rule flags, against the reference.

The reference's mean is ``jnp.mean(a, axis=0)`` as XLA compiles it on the
CPU: the rows summed in f32 one after another (above 32 rows, in padded
windows of 32), then multiplied by ``f32(1/W)`` -- not divided, and not in
``torch.mean``'s order.  The port reproduces that order, so every
comparison here is BITWISE (bit patterns; any NaN equals any NaN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.channel import resync_h_bar as jax_resync
from repro.launch.train import SHIFT_RULE_CHOICES as JAX_CHOICES
from repro_torch.comm.channel import resync_h_bar
from repro_torch.configs.base import CompressionConfig
from repro_torch.dist.collectives import dense_mean
from repro_torch.launch import train as port_train


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_jax_mean = jax.jit(lambda a: jnp.mean(a, axis=0))


def _bits_equal(got: torch.Tensor, ref) -> bool:
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return bool(((a.view(np.int32) == b.view(np.int32))
                 | (np.isnan(a) & np.isnan(b))).all())


def _mean_pair(w, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((w, *shape),
                                                    dtype=np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = _jax_mean(jnp.asarray(x).astype(jd))
    got = dense_mean({"x": torch.from_numpy(x).to(getattr(torch, dtype))})["x"]
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(10, 80), (10, 100_000)])
@pytest.mark.parametrize("w", range(2, 33))
def test_dense_mean_bitwise_vs_reference(w, shape, dtype):
    """Up to 32 workers XLA sums the rows in order; ``torch.mean`` did not
    (at W = 3 it differed in about a third of the elements)."""
    got, ref = _mean_pair(w, shape, dtype, seed=w)
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [33, 40, 47, 63, 64, 65, 100, 128, 129, 1025])
def test_dense_mean_above_32_workers(w, dtype):
    """Above 32 rows XLA pads the axis to a multiple of 32 (the smaller
    half of the padding in front), sums each window of 32 in order, then
    the window sums: bitwise at ragged W too, and at 1025 (33 windows,
    whose sums are windowed again)."""
    got, ref = _mean_pair(w, (10, 80), dtype, seed=w)
    assert _bits_equal(got, ref)


def _shift_trees(w, seed):
    rng = np.random.default_rng(seed)
    h = {"a": rng.standard_normal((w, 3, 40), dtype=np.float32),
         "b": rng.standard_normal((w, 7), dtype=np.float32)}
    h_bar = {k: rng.standard_normal(v.shape[1:], dtype=np.float32)
             for k, v in h.items()}
    return h, h_bar


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("w", [3, 4, 10])
@pytest.mark.parametrize("every", [1, 2, 3, 5])
def test_resync_h_bar_matches_reference(every, w):
    """It fires exactly on ``step % every == every - 1``, then returns the
    dense mean of the shifts bitwise equal to the reference's; on the
    other steps it returns ``h_bar`` itself."""
    h, h_bar = _shift_trees(w, seed=every * 100 + w)
    ph, phb = _torch(h), _torch(h_bar)
    for step in range(12):
        ref = jax_resync(h, h_bar, step, every)
        got = resync_h_bar(ph, phb, step, every)
        fires = step % every == every - 1
        assert (got is not phb) == fires, step
        for k in h:
            assert _bits_equal(got[k], ref[k]), (step, k)
            if not fires:
                assert _bits_equal(got[k], h_bar[k])


@pytest.mark.parametrize("every", [0, -1])
def test_resync_h_bar_noop(every):
    """``every <= 0`` and stateless rules (h or h_bar None) return
    ``h_bar`` as it is, as the reference does."""
    h, h_bar = _shift_trees(4, seed=1)
    ph, phb = _torch(h), _torch(h_bar)
    for step in range(4):
        assert resync_h_bar(ph, phb, step, every) is phb
        assert jax_resync(h, h_bar, step, every) is h_bar
    assert resync_h_bar(None, phb, 0, 1) is phb
    assert resync_h_bar(ph, None, 0, 1) is None
    assert jax_resync(None, h_bar, 0, 1) is h_bar
    assert jax_resync(h, None, 0, 1) is None


def _shift_rule_action():
    (act,) = [a for a in port_train.build_parser()._actions
              if a.dest == "shift_rule"]
    return act


def test_cli_shift_rule_choices_are_the_reference():
    assert tuple(port_train.SHIFT_RULE_CHOICES) == tuple(JAX_CHOICES)
    assert list(_shift_rule_action().choices) == list(JAX_CHOICES)
    assert "star" not in JAX_CHOICES and "vr_gdci" in JAX_CHOICES


def test_cli_rejects_star():
    """``star`` needs the gradients at the optimum: argparse refuses it."""
    with pytest.raises(SystemExit) as e:
        port_train.build_parser().parse_args(
            ["--arch", "qwen3-0.6b", "--shift-rule", "star"])
    assert e.value.code == 2


def test_vr_gdci_names_its_item():
    """``vr_gdci`` builds Algorithm 2 with the outer learning rate as its
    gamma, and names that argument when it is missing, as the
    reference's ``make`` does."""
    from repro_torch.core.iterate_comp import VRGDCI

    comp = CompressionConfig(shift_rule="vr_gdci")
    with pytest.raises(ValueError, match="learning_rate"):
        comp.make()
    q, rule = comp.make(learning_rate=0.01)
    assert rule == VRGDCI(q=q, gamma=0.01, eta=comp.gdci_eta,
                          alpha=comp.shift_alpha)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag", ["--drift-resync-every",
                                  "--drift_resync_every"])
def test_cli_drift_resync_every_reaches_config(flag, monkeypatch):
    assert port_train.build_parser().parse_args(
        ["--arch", "qwen3-0.6b"]).drift_resync_every == 0
    seen = {}

    def init_state(seed, cfg, tcfg, w, device=None):
        seen["comp"] = tcfg.compression
        raise _Stop

    monkeypatch.setattr(port_train, "init_state", init_state)
    with pytest.raises(_Stop):
        port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                         flag, "3"])
    assert seen["comp"].drift_resync_every == 3


def test_cli_drift_resync_fires_in_the_step():
    """With ``--drift-resync-every 1`` every step ends with ``h_bar``
    replaced by the dense mean of the shifts."""
    state = port_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "16", "--device",
                             "cpu", "--drift-resync-every", "1"])
    mean = dense_mean(state.h)
    assert state.step == 2 and state.h_bar.keys() == mean.keys()
    for k, v in mean.items():
        assert torch.equal(state.h_bar[k], v), k
