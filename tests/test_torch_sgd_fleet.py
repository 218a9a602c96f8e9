"""Port parity: ``sgd`` (``repro_torch.optim.optimizers``), with and
without momentum, against the reference's jitted update -- bitwise:
XLA contracts both products of the update into fmas (``m = momentum *
m + g`` and ``p - lr * m``), and the port computes them as fmas
(``fma_f32``) -- and the trainer CLI's fleet flags (``--model_wire``,
``--publish_every``, ``--serve_fleet``, ``--stale_k``) and wire flags
(``--moe-wire``, ``--act-wire``) on the CPU at the smoke size.
"""

import jax
import numpy as np
import pytest
import torch

from repro.optim.optimizers import cosine_schedule as jax_cosine
from repro.optim.optimizers import make_optimizer as jax_make
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as T
from repro_torch.optim.optimizers import cosine_schedule, make_optimizer, sgd


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("schedule", [False, True])
def test_sgd_update_bitwise_vs_reference(momentum, schedule):
    """Three updates of leaves of 7, 2115 and 64 x 33 elements (XLA's
    vector loop and its remainder), from nonzero momentum: params and
    momentum bitwise after each."""
    rng = np.random.default_rng(int(momentum * 10) + schedule)
    shapes = {"a": (7,), "b": (2115,), "c": (64, 33)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    lr_j = jax_cosine(0.05, 2, 20) if schedule else 0.05
    lr_t = cosine_schedule(0.05, 2, 20) if schedule else 0.05
    ref, port = jax_sgd(lr=lr_j, momentum=momentum), sgd(lr=lr_t,
                                                        momentum=momentum)
    sj = ref.init(p)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    st = port.init(pt)
    assert {k: tuple(v.shape) for k, v in st.v.items()} == {
        k: np.shape(v) for k, v in sj.v.items()}
    upd = jax.jit(ref.update)
    pj = p
    for g in grads:
        pj, sj = upd(g, sj, pj)
        pt, st = port.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, pt)
        for k in shapes:
            np.testing.assert_array_equal(_bits(pt[k].numpy()), _bits(pj[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(_bits(st.m[k].numpy()),
                                          _bits(sj.m[k]), err_msg=k)
    assert st.step == int(sj.step) == 3


def test_make_optimizer_builds_sgd():
    tc = TrainConfig(optimizer="sgd", learning_rate=0.1, warmup_steps=2,
                     total_steps=10)
    opt = make_optimizer(tc)
    ref = jax_make(tc)
    assert isinstance(opt, sgd) and opt.momentum == ref.momentum == 0.0
    for step in (1, 2, 5, 10):
        assert float(opt.lr(step)) == float(ref.lr(jax.numpy.int32(step)))
    with pytest.raises(ValueError):
        make_optimizer(TrainConfig(optimizer="lion"))


def test_train_cli_serve_fleet(capsys):
    """``--serve_fleet 2 --model_wire q8 --publish_every 2``: the trainer
    publishes to a smoke fleet of two replicas every second step."""
    T.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--device", "cpu", "--model_wire", "q8",
            "--publish_every", "2", "--serve_fleet", "2", "--stale_k", "3"])
    out = capsys.readouterr().out
    assert "model_wire=q8" in out and "model=" in out
    assert "fleet[2] wire=q8: 2 publishes, 0 resyncs" in out
    assert "(K=3)" in out


def test_train_cli_serve_fleet_needs_a_model_wire():
    with pytest.raises(SystemExit, match="--serve_fleet needs a model "
                                         "downlink"):
        T.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                "--device", "cpu", "--serve_fleet", "2"])


def test_train_cli_moe_and_act_wires(capsys):
    """qwen2-moe with both wires q8: the smoke BENCH_moe_wire bytes at
    batch 8, seq 64, one worker, and a finite loss."""
    T.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps", "1",
            "--batch", "8", "--seq", "64", "--device", "cpu",
            "--comm-mode", "dense", "--moe-wire", "q8", "--act-wire", "q8"])
    out = capsys.readouterr().out
    assert "grad=3,623,424  moe=655,376  act=131,080" in out
    loss = float(out.split("loss ")[1].split()[0])
    assert np.isfinite(loss)
