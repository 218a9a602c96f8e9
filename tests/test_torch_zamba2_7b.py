"""The port-only Zamba2 family (``zamba2-7b``, ``models/model.py``'s
``zamba2``) and the grouped Mamba-2 it runs, on the CPU at small sizes.

* the registry: ``get_config`` and ``get_smoke_config`` resolve
  zamba2-7b, ``ARCH_IDS`` stays the reference's ten; the parameter
  count at full size (7,356,749,648) and at the benchmark's cut to 7
  layers (1,014,709,808); a block no hybrid layer uses is not held;
* the grouped SSD: with G = 2 each group's heads against the one-group
  code run on those heads alone (the same arithmetic: bitwise), and
  the chunked form against the exact scan at seq 256 (two chunks of
  128), forward and gradients, within CHUNK_TOL as
  ``tests/test_torch_mamba2.py``'s chunked forms;
* ``decode_step`` token by token against ``forward_train``'s logits
  (the Mamba-2 states and the shared blocks' caches, block 0 used
  twice), within 1e-5 (1 + |logit|);
* the spans ``model/mamba``, ``model/ssd``, ``model/shared`` and the
  counter ``model/ssd_chunks`` in an eager pass, under a
  ``SpanRecorder`` and under the profiler;
* the train CLI (q8 ring over two positions, ``--trace``) and the serve
  CLI with ``--arch zamba2-7b --smoke``.

The port against the benchmark's plain reference, and the reference
against transformers' Zamba2, are ``perfbench/test_perfbench_zamba2.py``.
"""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as M
from repro_torch.spans import SpanRecorder, recording

ARCH = "zamba2-7b"
CHUNK_TOL = 5e-5
DECODE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smoke(**kw):
    return get_smoke_config(ARCH).with_(dtype="float32", **kw)


def _params(cfg, seed=0):
    return M.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")


def test_registry_and_counts():
    cfg = get_config(ARCH)
    assert ARCH not in ARCH_IDS and len(ARCH_IDS) == 10
    assert cfg.arch_type == "zamba2" and cfg.mamba_ngroups == 2
    assert M.count_params_analytic(cfg) == 7_356_749_648
    cut = cfg.with_(n_layers=7, hybrid_layer_ids=(6,))
    assert M.count_params_analytic(cut) == 1_014_709_808
    # the cut holds block 0 only
    shapes = dict((p, s) for p, s, _ in M.param_specs(cut))
    assert shapes["shared_blocks/attn/wq"] == (1, 7168, 7168)
    assert shapes["hybrid_blocks/linear"] == (1, 3584, 3584)
    assert shapes["blocks/m2/w_in"] == (7, 3584, 2 * 7168 + 2 * 2 * 64 + 112)
    assert get_smoke_config(ARCH).hybrid_layer_ids == (1, 3, 5)
    with pytest.raises(ValueError, match="zamba2-7b"):
        get_config("zamba2-9b")


def _ssd_inputs(b=2, t=256, h=8, p=16, n=8, g=2, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=gen)

    x, bt, ct = rnd(b, t, h, p), rnd(b, t, g, n), rnd(b, t, g, n)
    dt = torch.nn.functional.softplus(rnd(b, t, h) - 3.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    return x, bt, ct, dt, a_log, torch.ones(h), torch.zeros(b, h, n, p)


@pytest.mark.parametrize("form", ["scan", "chunked"])
def test_each_group_reads_its_own_heads(form):
    """Heads h // (H/G) == j of the G-group SSD are the one-group SSD of
    those heads over group j's B and C."""
    x, bt, ct, dt, a_log, d, s0 = _ssd_inputs()
    run = M2._ssd_scan if form == "scan" else M2._ssd_chunked
    y, s = run(x, bt, ct, dt, a_log, d, s0)
    hg = x.shape[2] // bt.shape[2]
    for j in range(bt.shape[2]):
        sl = slice(j * hg, (j + 1) * hg)
        yj, sj = run(x[:, :, sl], bt[:, :, j], ct[:, :, j], dt[:, :, sl],
                     a_log[sl], d[sl], s0[:, sl])
        assert torch.allclose(y[:, :, sl], yj, rtol=0, atol=1e-6)
        assert torch.allclose(s[:, sl], sj, rtol=0, atol=1e-6)


def test_grouped_chunked_matches_scan_with_gradients():
    x, bt, ct, dt, a_log, d, s0 = _ssd_inputs(t=256)
    outs = []
    for run in (M2._ssd_scan, M2._ssd_chunked):
        leaves = [t.clone().requires_grad_(True) for t in (x, bt, ct, dt)]
        y, s = run(*leaves, a_log, d, s0)
        (y.square().sum() + s.square().sum()).backward()
        outs.append((y.detach(), s.detach(), [t.grad for t in leaves]))
    (y0, s0_, g0), (y1, s1, g1) = outs
    assert torch.allclose(y1, y0, rtol=0, atol=CHUNK_TOL * (1 + y0.abs().max()))
    assert torch.allclose(s1, s0_, rtol=0,
                          atol=CHUNK_TOL * (1 + s0_.abs().max()))
    for a, b in zip(g1, g0):
        assert torch.allclose(a, b, rtol=0, atol=CHUNK_TOL * (1 + b.abs().max()))


def test_model_takes_the_chunked_form_at_256():
    """The smoke model at seq 256 runs the chunked scan (its chunks
    counted), and its loss agrees with the exact scan's."""
    cfg = _smoke()
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256),
                           generator=torch.Generator().manual_seed(1))
    rec = SpanRecorder()
    with recording(rec):
        chunked, _ = M.train_loss(params, cfg, {"tokens": tokens})
    assert rec.snapshot()["model/ssd_chunks"]["count"] == 6 * 2
    chunk = M2.CHUNK
    try:
        M2.CHUNK = 10**9                      # never chunked
        exact, _ = M.train_loss(params, cfg, {"tokens": tokens})
    finally:
        M2.CHUNK = chunk
    assert abs(float(chunked) - float(exact)) <= 1e-5 * abs(float(exact))


def test_decode_matches_forward():
    cfg = _smoke()
    params = _params(cfg, seed=3)
    b, s = 2, 12
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(4))
    want, _ = M.forward_train(params, cfg, {"tokens": tokens})
    state = M.make_decode_state(cfg, b, s, "cpu")
    assert state["hybrid_blocks/kv/k"].shape == (3, b, s, cfg.n_kv_heads,
                                                 cfg.head_dim)
    assert state["blocks/ssm"].shape[0] == cfg.n_layers - 3
    got = []
    for t in range(s):
        logits, state = M.decode_step(params, cfg, tokens[:, t:t + 1], state,
                                      t)
        got.append(logits)
    got = torch.cat(got, 1)
    assert torch.all((got - want).abs() <= DECODE_TOL * (1 + want.abs()))


def test_spans_and_counters_in_an_eager_pass():
    cfg = _smoke()
    params = {k: v.requires_grad_(True) for k, v in _params(cfg).items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, 128),
                           generator=torch.Generator().manual_seed(2))
    rec = SpanRecorder()
    with recording(rec):
        loss, _ = M.train_loss(params, cfg, {"tokens": tokens})
    snap = rec.snapshot()
    assert snap["model/mamba"]["count"] == 6
    assert snap["model/ssd"]["count"] == 6
    assert snap["model/ssd"]["parent"] == "model/mamba"
    assert snap["model/shared"]["count"] == 3          # the uses
    assert snap["model/ssd_chunks"]["count"] == 6      # one chunk a layer
    assert snap["model/ssd_chunks"]["total_s"] == 0.0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        M.train_loss(params, cfg, {"tokens": tokens})
    names = {e.key for e in prof.key_averages()}
    assert {"model/mamba", "model/ssd", "model/shared"} <= names


def test_block_not_used_is_not_held():
    cfg = _smoke(n_layers=2, hybrid_layer_ids=(1,))
    paths = M.leaf_paths(cfg)
    shapes = dict((p, s) for p, s, _ in M.param_specs(cfg))
    assert shapes["shared_blocks/attn/wq"][0] == 1
    assert shapes["hybrid_blocks/linear"][0] == 1
    assert "shared_attn/attn/wq" not in paths
    loss, _ = M.train_loss(_params(cfg), cfg, {"tokens": torch.zeros(
        (1, 8), dtype=torch.int64)})
    assert torch.isfinite(loss)


def test_train_and_serve_cli(capsys):
    from repro_torch.launch import serve, train

    train.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "16", "--device", "cpu", "--mesh-data", "2",
                "--comm-mode", "q8_ring_fused", "--compressor", "q8_block",
                "--trace"])
    out = capsys.readouterr().out
    assert "step    1" in out and "model/shared" in out
    assert "model/ssd_chunks" not in out      # seq 16: the exact scan
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen-len", "4"])
    assert "zamba2-7b: 14 tokens" in capsys.readouterr().out
