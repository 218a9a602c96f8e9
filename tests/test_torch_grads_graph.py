"""The workers' passes as one CUDA graph (``dist.worker_grads``).

On the CPU, through the module's seam (``_graphable`` shown the params
as on the card, ``_warm`` and ``_capture`` patched: the first call runs
as it is, the "graph" records the passes' function and a replay runs it
again into the recorded outputs):

* which inputs take the graph and which stay eager: CPU params, meta
  params under the step's cost pass, a batch carrying the wires' draws
  (``wire_noise``) or the fused-VJP draws (``fused_draws``);
* a change of the key (the params' addresses, the batch's shapes and
  dtypes) runs eagerly and records anew on the call after;
* the cache goes with its ``loss_fn``;
* across two replays the returned ``loss`` and ``metrics`` are new
  tensors while the gradient buffers are the same;
* one worker's pass is recorded and replayed once a worker;
* three ``train_step``s through the reused buffers give bitwise the
  eager path's state.

On the card (``card`` marker, skipped where there is no CUDA device):
three steps graphed against three eager, bitwise, at the cells' sizes
and for every kind of pass; the wired and fused-VJP steps replay
nothing.  On the card::

    PYTHONPATH=src python -m pytest -m card tests/test_torch_grads_graph.py
"""

import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import CompressionConfig, TrainConfig
from repro_torch.dist import worker_grads as WG
from repro_torch.launch import hlo_cost as H
from repro_torch.launch import train as T
from repro_torch.launch.mesh import HostMesh
from repro_torch.spans import SpanRecorder, recording

META = torch.device("meta")


@pytest.fixture(scope="module")
def _bounded_jit_cache():
    """Overrides the suite's fixture, which clears JAX's caches after each
    module: this module compiles nothing with JAX, and the card's machine
    has none."""
    yield


@pytest.fixture
def card():
    """The CUDA device; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the seam ----------------------------------------------------------------


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _Recorded:
    """The CPU's stand-in for a CUDA graph: the recorded run and its
    outputs, which a replay runs it again into."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        _copy_into(self.out, self.run())


class _OnCard(torch.Tensor):
    """A tensor that reads as on the card, for ``_graphable`` on the CPU."""

    @property
    def is_cuda(self):
        return True


def _warm(run, device):
    return None, run()


def _capture(run, pool):
    out = run()
    return _Recorded(run, out), out


def _patch_seam(monkeypatch):
    graphable = WG._graphable
    monkeypatch.setattr(WG, "_graphable", lambda params, wbatch: graphable(
        {k: v.as_subclass(_OnCard) for k, v in params.items()}, wbatch))
    monkeypatch.setattr(WG, "_warm", _warm)
    monkeypatch.setattr(WG, "_capture", _capture)


@pytest.fixture
def seam(monkeypatch):
    """The graph path on the CPU."""
    _patch_seam(monkeypatch)


def _tiny(device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn((8, 6), generator=g),
              "b": torch.randn((6,), generator=g)}
    wbatch = {"x": torch.randn((3, 5, 8), generator=g)}
    return ({k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in wbatch.items()})


def _loss_fn():
    def loss_fn(p, batch):
        y = torch.tanh(batch["x"] @ p["a"] + p["b"])
        return (y * y).sum(), {"m": y.mean()}
    return loss_fn


def _kind(recorder: SpanRecorder, before: dict) -> str:
    """What the last call did: "capture" (and replay), "replay" or
    "eager", from the spans it opened."""
    now = {k: v["count"] for k, v in recorder.snapshot().items()}
    opened = {k for k, c in now.items() if c > before.get(k, 0)}
    if "grads/capture" in opened:
        assert "grads/replay" in opened
        return "capture"
    if "grads/replay" in opened:   # (the seam's replay runs the passes)
        return "replay"
    assert "grads/forward" in opened
    return "eager"


def _calls(loss_fn, inputs, wrap=None):
    """``per_worker_grads`` over ``inputs`` (a list of ``(params,
    wbatch)``), under ``wrap`` (a context for each call); the kind of
    each call."""
    rec, kinds = SpanRecorder(), []
    with recording(rec):
        for params, wbatch in inputs:
            before = {k: v["count"] for k, v in rec.snapshot().items()}
            if wrap is None:
                WG.per_worker_grads(loss_fn, params, wbatch)
            else:
                wrap(WG.per_worker_grads, loss_fn, params, wbatch)
            kinds.append(_kind(rec, before))
    return kinds


# -- which inputs take the graph ---------------------------------------------


def _x_loss_fn():
    """``_loss_fn`` reading only the batch's ``x``: a wired or fused-VJP
    batch carries per-worker draws beside it."""
    inner = _loss_fn()

    def loss_fn(p, batch):
        return inner(p, {"x": batch["x"]})
    return loss_fn


@pytest.mark.parametrize("case", ["cpu", "meta under the cost pass",
                                  "wire_noise", "fused_draws", "tensors"])
def test_which_inputs_take_the_graph(monkeypatch, case):
    loss_fn = _x_loss_fn()
    params, wbatch = _tiny()
    wrap = None
    if case != "cpu":
        _patch_seam(monkeypatch)
    if case == "meta under the cost pass":
        params = {k: torch.empty(v.shape, device=META)
                  for k, v in params.items()}
        wbatch = {k: torch.empty(v.shape, device=META)
                  for k, v in wbatch.items()}

        def wrap(fn, *args):
            return H.analyze(fn, *args)
    elif case in ("wire_noise", "fused_draws"):
        wbatch = dict(wbatch, **{case: [object() for _ in range(3)]})
    kinds = _calls(loss_fn, [(params, wbatch)] * 3, wrap)
    if case == "tensors":
        assert kinds == ["eager", "capture", "replay"]
        assert WG._GRAPHS[loss_fn].graph is not None
    else:
        assert kinds == ["eager"] * 3
        assert loss_fn not in WG._GRAPHS


def test_only_cuda_params_are_on_the_card():
    params, wbatch = _tiny()
    assert not WG._graphable(params, wbatch)
    assert not WG._graphable({k: torch.empty(v.shape, device=META)
                              for k, v in params.items()}, wbatch)
    assert WG._graphable({k: v.as_subclass(_OnCard)
                          for k, v in params.items()}, wbatch)


# -- the key -------------------------------------------------------------------


def test_a_new_key_records_anew(seam):
    loss_fn = _loss_fn()
    params, wbatch = _tiny()
    longer = {"x": torch.randn((3, 7, 8))}
    moved = {k: v.clone() for k, v in params.items()}     # other addresses
    f64 = ({k: v.double() for k, v in params.items()},
           {"x": wbatch["x"].double()})
    same_shape = {"x": torch.randn((3, 5, 8))}             # other values
    inputs = [(params, wbatch), (params, wbatch), (params, same_shape),
              (params, longer), (params, longer), (params, wbatch),
              (moved, wbatch), (moved, wbatch), (moved, wbatch),
              f64, f64]
    assert _calls(loss_fn, inputs) == [
        "eager", "capture", "replay", "eager", "capture", "eager",
        "eager", "capture", "replay", "eager", "capture"]


def test_a_replay_reads_the_new_batch_and_params(seam, monkeypatch):
    """The graph reads the params where they lie (updated in place) and the
    batch as copied into its static batch."""
    loss_fn = _loss_fn()
    params, wbatch = _tiny()
    for _ in range(2):
        WG.per_worker_grads(loss_fn, params, wbatch)
    _, other = _tiny(seed=1)
    for p in params.values():
        p.mul_(0.5)
    got = WG.per_worker_grads(loss_fn, params, other)
    with monkeypatch.context() as m:
        m.setattr(WG, "_graphable", lambda params, wbatch: False)
        want = WG.per_worker_grads(loss_fn, params, other)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2]["m"], want[2]["m"])


# -- lifetime ------------------------------------------------------------------


class _Held:
    """A stand-in graph that, as a CUDA graph, holds none of the Python
    objects of the run it records (``_Recorded`` holds the run, and with
    it the ``loss_fn`` its cache entry is keyed by); a replay changes
    nothing."""

    def replay(self):
        pass


def test_the_cache_goes_with_its_loss_fn(seam, monkeypatch):
    monkeypatch.setattr(WG, "_capture", lambda run, pool: (_Held(), run()))
    loss_fn = _loss_fn()
    params, wbatch = _tiny()
    for _ in range(3):
        WG.per_worker_grads(loss_fn, params, wbatch)
    assert WG._GRAPHS[loss_fn].graph is not None
    n, ref = len(WG._GRAPHS), weakref.ref(loss_fn)
    del loss_fn
    gc.collect()
    assert ref() is None
    assert len(WG._GRAPHS) == n - 1


def test_fresh_loss_and_metrics_reused_gradients(seam):
    loss_fn = _loss_fn()
    params, wbatch = _tiny()
    WG.per_worker_grads(loss_fn, params, wbatch)            # eager
    g1, loss1, m1 = WG.per_worker_grads(loss_fn, params, wbatch)
    first = {k: v.clone() for k, v in g1.items()}
    g1["extra"] = None                  # the caller's dict is its own
    _, other = _tiny(seed=1)
    g2, loss2, m2 = WG.per_worker_grads(loss_fn, params, other)
    assert "extra" not in g2
    for k in g2:
        assert g2[k] is g1[k]            # the graph's buffers, overwritten
        assert not torch.equal(g2[k], first[k]), k
    assert loss2 is not loss1 and loss2.data_ptr() != loss1.data_ptr()
    assert m2["m"].data_ptr() != m1["m"].data_ptr()
    assert loss1.item() != loss2.item()      # the first loss kept its value
    static = WG._GRAPHS[loss_fn].out
    assert loss1.data_ptr() != static[1].data_ptr()


# -- the step ------------------------------------------------------------------

STEP_CASES = {
    "dense q8_block": (dict(comm_mode="dense", compressor="q8_block"), 4),
    "dense natural": (dict(comm_mode="dense", compressor="natural"), 4),
    "q8_ring_fused": (dict(comm_mode="q8_ring_fused",
                           compressor="q8_block"), 2),
    "uncompressed": (dict(enabled=False), 4),
}


def _smoke_steps(case, batches):
    comp, w = STEP_CASES[case]
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=3, warmup_steps=1,
                       compression=CompressionConfig(**comp))
    state = T.init_state(0, cfg, tcfg, w, "cpu")
    step = T.build_train_step(cfg, tcfg, w, HostMesh(data=w, device="cpu"))
    rec, losses = SpanRecorder(), []
    with recording(rec):
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"])
    return state, losses, rec.snapshot()


def _state_leaves(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    for name, tree in (("h", state.h), ("h_bar", state.h_bar),
                       ("m", state.opt.m), ("v", state.opt.v)):
        out.update({f"{name}/{k}": v for k, v in (tree or {}).items()})
    out["bits"] = state.bits
    return out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_bitwise_the_eager_path(monkeypatch, case):
    cfg = get_smoke_config("qwen3-0.6b")
    g = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 32),
                                        generator=g)} for _ in range(3)]
    eager, eager_losses, spans = _smoke_steps(case, batches)
    assert "grads/replay" not in spans
    _patch_seam(monkeypatch)
    graphed, losses, spans = _smoke_steps(case, batches)
    assert spans["grads/capture"]["count"] == 1
    assert spans["grads/replay"]["count"] == 2
    want, got = _state_leaves(eager), _state_leaves(graphed)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(losses, eager_losses):
        assert torch.equal(a, b)


# -- on the card -----------------------------------------------------------------

#: (arch, depth or None, compression, W, batch, seq): the cells' passes
#: (qwen3 at both cells' sizes, deepseek's routed experts and MLA) and
#: the other families' (the WKV6 kernel inside the passes, Mamba-2)
CARD_CASES = {
    "qwen3-0.6b dense natural": (
        "qwen3-0.6b", None, dict(comm_mode="dense", compressor="natural"),
        4, 8, 128),
    "qwen3-0.6b q8_ring_fused s1024": (
        "qwen3-0.6b", None, dict(comm_mode="q8_ring_fused",
                                 compressor="q8_block"), 4, 4, 1024),
    "deepseek-v2-lite-16b 2l q8_ring_fused": (
        "deepseek-v2-lite-16b", 2, dict(comm_mode="q8_ring_fused",
                                        compressor="q8_block"), 2, 8, 128),
    "rwkv6-3b 2l dense": (
        "rwkv6-3b", 2, dict(comm_mode="dense", compressor="q8_block"),
        2, 4, 128),
    "zamba2-1.2b 6l q8_ring_fused": (
        "zamba2-1.2b", 6, dict(comm_mode="q8_ring_fused",
                               compressor="q8_block"), 2, 4, 128),
}


def _card_steps(cfg, comp, w, batches):
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=100, warmup_steps=10,
                       compression=CompressionConfig(shift_alpha=0.125,
                                                     **comp))
    torch.cuda.reset_peak_memory_stats()
    state = T.init_state(0, cfg, tcfg, w, "cuda")
    step = T.build_train_step(cfg, tcfg, w, HostMesh(data=w, device="cuda"))
    rec, losses = SpanRecorder(), []
    with recording(rec):
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"].item())
    torch.cuda.synchronize()
    mem = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
    return state, losses, rec.snapshot(), mem


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_graphed_steps_bitwise_eager_on_the_card(card, monkeypatch, case):
    arch, depth, comp, w, b, s = CARD_CASES[case]
    cfg = get_config(arch).with_(dtype="float32")
    if depth is not None:
        cfg = cfg.with_(n_layers=depth)
    g = torch.Generator().manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=g).to(card)}
               for _ in range(3)]
    with monkeypatch.context() as m:
        m.setattr(WG, "_graphable", lambda params, wbatch: False)
        state, want_losses, spans, mem = _card_steps(cfg, comp, w, batches)
    assert "grads/replay" not in spans
    want = {k: v.cpu() for k, v in _state_leaves(state).items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    state, losses, spans, mem_g = _card_steps(cfg, comp, w, batches)
    assert spans["grads/capture"]["count"] == 1
    assert spans["grads/replay"]["count"] == 2
    # step 1's W passes and the one recorded
    assert spans["grads/forward"]["count"] == w + 1
    print(f"{case}: peak allocated / reserved GiB, eager "
          f"{mem[0] / 2**30:.3f} / {mem[1] / 2**30:.3f}, graphed "
          f"{mem_g[0] / 2**30:.3f} / {mem_g[1] / 2**30:.3f}")
    got = _state_leaves(state)
    off = {}
    for k, v in want.items():
        x = got[k].cpu()
        if not torch.equal(x, v):
            off[k] = float((x.double() - v.double()).abs().max())
    assert not off, off
    assert losses == want_losses


#: steps whose batches carry per-round draws: the wires' and the fused
#: backward encode's
EAGER_CASES = {
    "deepseek-v2-lite-16b wires q8": (
        "deepseek-v2-lite-16b", dict(comm_mode="q8_ring_fused",
                                     compressor="q8_block", moe_wire="q8",
                                     act_wire="q8")),
    "qwen3-0.6b q8_ring_fused_vjp": (
        "qwen3-0.6b", dict(comm_mode="q8_ring_fused_vjp",
                           compressor="q8_block")),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_wired_and_fused_steps_replay_nothing(card, case):
    arch, comp = EAGER_CASES[case]
    cfg = get_smoke_config(arch).with_(dtype="float32")
    w = 2
    g = torch.Generator().manual_seed(6)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                        generator=g).to(card)}
               for _ in range(3)]
    _, losses, spans, _ = _card_steps(cfg, comp, w, batches)
    assert "grads/replay" not in spans and "grads/capture" not in spans
    assert spans["grads/forward"]["count"] == 3 * w
    assert all(x == x for x in losses)
