"""The port's continuous-batching engine (``repro_torch.serving.Engine``):
the seven contracts of the reference's ``tests/test_serving.py``, one
engine run against the reference's engine, and the serve CLI.

Greedy tokens are compared by the MARGIN RULE: a token must match
wherever the run it is held against chose it by a top-2 logit margin
above 2 TOL (1 + |top-1|), TOL = 1e-5 the decode tests' logit tolerance
(two sets of logits within TOL of each other cannot pick differently
there); at the first near tie where the two differ their trajectories
part, and the comparison stops (``_margin_rule``).  An engine serves a
request at other absolute positions and beside other rows, so its logits
differ from a request decoded alone by f32 rounding, not bitwise.  The
weights are the reference's (``params_from_jax``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.serving import Engine, Request
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5


def _setup(arch, seed):
    cfg_j = jax_smoke(arch).with_(dtype="float32")
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg, params_j, params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j))


@pytest.fixture(scope="module")
def dense_setup():
    return _setup("qwen3-0.6b", 0)


@pytest.fixture(scope="module")
def rwkv_setup():
    return _setup("rwkv6-3b", 1)


def _offline_greedy(cfg, params, prompt, n_new):
    """One request decoded alone: its tokens, and at each the top-2
    margin and |top-1| of the logits that chose it."""
    state = TM.make_decode_state(cfg, 1, 256, "cpu")
    out, margins, scales = [], [], []
    for t in range(len(prompt) + n_new - 1):
        cur = prompt[t] if t < len(prompt) else out[-1]
        logits, state = TM.decode_step(params, cfg, torch.tensor([[cur]]),
                                       state, t)
        if t >= len(prompt) - 1:
            top = logits[0, -1].topk(2).values
            out.append(int(logits[0, -1].argmax()))
            margins.append(float(top[0] - top[1]))
            scales.append(float(top[0].abs()))
    return out, margins, scales


def _margin_rule(got, ref):
    """``got`` against ``ref`` = (tokens, margins, scales) by the margin
    rule; returns the number of tokens compared."""
    want, margins, scales = ref
    assert len(got) == len(want), (got, want)
    for t, (g, w) in enumerate(zip(got, want)):
        if g != w:
            assert margins[t] <= 2 * TOL * (1 + scales[t]), (t, got, want)
            return t
    return len(want)


def test_engine_single_request_matches_offline(dense_setup):
    _, cfg, _, params = dense_setup
    prompt = [5, 17, 99, 3]
    ref = _offline_greedy(cfg, params, prompt, 8)
    eng = Engine(cfg, params, max_batch=2, cache_len=64)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    done = eng.run()
    assert len(done) == 1
    _margin_rule(done[0].output, ref)


def test_engine_continuous_batching_isolation(dense_setup):
    """Requests admitted at different clock offsets into recycled slots
    each match their own offline decode (no KV leakage)."""
    _, cfg, _, params = dense_setup
    prompts = [[5, 17, 99], [42, 7], [123, 9, 11, 2], [88], [3, 1, 4, 1, 5]]
    refs = [_offline_greedy(cfg, params, p, 6) for p in prompts]
    eng = Engine(cfg, params, max_batch=2, cache_len=64)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert len(done) == len(prompts)
    for r, ref in zip(done, refs):
        _margin_rule(r.output, ref)


def test_engine_rwkv_state_isolation(rwkv_setup):
    """Recurrent state: slot reuse zeroes the previous request's state."""
    _, cfg, _, params = rwkv_setup
    prompts = [[5, 17, 99], [42, 7, 13], [123, 9]]
    refs = [_offline_greedy(cfg, params, p, 4) for p in prompts]
    eng = Engine(cfg, params, max_batch=1, cache_len=64)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    done = sorted(eng.run(), key=lambda r: r.uid)
    for r, ref in zip(done, refs):
        _margin_rule(r.output, ref)


def test_engine_eos_stops_early(dense_setup):
    _, cfg, _, params = dense_setup
    first = _offline_greedy(cfg, params, [5, 17], 1)[0][0]
    eng = Engine(cfg, params, max_batch=1, cache_len=64)
    eng.submit(Request(uid=0, prompt=[5, 17], max_new_tokens=50,
                       eos_id=first))
    assert eng.run()[0].output == [first]


def test_engine_eos_in_prompt_ignored_during_prefill(dense_setup):
    """An EOS id inside the prompt does not end the request while the
    prompt is fed: only GENERATED tokens are checked against it."""
    _, cfg, _, params = dense_setup
    prompt = [5, 17, 99, 3]
    ref = _offline_greedy(cfg, params, prompt, 6)
    eos = prompt[1]
    assert eos not in ref[0]
    eng = Engine(cfg, params, max_batch=2, cache_len=64)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=6, eos_id=eos))
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 6
    _margin_rule(done[0].output, ref)


def test_engine_admit_into_just_freed_slot(dense_setup):
    """Submission into a slot freed the SAME tick, through step_tick: the
    new request sees an invalidated cache, not the old occupant's."""
    _, cfg, _, params = dense_setup
    a, b = [5, 17, 99], [42, 7, 13]
    ref_b = _offline_greedy(cfg, params, b, 6)
    eng = Engine(cfg, params, max_batch=1, cache_len=64)
    eng.submit(Request(uid=0, prompt=a, max_new_tokens=4))
    done = []
    for _ in range(100):
        done.extend(eng.step_tick())
        if done:
            break
    assert done and done[0].uid == 0
    eng.submit(Request(uid=1, prompt=b, max_new_tokens=6))
    for _ in range(100):
        done.extend(eng.step_tick())
        if len(done) == 2:
            break
    assert done[1].uid == 1
    _margin_rule(done[1].output, ref_b)


def test_engine_recurrent_slot_zeroed_on_admit(rwkv_setup):
    """Admitting into a reused slot zeroes that slot's recurrent state IN
    PLACE (the same tensors, no host copy) and leaves the other row's
    state alone; back-to-back requests each match offline decode.  (The
    reference pins this on Mamba-2, which the port does not have yet; its
    recurrent family is RWKV-6.)"""
    _, cfg, _, params = rwkv_setup
    eng = Engine(cfg, params, max_batch=2, cache_len=64)
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    eng.submit(Request(uid=0, prompt=[5, 17, 99], max_new_tokens=3))
    eng.submit(Request(uid=1, prompt=[42, 7, 13, 8, 1], max_new_tokens=8))
    done = []
    while not done:
        done.extend(eng.step_tick())
    assert done[0].uid == 0
    other = {k: v[:, 1].clone() for k, v in eng.state.items()}
    assert all(bool(v[:, 0].ne(0).any()) for v in eng.state.values())
    eng.submit(Request(uid=2, prompt=[123, 9], max_new_tokens=4))
    eng._admit()
    for k, v in eng.state.items():
        assert v.data_ptr() == ptrs[k], k
        assert bool((v[:, 0] == 0).all()), k
        assert torch.equal(v[:, 1], other[k]), k
    done.extend(eng.run())
    by_uid = {r.uid: r for r in done}
    for uid, prompt, n in [(0, [5, 17, 99], 3), (1, [42, 7, 13, 8, 1], 8),
                           (2, [123, 9], 4)]:
        _margin_rule(by_uid[uid].output,
                     _offline_greedy(cfg, params, prompt, n))


def test_engine_matches_reference_engine(dense_setup):
    """One run of the port's engine against the reference's on the same
    weights and requests: every output by the margin rule against the
    request decoded alone, and the two engines' outputs against each
    other up to the first near tie."""
    cfg_j, cfg, params_j, params = dense_setup
    prompts = [[5, 17, 99], [42, 7], [123, 9, 11, 2], [88, 3]]
    ej = JaxEngine(cfg_j, params_j, max_batch=2, cache_len=32)
    et = Engine(cfg, params, max_batch=2, cache_len=32)
    for i, p in enumerate(prompts):
        ej.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=5))
        et.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    dj = sorted(ej.run(), key=lambda r: r.uid)
    dt = sorted(et.run(), key=lambda r: r.uid)
    assert [r.uid for r in dt] == [r.uid for r in dj] == [0, 1, 2, 3]
    assert et.clock == ej.clock
    for rj, rt, p in zip(dj, dt, prompts):
        ref = _offline_greedy(cfg, params, p, 5)
        n = min(_margin_rule(rt.output, ref), _margin_rule(rj.output, ref))
        assert rt.output[:n] == rj.output[:n]


# -- the CLI -----------------------------------------------------------------


def test_serve_cli_greedy_on_cpu(capsys):
    res = serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen-len", "8"])
    assert tuple(res.tokens.shape) == (2, 13)
    assert res.bits == 32.0 * sum(p.numel() for p in res.params.values())
    assert "tok/s" in capsys.readouterr().out


def test_serve_cli_fleet_on_cpu(capsys):
    stats = serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--gen-len", "8",
                        "--serve_fleet", "2"])
    assert stats["requests_done"] == 4 and stats["tokens_served"] == 32
    assert stats["delta_bytes_per_publish"] == 361268.0
    assert "fleet[2x qwen3-0.6b]" in capsys.readouterr().out


def test_serve_cli_without_device_raises_on_a_cpu_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])
