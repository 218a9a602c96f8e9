"""Port parity: the tune cost model (``repro_torch.tune.model``) and its
measurements (``repro_torch.tune.measure``) against the reference's, on
the smoke configs, in-process.

* ``TUNABLE_MODES`` is the reference's tuple; ``predicted_wire_bits``
  exactly the reference's for every mode in it (W = 4 worker-stacked
  qwen3-0.6b smoke leaves); ``extra_wire_bits`` exactly the reference's
  over the qwen2-moe-a2.7b smoke moe, act and model wires for every wire
  flag.
* ``n_buckets``, ``comm_time_s``, ``encode_time_s``, ``compose_step_s``
  and ``predict_step`` under one fixed ``LinkModel`` and
  ``DeviceRates``, over the reference's bucket grid and two small
  budgets, within 1e-12 relative (the same float64 arithmetic); the
  fused mode charges zero encode.  ``Candidate`` rejects what the
  reference rejects, with its message, and labels alike.
* ``fit_alpha_beta`` and ``measure_subtree`` equal the reference's;
  ``calibrate_link``, ``calibrate_rates``, ``measure_overlap_hide`` and
  ``measure_omega`` give finite, in-range values on the CPU with
  ``iters=1`` and caps of a few KiB (their times are the CPU's, and
  nothing here reads them as a device's).
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.comm import SimChannel as JaxSim
from repro.comm import build_transport as jax_build_transport
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.models import model as JM
from repro.tune import measure as RM
from repro.tune import model as RT
from repro.tune.search import DEFAULT_BUCKET_GRID
from repro_torch import tune as T
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.transport import WIRE_CODEC_FLAGS, build_transport
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import ShapeDtype, make_compressor
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.model import param_specs

W = 4
RTOL = 1e-12
GRID = DEFAULT_BUCKET_GRID + (4096, 16384)
META = torch.device("meta")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny work: one intra-op thread, so that test processes running
    side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _likes(arch, w):
    cfg_j = jax_smoke(arch).with_(dtype="float32")
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params_j = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = {p: ShapeDtype(tuple(s), torch.float32, META)
              for p, s, _ in param_specs(cfg)}
    wlike_j = jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct((w, *p.shape), p.dtype), params_j)
    wlike = {k: ShapeDtype((w, *p.shape), p.dtype, META)
             for k, p in params.items()}
    return cfg_j, cfg, params_j, params, wlike_j, wlike


@pytest.fixture(scope="module")
def qwen():
    return _likes("qwen3-0.6b", W)


def _cands(mode, bucket=4 << 20):
    kw = dict(bucket_bytes=bucket, randk_q=0.1, q8_block_rows=32,
              compressor="topk" if mode in ("ef21", "efbv") else "natural",
              compressor_kwargs=(("q", 0.2),) if mode in ("ef21", "efbv")
              else ())
    return RT.Candidate(mode, **kw), T.Candidate(mode, **kw)


@pytest.fixture(scope="module")
def ref_bits(qwen):
    """The reference's ``predicted_wire_bits`` of every mode's candidate
    over the smoke leaves (each one ``jax.eval_shape`` a leaf: computed
    once, the bucket budget does not enter it)."""
    *_, wlike_j, _ = qwen
    return {mode: RT.predicted_wire_bits(_cands(mode)[0], wlike_j)
            for mode in RT.TUNABLE_MODES}


@pytest.fixture
def memo_ref_bits(monkeypatch, ref_bits):
    """The reference's model reading its own ``predicted_wire_bits`` from
    ``ref_bits`` (same candidates but for the bucket budget)."""
    real = RT.predicted_wire_bits

    def memo(cand, wtree_like):
        want = _cands(cand.comm_mode, cand.bucket_bytes)[0]
        if cand == want:
            return ref_bits[cand.comm_mode]
        return real(cand, wtree_like)

    monkeypatch.setattr(RT, "predicted_wire_bits", memo)


def test_tunable_modes_and_wire_bits_match_reference(qwen, ref_bits):
    *_, wlike = qwen
    assert T.TUNABLE_MODES == RT.TUNABLE_MODES
    assert "auto" not in T.TUNABLE_MODES
    assert T.OVERLAP_HIDE == RT.OVERLAP_HIDE
    for mode in T.TUNABLE_MODES:
        jc, tc = _cands(mode)
        assert type(T.wire_codec(tc)).__name__ == \
            type(RT.wire_codec(jc)).__name__, mode
        assert T.predicted_wire_bits(tc, wlike) == ref_bits[mode] > 0, mode
        assert (tc.overlap, tc.fused, tc.label) == (jc.overlap, jc.fused,
                                                    jc.label), mode


def test_extra_wire_bits_match_reference():
    cfg_j, cfg, params_j, params, *_ = _likes("qwen2-moe-a2.7b", 2)
    kw = dict(moe_wire="dense", act_wire="dense", model_wire="dense",
              publish_every=2)
    jt = jax_build_transport(JaxComp(**kw), cfg_j, JaxSim(), w=2,
                             params_like=params_j, tokens_per_worker=64)
    tt = build_transport(CompressionConfig(**kw), cfg, SimChannel(), w=2,
                         params_like=params, tokens_per_worker=64)
    jx, tx = jt.extra_traffic(), tt.extra_traffic()
    assert sorted(tx) == sorted(jx) == ["act", "model", "moe"]
    assert T.extra_wire_bits(T.Candidate("dense"), {}) == 0.0
    for flag in WIRE_CODEC_FLAGS:
        for wire in ("moe", "act", "model"):
            kw = {f"{wire}_wire": flag, "randk_q": 0.1}
            want = RT.extra_wire_bits(RT.Candidate("dense", **kw), jx)
            assert T.extra_wire_bits(T.Candidate("dense", **kw), tx) == \
                want > 0, (flag, wire)


def _close(a, b, what):
    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (what, a, b)


def test_comm_time_and_predict_step_match_reference(qwen, memo_ref_bits):
    *_, wlike_j, wlike = qwen
    jl, tl = RM.LinkModel(3e-6, 1 / 7e9), T.LinkModel(3e-6, 1 / 7e9)
    jr, tr = RM.DeviceRates(1e14, 2e12), T.DeviceRates(1e14, 2e12)
    analysis = {"flops": 3e9, "bytes": 4e8}
    for mode in T.TUNABLE_MODES:
        for bucket in GRID:
            jc, tc = _cands(mode, bucket)
            want = RT.comm_time_s(jc, wlike_j, jl, W)
            got = T.comm_time_s(tc, wlike, tl, W)
            assert got[2] == want[2], (mode, bucket)        # n_buckets
            for a, b in zip(got[:2], want[:2]):
                _close(a, b, (mode, bucket))
            _close(T.encode_time_s(tc, wlike, tr),
                   RT.encode_time_s(jc, wlike_j, jr), (mode, "encode"))
            for hide in (None, 0.3):
                p = T.predict_step(tc, wlike, tl, W, analysis=analysis,
                                   rates=tr, hide=hide)
                q = RT.predict_step(jc, wlike_j, jl, W, analysis=analysis,
                                    rates=jr, hide=hide)
                assert p.n_buckets == q.n_buckets
                assert p.candidate is tc
                for f in ("step_s", "compute_s", "comm_s", "wire_bytes",
                          "encode_s"):
                    _close(getattr(p, f), getattr(q, f), (mode, bucket, f))
    assert T.comm_time_s(_cands("q8_ring_overlap", 4096)[1], wlike, tl,
                         W)[2] > 1
    fused = _cands("q8_ring_fused_vjp")[1]
    assert T.encode_time_s(fused, wlike, tr) == 0.0
    assert T.predict_step(fused, wlike, tl, W, analysis=analysis,
                          rates=tr).encode_s == 0.0
    assert T.encode_time_s(_cands("q8_ring_fused")[1], wlike, tr) > 0.0
    assert T.compute_time_s(None, tr) == RT.compute_time_s(None, jr) == 0.0
    for args in ((1.0, 0.5, True, None), (1.0, 2.0, True, 0.2),
                 (1.0, 2.0, False, None)):
        assert T.compose_step_s(*args) == RT.compose_step_s(*args)


@pytest.mark.parametrize("kw", [dict(comm_mode="sim"), dict(comm_mode="auto"),
                                dict(comm_mode="bogus"),
                                dict(comm_mode="dense", moe_wire="int4"),
                                dict(comm_mode="dense", model_wire="q4")])
def test_candidate_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        RT.Candidate(**kw)
    with pytest.raises(ValueError) as got:
        T.Candidate(**kw)
    assert str(got.value) == str(want.value)


def test_fit_alpha_beta_and_measure_subtree_match_reference(qwen):
    *_, wlike_j, wlike = qwen
    for pts in ([(1.0, 2.0)], [(8.0, 1e-5), (8.0, 3e-5)],
                [(64.0, 1e-5), (4096.0, 2e-5), (1 << 20, 4e-4)],
                [(64.0, 5e-5), (4096.0, 1e-5)]):
        assert T.fit_alpha_beta(pts) == \
            T.LinkModel(**RM.fit_alpha_beta(pts).__dict__)
    for cap in (1, 4096, 1 << 16, 1 << 30):
        got = T.measure_subtree(wlike, cap)
        want = RM.measure_subtree(wlike_j, cap)
        assert list(got) == list(want), cap
        assert [tuple(v.shape) for v in got.values()] == \
            [tuple(v.shape) for v in want.values()], cap


def test_measurements_on_the_cpu(qwen):
    *_, wlike = qwen
    mesh = HostMesh(data=W, device="cpu")
    link = T.calibrate_link(mesh, wlike, iters=1, cap_bytes=4096)
    assert 0.0 <= link.alpha_s < 1.0 and 0.0 <= link.beta_s_per_byte < 1.0
    rates = T.calibrate_rates(n=64, iters=1, device="cpu")
    assert 0.0 < rates.flops_per_s < math.inf
    assert 0.0 < rates.hbm_bytes_per_s < math.inf
    assert torch.backends.cuda.matmul.allow_tf32 is False
    m = T.measure_overlap_hide(mesh, wlike, iters=1, cap_bytes=4096,
                               n_compute=32)
    assert 0.0 <= m.hide_fraction <= 1.0 and m.source == "measured"
    assert min(m.compute_s, m.comm_s, m.overlapped_s) > 0.0
    q8 = make_compressor("q8_block")
    om = T.measure_omega(q8, wlike, iters=1, cap_bytes=4096, device="cpu")
    sub = T.measure_subtree(wlike, 4096)
    assert om.n_leaves == len(sub)
    assert om.d_total == sum(math.prod(v.shape[1:]) for v in sub.values())
    assert 0.0 < om.omega_hat <= q8.omega(max(
        math.prod(v.shape[1:]) for v in sub.values()))
    assert 0.0 < om.nmse < 1e-2
    tree = T.synth_wtree(3, sub, device="cpu")
    assert [tuple(v.shape) for v in tree.values()] == \
        [tuple(v.shape) for v in sub.values()]
    assert T.time_fn(lambda: None, iters=1) >= 0.0
    for nominal in (T.LinkModel.nominal(), T.DeviceRates.nominal()):
        assert all(v > 0 for v in nominal.__dict__.values())
