"""Port parity: observability (``repro_torch.obs``), the Wire's measured
surfaces (``comm.transport``), the stamped overlap channel and the
trainer's ``--metrics_out`` / ``--trace`` -- against the reference,
in-process, on the same numpy-seeded inputs.

* Records: ``step_record``, ``run_record``, ``summary_record``,
  ``event_record`` and the typed metrics dict-equal to the reference's;
  a JSONL written by either side's ``JsonlSink`` (rotation included) is
  byte-equal and passes both sides' ``check_jsonl``/``validate_record``;
  ``summarize``, ``summary_table`` and ``prometheus_text`` give equal
  strings; ``history``'s flattening and fingerprints and ``regress``'s
  classes, comparisons, frozen baselines and gate (exit codes 0/1/2) are
  equal on ``experiments/obs/baseline.json`` and a synthetic
  ``BENCH_*.json`` in ``tmp_path``.
* Quality: ``array_distortion`` and ``tree_distortion`` for Identity,
  ``q8_block``, ``natural``, ``randk``, ``topk`` and ``int8`` over the
  smoke qwen3-0.6b leaves (W = 2), the reference's draws replayed by
  address: payloads bitwise, ``err_sq``, ``norm_sq``, ``omega_hat`` and
  ``nmse`` within 1e-6 relative (f32 sums in another order).
* Wires: for qwen2-moe-a2.7b smoke with the moe, act and model wires
  q8, ``obs_snapshot`` has the reference's keys, ``wire_bits``,
  ``payload_bytes`` and ``fused``; its measured timings and quality are
  finite; a fused grad wire reports exact zeros.
* ``AsyncChannel(obs=StampRecorder())``: its rounds bitwise the rounds
  with ``obs=None``.
* Trainer: ``main([... --metrics_out f --trace])`` on the CPU leaves a
  state bitwise the run without the flags (which imports no obs);
  its records' kinds, names and ``data`` keys are those of the
  reference trainer's record calls, its ``drift_resync`` events fall on
  the steps the reference's ``resync_h_bar`` resyncs, and the JSONL
  passes both sides' ``check_jsonl`` and the port's ``export --check``.
"""

import ast
import inspect
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as R
from repro.comm import SimChannel as JaxSim
from repro.comm import build_transport as jax_build_transport
from repro.comm.wire import encode_decode_workers as jax_enc_dec
from repro.comm.wire import leaf_key, worker_keys
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.core import compressors as JC
from repro.models import model as JM
from repro.obs import export as R_export
from repro.obs import history as R_history
from repro.obs import quality as R_quality
from repro.obs import regress as R_regress
from repro_torch import obs as P
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.overlap import AsyncChannel
from repro_torch.comm.transport import build_transport
from repro_torch.comm.wire import AddressedNoise, LeafNoise
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig
from repro_torch.core import compressors as TC
from repro_torch.core.compressors import ShapeDtype
from repro_torch.core.shift_rules import make_shift_rule
from repro_torch.launch import train as T
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.model import param_specs
from repro_torch.obs import export as P_export
from repro_torch.obs import history as P_history
from repro_torch.obs import quality as P_quality
from repro_torch.obs import regress as P_regress
from repro_torch.obs.trace import StampRecorder

RTOL = 1e-6        # f32 sums of squares in another order
W = 2
BASELINE = "experiments/obs/baseline.json"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny smoke work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- records, typed metrics, sinks --------------------------------------------


def _records(mod):
    return [
        mod.run_record("train", arch="qwen3-0.6b", workers=4,
                       wires={"grad": {"wire_bits": 8.0, "payload_bytes": 1.0,
                                       "encode_s": 2e-5, "decode_s": None,
                                       "omega_hat": 1e-4, "nmse": 1e-4}},
                       hide_fraction=0.25, hide_source="measured",
                       omega=float("inf"), omega_source="analytic",
                       predicted_step_s=0.01),
        mod.step_record(0, loss=6.5, bits=np.float32(8.0), step_s=0.02,
                        predicted_step_s=0.01, shift_residual_sq=2.0,
                        grad_sq=4.0, h_bar_drift=None),
        mod.event_record("drift_resync", 0, every=1),
        mod.step_record(1, run="r", loss=float("nan"), bits=16.0,
                        step_s=0.03, predicted_step_s=0.01,
                        shift_residual_sq=1.0, grad_sq=4.0),
        mod.event_record("publish", 1, bytes=123, stale=[1, 2]),
        mod.summary_record("train", spans={"host/step": {
            "count": 2, "total_s": 0.05, "mean_s": 0.025}}),
    ]


def _typed(mod):
    m = mod.Metrics()
    m.counter("resyncs").inc()
    m.counter("resyncs").inc(2)
    m.gauge("hide").set(0.5)
    m.gauge("never")
    for x in (0.3, float("inf"), 0.1, 0.2):
        m.histogram("step_s").observe(x)
    m.histogram("empty")
    return m.snapshot()


def test_records_and_typed_metrics_equal_reference():
    assert P.__all__ == R.__all__
    assert P.SCHEMA_VERSION == R.SCHEMA_VERSION
    assert P.RECORD_KINDS == R.RECORD_KINDS
    assert _records(P) == _records(R)
    assert _typed(P) == _typed(R)
    with pytest.raises(ValueError) as a:
        P.Counter().inc(-1)
    with pytest.raises(ValueError) as b:
        R.Counter().inc(-1)
    assert str(a.value) == str(b.value)
    m = P.Metrics()
    m.counter("x")
    with pytest.raises(ValueError, match="already registered as Counter"):
        m.gauge("x")
    # torch scalars sanitize like numpy's
    assert P.step_record(0, loss=torch.tensor(1.5))["data"]["loss"] == 1.5


def _write(mod, path, recs, rotate):
    sink = mod.JsonlSink(str(path), rotate_bytes=rotate, keep=2)
    for r in recs:
        sink.emit(r)
    sink.close()


def test_jsonl_sinks_byte_equal_and_cross_validated(tmp_path):
    """Each side's rotating sink writes the same bytes in the same
    generations, and each side's checker accepts the other's files."""
    recs = _records(R) * 3
    _write(P, tmp_path / "port.jsonl", recs, 700)
    _write(R, tmp_path / "ref.jsonl", recs, 700)
    for suffix in ("", ".1", ".2"):
        port, ref = (tmp_path / f"port.jsonl{suffix}",
                     tmp_path / f"ref.jsonl{suffix}")
        assert port.read_bytes() == ref.read_bytes(), suffix
        assert port.stat().st_size > 0
    assert not (tmp_path / "port.jsonl.3").exists()
    for checker in (P.check_jsonl, R.check_jsonl):
        for name in ("port.jsonl", "port.jsonl.1", "ref.jsonl.1"):
            n, errors = checker(str(tmp_path / name))
            assert n > 0 and errors == [], (name, errors)
    for rec in P.read_jsonl(str(tmp_path / "ref.jsonl.2")):
        R.validate_record(rec)
        P.validate_record(rec)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "step"}\nnot json\n'
                   '{"v": 2, "kind": "run", "run": "x", "data": {}}\n')
    assert P.check_jsonl(str(bad)) == R.check_jsonl(str(bad))
    assert P_export.main(["--check", str(bad)]) == 1
    assert P_export.main(["--check", str(tmp_path / "port.jsonl")]) == 0
    P.write_strict_json(str(tmp_path / "a.json"), {"x": float("inf")})
    R.write_strict_json(str(tmp_path / "b.json"), {"x": float("inf")})
    assert (tmp_path / "a.json").read_bytes() == (
        tmp_path / "b.json").read_bytes()


def test_exports_equal_reference():
    recs = _records(R)
    assert P.summarize(recs) == R.summarize(recs)
    assert P.summary_table(recs, name="x") == R.summary_table(recs, name="x")
    assert P.prometheus_text(recs, name='r"1') == R.prometheus_text(
        recs, name='r"1')
    assert P.format_table("t", ["a", "b"], [(1, 2)]) == R.format_table(
        "t", ["a", "b"], [(1, 2)])


def _unflatten(metrics):
    """A nested payload whose ``flatten_metrics`` is ``metrics`` (list
    indices become dict keys ``name[i]``: the flattening is the same)."""
    out = {}
    for path, v in metrics.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def test_history_and_regress_equal_reference(tmp_path):
    base = P_regress.load_baseline(BASELINE)
    assert base == R_regress.load_baseline(BASELINE)
    moe = base["artifacts"]["BENCH_moe_wire.json"]["metrics"]
    payload = dict(_unflatten(moe), arch="qwen2-moe-a2.7b", smoke=True,
                   wall_s=1.5, rows=[{"mode": "q8", "bytes": 3.0}, 2.5])
    assert P_history.flatten_metrics(payload) == \
        R_history.flatten_metrics(payload)
    assert P_history.config_fingerprint("B.json", payload) == \
        R_history.config_fingerprint("B.json", payload)
    names = sorted({k for a in base["artifacts"].values()
                    for k in a["metrics"]} | set(P_history.flatten_metrics(
                        payload)) | {"x.time_ms", "s", "n_leaves[3]"})
    assert [P_regress.classify(n) for n in names] == \
        [R_regress.classify(n) for n in names]

    good = tmp_path / "BENCH_moe_wire.json"
    good.write_text(json.dumps(payload))
    recs = P_history.ingest([str(good)], str(tmp_path / "hp.jsonl"),
                            sha="abc")
    assert recs == R_history.ingest([str(good)], str(tmp_path / "hr.jsonl"),
                                    sha="abc")
    assert P_history.latest_by_artifact(P_history.load_history(
        str(tmp_path / "hr.jsonl"))) == R_history.latest_by_artifact(
            R_history.load_history(str(tmp_path / "hp.jsonl")))
    for keep in (False, True):
        got = P_regress.freeze([str(good)], str(tmp_path / "fp.json"),
                               keep_timings=keep, sha="abc")
        assert got == R_regress.freeze([str(good)], str(tmp_path / "fr.json"),
                                       keep_timings=keep, sha="abc")
    cur = P_history.flatten_metrics(payload)
    off = {k: v * 1.05 for k, v in cur.items()}
    kw = dict(timing_rtol=0.15, structural_rtol=0.01, other_rtol=0.25)
    for c, b in ((cur, moe), (off, moe), ({}, moe), (cur, {"z": 0.0})):
        assert P_regress.compare_metrics(c, b, **kw) == \
            R_regress.compare_metrics(c, b, **kw)

    drift = dict(payload, **{"grad-only": dict(payload["grad-only"])})
    drift["grad-only"]["wire_bytes"] = {"grad": 2.0 * moe[
        "grad-only.wire_bytes.grad"]}
    bad = tmp_path / "drift" / "BENCH_moe_wire.json"
    bad.parent.mkdir()
    bad.write_text(json.dumps(drift))
    new = tmp_path / "BENCH_new.json"
    new.write_text(json.dumps({"a": 1.0}))
    for paths, inject, rc in (([good, new], 1.0, 0), ([bad], 1.0, 1)):
        paths = [str(p) for p in paths]
        got = P_regress.run_gate(base, paths, inject=inject)
        assert got == R_regress.run_gate(base, paths, inject=inject)
        assert bool(got["violations"]) == (rc == 1)
        assert P_regress.main(["--baseline", BASELINE, *paths]) == rc
    frozen = tmp_path / "timed.json"
    assert P_regress.main(["--freeze", str(frozen), "--keep-timings",
                           str(good)]) == 0
    assert P_regress.main(["--baseline", str(frozen), "--inject", "2",
                           str(good)]) == 1
    assert P_regress.main(["--baseline", BASELINE,
                           str(tmp_path / "missing.json")]) == 2
    (tmp_path / "v9.json").write_text(json.dumps({"version": 9}))
    assert P_regress.main(["--baseline", str(tmp_path / "v9.json"),
                           str(good)]) == 2


# -- quality --------------------------------------------------------------------


class _Recorder:
    """A noise source that records what the port asks for (zeros and the
    identity permutation as values)."""

    def __init__(self):
        self.asked = []

    def uniform(self, leaf, worker, shape, part=None):
        assert part is None
        self.asked.append(("u", leaf, worker, tuple(shape)))
        return torch.zeros(tuple(shape))

    def permutation(self, leaf, worker, d, part=None):
        assert part is None
        self.asked.append(("p", leaf, worker, d))
        return torch.arange(d)


class _Replay:
    """The reference's draws by address (``_reference_draws``)."""

    def __init__(self, drawn):
        self.drawn = drawn

    def uniform(self, leaf, worker, shape, part=None):
        return self.drawn[("u", leaf, worker, tuple(shape))]

    def permutation(self, leaf, worker, d, part=None):
        return self.drawn[("p", leaf, worker, d)]


def _reference_draws(key, asked, w):
    """The reference's draw at each address: leaf ``i`` of ``key`` is
    ``leaf_key(key, i)``, worker ``j``'s draw its ``worker_keys`` row (a
    codec with per-worker draws splits the leaf key), ``worker=None`` the
    leaf key itself; one jit, each kind and size of draw vmapped over
    its keys (bitwise the draws one by one; a uniform draw's bits depend
    on its size, not its shape, so draws of one size share a group)."""
    groups = {}
    for a in asked:
        size = a[3] if a[0] == "p" else math.prod(a[3])
        groups.setdefault((a[0], size), []).append(a)
    split = JC.NaturalCompression()       # stochastic, no shared pattern

    def draws(k):
        out = {}
        for (kind, arg), members in groups.items():
            keys = []
            for _, leaf, worker, _ in members:
                lk = leaf_key(k, leaf)
                keys.append(lk if worker is None
                            else worker_keys(split, lk, w)[worker])
            if kind == "u":
                fn = lambda kk, n=arg: jax.random.uniform(kk, (n,))  # noqa
            else:
                fn = lambda kk, n=arg: jax.random.permutation(kk, n)  # noqa
            out[(kind, arg)] = jax.vmap(fn)(jnp.stack(keys))
        return out

    vals = jax.jit(draws)(key)
    out = {}
    for g, members in groups.items():
        for i, m in enumerate(members):
            a = np.array(vals[g][i])
            out[m] = torch.from_numpy(a.reshape(m[3]) if m[0] == "u" else a)
    return out


def _by_index(p):
    """A sparse payload's entries in index order, row by row (the port's
    stacked top-k gives them so; the reference's in ``lax.top_k``'s
    order): the same payload as a set of (index, value) entries."""
    if not (isinstance(p, dict) and "indices" in p):
        return p
    idx = np.asarray(getattr(p["indices"], "data", p["indices"]))
    order = np.argsort(idx, axis=-1, kind="stable")
    return {"indices": np.take_along_axis(idx, order, -1),
            "values": np.take_along_axis(np.asarray(p["values"]), order, -1)}


def _payload_leaves(p):
    if isinstance(p, dict):
        return [x for k in sorted(p) for x in _payload_leaves(p[k])]
    if isinstance(p, (list, tuple)):
        return [x for v in p for x in _payload_leaves(v)]
    return [np.asarray(getattr(p, "data", p))]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


QUALITY_CODECS = [("identity", {}), ("q8_block", {}), ("natural", {}),
                  ("randk", {"q": 0.25}), ("topk", {"q": 0.25}),
                  ("int8", {})]


@pytest.fixture(scope="module")
def quality_inputs():
    """The smoke qwen3-0.6b leaves stacked over W workers (numpy-seeded),
    and the reference's draws at every address any of the codecs asks
    for (one jit for all of them: the int8 and natural codecs ask for
    the same uniforms)."""
    cfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    shapes = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda k: JM.init_params(k, cfg),
        jax.ShapeDtypeStruct((2,), jnp.uint32)))
    rng = np.random.default_rng(7)
    leaves = [(rng.standard_normal((W, *s.shape)) * 0.1).astype(np.float32)
              for s in shapes]
    tree = {str(i): torch.from_numpy(a) for i, a in enumerate(leaves)}
    key = jax.random.PRNGKey(5)
    asked = set()
    for name, kw in QUALITY_CODECS:
        rec = _Recorder()
        P_quality.tree_distortion(TC.make_compressor(name, **kw), rec, tree)
        asked.update(rec.asked)
    return leaves, tree, key, _Replay(_reference_draws(key, sorted(
        asked, key=repr), W))


def _reference_tree(jc, key, leaves):
    """The reference's jitted ``tree_distortion``, with each leaf's
    payload and ``array_distortion`` handed out of the same trace (its
    ``encode_decode_workers`` and ``array_distortion`` recorded as they
    run: one encode a leaf)."""
    import repro.comm.wire as RW

    enc_dec, per_leaf = RW.encode_decode_workers, R_quality.array_distortion

    def run(k, tr):
        payloads, outs = [], []

        def enc_dec_rec(codec, kk, leaf):
            payload, decoded = enc_dec(codec, kk, leaf)
            payloads.append(payload)
            return payload, decoded

        def per_leaf_rec(*args, **kw):
            outs.append(per_leaf(*args, **kw))
            return outs[-1]

        RW.encode_decode_workers = enc_dec_rec
        R_quality.array_distortion = per_leaf_rec
        try:
            return R_quality.tree_distortion(jc, k, tr), payloads, outs
        finally:
            RW.encode_decode_workers = enc_dec
            R_quality.array_distortion = per_leaf

    return jax.jit(run)(key, [jnp.asarray(a) for a in leaves])


@pytest.mark.parametrize("name,kw", QUALITY_CODECS,
                         ids=[n for n, _ in QUALITY_CODECS])
def test_quality_matches_reference(quality_inputs, name, kw):
    """Every leaf's payload bitwise and its ``array_distortion``, and the
    tree's ``tree_distortion``, within RTOL of the reference's jitted
    ones, the reference's draws replayed by address."""
    from repro_torch.comm.wire import encode_decode_workers

    leaves, tree, key, noise = quality_inputs
    jc, tc = JC.make_compressor(name, **kw), TC.make_compressor(name, **kw)
    ref_tree, ref_payloads, ref_outs = _reference_tree(jc, key, leaves)
    assert len(ref_payloads) == len(ref_outs) == len(leaves)
    for i, (ref_payload, ref_out) in enumerate(zip(ref_payloads, ref_outs)):
        payloads, _ = encode_decode_workers(tc, LeafNoise(noise, i),
                                            tree[str(i)])
        want = _payload_leaves(_by_index(ref_payload))
        if hasattr(tc, "encode_decode_stacked"):   # one stacked payload
            got = _payload_leaves(_by_index(payloads[0]))
        else:                                      # one a worker
            got = [np.stack(a) for a in zip(*map(_payload_leaves, payloads))]
        assert len(got) == len(want), i
        for g, w_ in zip(got, want):
            assert _same_bits(g, w_), f"{name} leaf {i} payload"
        out = P_quality.array_distortion(tc, LeafNoise(noise, i),
                                         tree[str(i)])
        for k in ("err_sq", "norm_sq"):
            np.testing.assert_allclose(float(out[k]), float(ref_out[k]),
                                       rtol=RTOL, err_msg=f"{name} {i} {k}")
    ref = R_quality.distortion_floats(ref_tree)
    got = P_quality.distortion_floats(P_quality.tree_distortion(
        tc, noise, tree))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=1e-30,
                                   err_msg=f"{name} {k}")
    if name == "identity":
        assert got["omega_hat"] == got["nmse"] == 0.0


def test_quality_forwarded_topology_and_empty():
    """A forwarded-payload wire encodes the block whole with the leaf's
    one draw (``worker=None``), as the reference's does."""
    x = np.random.default_rng(3).standard_normal((6, 40)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jc, tc = JC.make_compressor("int8"), TC.make_compressor("int8")
    ref = jax.jit(lambda k, a: R_quality.array_distortion(
        jc, k, a, topology="p2p"))(key, jnp.asarray(x))
    rec = _Recorder()
    P_quality.array_distortion(tc, LeafNoise(rec, 0), torch.from_numpy(x),
                               topology="p2p")
    assert [a[2] for a in rec.asked] == [None]
    # the leaf's own key: leaf_key is not applied by array_distortion
    drawn = {rec.asked[0]: torch.from_numpy(np.array(jax.random.uniform(
        key, rec.asked[0][3])))}
    got = P_quality.array_distortion(tc, LeafNoise(_Replay(drawn), 0),
                                     torch.from_numpy(x), topology="p2p")
    for k in ("err_sq", "norm_sq"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL)
    with pytest.raises(ValueError, match="empty tree"):
        P_quality.tree_distortion(tc, rec, {})


# -- the Wire's measured surfaces -------------------------------------------------

MOE = "qwen2-moe-a2.7b"


def _moe_transports(**flags):
    cfg_j = jax_smoke(MOE).with_(dtype="float32")
    cfg = get_smoke_config(MOE).with_(dtype="float32")
    like_j = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    like = {p: ShapeDtype(s, torch.float32, torch.device("meta"))
            for p, s, _ in param_specs(cfg)}
    kw = dict(moe_wire="q8", act_wire="q8", model_wire="q8",
              publish_every=2, **flags)
    jt = jax_build_transport(JaxComp(**kw), cfg_j, JaxSim(), w=W,
                             params_like=like_j, tokens_per_worker=64)
    tt = build_transport(CompressionConfig(**kw), cfg, SimChannel(), w=W,
                         params_like=like, tokens_per_worker=64)
    return jt, tt


def test_obs_snapshot_matches_reference():
    jt, tt = _moe_transports(comm_mode="q8_ring_fused", compressor="q8_block")
    want = jt.obs_snapshot()
    got = tt.obs_snapshot()
    assert got == want
    assert sorted(got) == ["act", "grad", "model", "moe"]
    timed = tt.obs_snapshot(timed=True, quality=True, device="cpu")
    for name, rec in timed.items():
        assert sorted(rec) == sorted(want[name])
        for k in ("wire_bits", "payload_bytes", "fused", "codec",
                  "topology"):
            assert rec[k] == want[name][k], (name, k)
        assert rec["encode_s"] > 0.0 and rec["decode_s"] > 0.0, name
        assert 0.0 < rec["omega_hat"] == rec["nmse"] < 1e-2, name
    assert sorted(tt.extra_traffic()) == sorted(jt.extra_traffic())
    for name, traffic in tt.extra_traffic().items():
        assert [(tuple(l.shape), c) for l, c in traffic] == [
            (tuple(s.shape), c) for s, c in jt.extra_traffic()[name]]
    P.validate_record(P.run_record("t", wires=timed))
    empty = build_transport(CompressionConfig(), None, SimChannel())["grad"]
    assert empty.codec_timings() == {"encode_s": None, "decode_s": None}
    assert empty.codec_quality() == {"omega_hat": None, "nmse": None}


@pytest.mark.parametrize("mode", ["q8_ring_overlap", "q8_ring_fused_vjp",
                                  "dense"])
def test_grad_wire_fused_and_hidden(mode):
    """``overlap_hidden`` and ``fused`` as the reference sets them; the
    fused grad wire's timings are exact zeros, its quality measured."""
    like_j = {"a": jax.ShapeDtypeStruct((40,), jnp.float32),
              "b": jax.ShapeDtypeStruct((3, 5), jnp.float32)}
    like = {k: ShapeDtype(v.shape, torch.float32, torch.device("meta"))
            for k, v in like_j.items()}
    kw = dict(comm_mode=mode, compressor="q8_block")
    jg = jax_build_transport(JaxComp(**kw), None, JaxSim(), w=4,
                             params_like=like_j)["grad"]
    tt = build_transport(CompressionConfig(**kw), None, SimChannel(), w=4,
                         params_like=like)
    tg = tt["grad"]
    assert (tg.overlap_hidden, tg.fused) == (jg.overlap_hidden, jg.fused)
    snap = tt.obs_snapshot(timed=True, quality=True, device="cpu")["grad"]
    if mode == "q8_ring_fused_vjp":
        assert snap["fused"] is True
        assert snap["encode_s"] == 0.0 and snap["decode_s"] == 0.0
        assert snap["omega_hat"] > 0.0
    else:
        assert snap["encode_s"] > 0.0


# -- the stamped overlap channel ------------------------------------------------


def test_async_channel_stamps_and_round_bitwise():
    rng = np.random.default_rng(4)
    shapes = {"a": (40,), "b": (3, 300), "c": ()}
    g = {k: torch.from_numpy((rng.standard_normal((4, *s)) * 0.1).astype(
        np.float32)) for k, s in shapes.items()}
    rule = make_shift_rule("diana", alpha=0.125)
    q = TC.make_compressor("q8_block")
    outs = []
    for obs in (StampRecorder(), None):
        ch = AsyncChannel(mode="q8_ring_fused", mesh=HostMesh(data=4),
                          bucket_bytes=1024, obs=obs)
        h = {k: torch.zeros_like(v) for k, v in g.items()}
        hb = {k: torch.zeros_like(v[0]) for k, v in g.items()}
        out = ch.shift_round(rule, q, AddressedNoise(9, "cpu"), g, h, hb)
        mean = ch.finish(ch.reduce_start(AddressedNoise(9, "cpu"), g))
        outs.append((out, {k: m.value() for k, m in mean.items()}))
        if obs is not None:
            assert [n for n, _, _ in obs.events] == ["reduce_start",
                                                     "finish"]
            assert obs.total("finish") >= 0.0
            assert len(obs.windows("reduce_start")) == 1
    (a, ma), (b, mb) = outs
    for x, y in zip(a[:3], b[:3]):
        for k in x:
            assert _same_bits(x[k].numpy(), y[k].numpy()), k
    assert float(a[3]) == float(b[3])
    for k in ma:
        assert _same_bits(ma[k].numpy(), mb[k].numpy()), k


# -- the trainer ------------------------------------------------------------------

RECORD_CALLS = ("run_record", "step_record", "event_record",
                "summary_record")


def reference_record_calls():
    """``{(kind, identity): sorted data keys}`` of every record the
    reference trainer's ``main`` emits, read off its record calls."""
    from repro.launch import train as RT

    out = {}
    for node in ast.walk(ast.parse(inspect.getsource(RT.main))):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr in RECORD_CALLS):
            first = node.args[0] if node.args else None
            ident = (first.value if isinstance(first, ast.Constant)
                     else None)
            out[(node.func.attr[:-len("_record")], ident)] = sorted(
                k.arg for k in node.keywords)
    return out


FLAGS = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
         "3", "--batch", "4", "--seq", "16", "--mesh-data", "2",
         "--comm-mode", "q8_ring_fused", "--compressor", "q8_block",
         "--drift-resync-every", "2"]


def _state_bits(state):
    out = {}
    for part in ("params", "h", "h_bar"):
        for k, v in getattr(state, part).items():
            out[f"{part}/{k}"] = v.numpy().tobytes()
    for k in state.opt.m:
        out[f"m/{k}"] = state.opt.m[k].numpy().tobytes()
        out[f"v/{k}"] = state.opt.v[k].numpy().tobytes()
    out["bits"] = state.bits.numpy().tobytes()
    return out


def test_trainer_metrics_out_and_trace(tmp_path, capsys):
    saved = {k: v for k, v in sys.modules.items()
             if k.startswith(("repro_torch.obs", "repro_torch.tune"))}
    for k in saved:
        del sys.modules[k]
    try:
        off = T.main(FLAGS)
        assert not any(k.startswith(("repro_torch.obs", "repro_torch.tune"))
                       for k in sys.modules)
    finally:
        sys.modules.update(saved)
    path = tmp_path / "run.jsonl"
    on = T.main(FLAGS + ["--metrics_out", str(path), "--trace"])
    assert _state_bits(on) == _state_bits(off)
    out = capsys.readouterr().out
    assert "## obs summary" in out and "## host spans" in out

    for checker in (P.check_jsonl, R.check_jsonl):
        n, errors = checker(str(path))
        assert (n, errors) == (6, [])
    assert P_export.main(["--check", str(path)]) == 0
    recs = P.read_jsonl(str(path))
    want = reference_record_calls()
    got = {}
    for r in recs:
        ident = r.get("run", r.get("name"))
        got.setdefault((r["kind"], ident), sorted(r["data"]))
        assert sorted(r["data"]) == got[(r["kind"], ident)]
    assert got == want
    ref_wires = jax_build_transport(
        JaxComp(comm_mode="q8_ring_fused", compressor="q8_block"), None,
        JaxSim()).obs_snapshot()
    run = recs[0]["data"]
    assert sorted(run["wires"]) == ["grad"]
    assert sorted(run["wires"]["grad"]) == sorted(ref_wires["grad"])
    assert run["workers"] == 2 and 0.0 <= run["hide_fraction"] <= 1.0
    assert run["predicted_step_s"] > 0.0
    steps = [r for r in recs if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert all(r["data"]["step_s"] > 0.0 for r in steps)

    from repro.comm import resync_h_bar as jax_resync

    h, hb = {"x": jnp.ones((2, 3))}, {"x": jnp.zeros(3)}
    resyncs = [i for i in range(3)
               if float(jax_resync(h, hb, i, 2)["x"][0]) == 1.0]
    events = [r["step"] for r in recs if r["kind"] == "event"]
    assert events == resyncs == [1]
    spans = recs[-1]["data"]["spans"]
    assert sorted(spans) == ["host/step"] and spans["host/step"]["count"] == 3
