"""Port parity: the tuner (``repro_torch.tune.plan``, ``tune.search``,
``tune.autotune``) and the trainer's ``--comm_mode auto`` against the
reference's, in-process, on the smoke configs.

* ``plan_fingerprint`` is the reference's hex digest, exactly, for the
  smoke qwen3, qwen2-moe and rwkv6 trees x two compressors x two search
  signatures (the reference's mesh a stub with ``axis_names`` and
  ``devices.shape``); the leaf order is pinned by a tree whose keys hold
  ``-`` and ``.``; a plan saved by either package loads in the other; the
  version and unknown-field errors are the reference's; a corrupt or
  mismatched cache file is a miss; ``apply_plan`` sets every knob.
* ``default_candidates`` equal for every mode subset and four codecs;
  ``estimate_omega`` / ``estimate_delta`` within 1e-12 relative;
  ``search_plan`` under one fixed link, rates and analysis: the same
  choice, knobs and row order, ``predicted_step_s`` within 1e-12
  relative (``verify_top=0``), and with an injected deterministic
  ``measure_fn`` and ``verify_top=2`` the same measured rows and winner;
  the wire grids' cross product; the ``omega_unavailable`` record.
* ``autotune``: a cache hit calls no supplier; a restricted-modes plan
  misses a full-grid lookup; the measured omega lands in a plan only on a
  miss.
* The trainer: ``--comm_mode auto`` searches, then hits the cache, and a
  ``--tune-plan`` run ends bitwise equal; ``--autotune`` with a concrete
  mode exits with the reference's message; ``--no-compression
  --comm_mode auto`` is the dense run.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as RT
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.models import model as JM
from repro_torch import tune as T
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import ShapeDtype
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import HostMesh

W = 2
RTOL = 1e-12
META = torch.device("meta")
ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "rwkv6-3b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke work: one intra-op thread, so that test processes running
    side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(mesh: HostMesh):
    """The reference's mesh as a stub: its fingerprint and worker count
    read ``axis_names`` and ``devices.shape`` only."""
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    return SimpleNamespace(axis_names=mesh.axis_names,
                           devices=np.empty(shape))


def _jax_params(arch):
    return jax.eval_shape(lambda k: JM.init_params(k, jax_smoke(arch)),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _jax_wlike(arch, w=W):
    return jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct((w, *p.shape), p.dtype),
        _jax_params(arch))


def _wlike(arch, w=W):
    return {k: ShapeDtype((w, *p.shape), p.dtype, META)
            for k, p in TR.params_like(get_smoke_config(arch)).items()}


def _comps(**kw):
    return CompressionConfig(**kw), JaxComp(**kw)


# -- plan -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fingerprint_is_the_reference_digest(arch):
    mesh = HostMesh(data=W, model=2, device=META)
    like = TR.params_like(get_smoke_config(arch))
    ref_like = _jax_params(arch)
    for compressor, kw in (("natural", ()), ("topk", (("k_frac", 0.1),))):
        for search in ({"modes": "all", "verify_top": 2},
                       {"modes": ("dense", "q8_ring"), "verify_top": 0,
                        "bucket_grid": (1 << 20,)}):
            got = T.plan_fingerprint(like, mesh, W, compressor, kw,
                                     search=search)
            want = RT.plan_fingerprint(ref_like, _jax_mesh(mesh), W,
                                       compressor, kw, search=search)
            assert got == want, (arch, compressor, search)
    assert T.plan_fingerprint(like, None, W, "natural") == \
        RT.plan_fingerprint(ref_like, None, W, "natural")


def test_fingerprint_leaf_order_is_the_nested_walk():
    """``-`` and ``.`` sort below ``/``: sorting the joined names would
    put ``a/b-c`` before ``a/b/x``; jax's nested walk does not."""
    shapes = {"a/b-c": (3,), "a/b/x": (5, 2), "a.b": (7,), "a/b/y.z": (1,)}
    flat = {k: ShapeDtype(s, torch.float32, META) for k, s in shapes.items()}
    nested = {"a": {"b-c": jax.ShapeDtypeStruct((3,), jnp.float32),
                    "b": {"x": jax.ShapeDtypeStruct((5, 2), jnp.float32),
                          "y.z": jax.ShapeDtypeStruct((1,), jnp.float32)}},
              "a.b": jax.ShapeDtypeStruct((7,), jnp.float32)}
    got = T.plan_fingerprint(flat, None, 1, "natural")
    assert got == RT.plan_fingerprint(nested, None, 1, "natural")
    by_name = {k: flat[k] for k in sorted(flat)}
    assert [tuple(v.shape) for v in by_name.values()] != [
        tuple(v.shape) for v in jax.tree_util.tree_leaves(nested)]
    # the nested form of the port's own input hashes the same
    nested_port = {"a": {"b-c": flat["a/b-c"],
                         "b": {"x": flat["a/b/x"], "y.z": flat["a/b/y.z"]}},
                   "a.b": flat["a.b"]}
    assert T.plan_fingerprint(nested_port, None, 1, "natural") == got


def _plan(mod, **kw):
    base = dict(fingerprint="ab" * 32, comm_mode="q8_ring_overlap",
                overlap_bucket_bytes=1 << 20, randk_q=0.01, q8_block_rows=32,
                efbv_eta=0.5, efbv_nu=0.75, predicted_step_s=1.5e-3,
                measured_step_s=float("nan"), moe_wire="q8", act_wire="none",
                model_wire="natural", hide_fraction=0.25,
                hide_source="measured", omega=0.125, omega_source="measured",
                candidates=({"label": "dense", "rank": 0,
                             "predicted_step_s": 2e-3,
                             "measured_step_s": None},))
    base.update(kw)
    return mod.TunePlan(**base)


def test_plan_files_load_in_either_package(tmp_path):
    for save, load in ((T.save_plan, RT.load_plan),
                       (RT.save_plan, T.load_plan)):
        path = str(tmp_path / f"{save.__module__}.json")
        save(_plan(T if save is T.save_plan else RT), path)
        text = open(path).read()
        assert "NaN" not in text and json.loads(text)["measured_step_s"] \
            is None
        got = load(path)
        want = _plan(RT if load is RT.load_plan else T,
                     measured_step_s=None)
        assert got.to_dict() == want.to_dict()
    # the two writers produce the same file
    a, b = (open(tmp_path / f"{f.__module__}.json").read()
            for f in (T.save_plan, RT.save_plan))
    assert a == b


def test_plan_dict_errors_are_the_reference(tmp_path):
    for bad in (dict(_plan(T).to_dict(), version=5),
                dict(_plan(T).to_dict(), surprise=1)):
        with pytest.raises(ValueError) as got:
            T.TunePlan.from_dict(bad)
        with pytest.raises(ValueError) as want:
            RT.TunePlan.from_dict(bad)
        assert str(got.value) == str(want.value)


def test_cache_misses_on_corrupt_or_mismatched_files(tmp_path):
    d = str(tmp_path)
    fp = "cd" * 32
    path = T.cache_path(d, fp)
    assert path == RT.cache_path(d, fp)
    assert T.load_cached_plan(d, fp) is None           # absent
    T.save_plan(_plan(T, fingerprint=fp), path)
    assert T.load_cached_plan(d, fp).fingerprint == fp
    T.save_plan(_plan(T, fingerprint="ef" * 32), path)  # copied elsewhere
    assert T.load_cached_plan(d, fp) is None
    for junk in ("{not json", json.dumps({"version": 6}),
                 json.dumps(dict(_plan(T).to_dict(), version=1))):
        with open(path, "w") as f:
            f.write(junk)
        assert T.load_cached_plan(d, fp) is None


def test_apply_plan_sets_every_knob():
    comp, jcomp = _comps(comm_mode="auto", compressor="topk")
    got = T.apply_plan(comp, _plan(T))
    want = RT.apply_plan(jcomp, _plan(RT))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for f in ("comm_mode", "overlap_bucket_bytes", "randk_q",
              "q8_block_rows", "efbv_eta", "efbv_nu", "moe_wire",
              "act_wire", "model_wire"):
        assert getattr(got, f) == getattr(_plan(T), f), f


# -- search -----------------------------------------------------------------

SUBSETS = [None] + [(m,) for m in T.TUNABLE_MODES] + [
    ("dense", "randk_shared", "q8_ring"), ("efbv", "efbv_overlap", "ef21"),
    ("q8_ring_fused", "q8_ring_overlap", "q8_ring_fused_vjp")]


@pytest.mark.parametrize("compressor", ["natural", "q8_block", "topk",
                                        "randk"])
def test_default_candidates_match(compressor):
    comp, jcomp = _comps(compressor=compressor, randk_q=0.2)
    wl, jwl = _wlike("qwen3-0.6b"), _jax_wlike("qwen3-0.6b")
    for modes in SUBSETS:
        got = T.default_candidates(comp, wl, modes=modes)
        want = RT.default_candidates(jcomp, jwl, modes=modes)
        assert [c.label for c in got] == [c.label for c in want], modes
        assert [dataclasses.asdict(c) for c in got] == \
            [dataclasses.asdict(c) for c in want], modes
    with pytest.raises(ValueError) as got_e:
        T.default_candidates(comp, wl, modes=("auto",))
    with pytest.raises(ValueError) as want_e:
        RT.default_candidates(jcomp, jwl, modes=("auto",))
    assert str(got_e.value) == str(want_e.value)
    from repro.core.compressors import make_compressor as jax_make
    from repro_torch.core.compressors import make_compressor

    q, jq = make_compressor(compressor), jax_make(compressor)
    for est in ("estimate_omega", "estimate_delta"):
        a, b = getattr(T, est)(q, wl), getattr(RT, est)(jq, jwl)
        assert (a is None) == (b is None), est
        if a is not None:
            assert a == pytest.approx(b, rel=RTOL, abs=0.0), est


def test_wire_grids_cross_every_candidate():
    comp, jcomp = _comps()
    grids = dict(moe_wire_grid=("none", "q8"), act_wire_grid=("none",),
                 model_wire_grid=("natural", "dense", "natural"))
    got = T.default_candidates(comp, _wlike("qwen3-0.6b"),
                               modes=("dense", "q8_ring"), **grids)
    want = RT.default_candidates(jcomp, _jax_wlike("qwen3-0.6b"),
                                 modes=("dense", "q8_ring"), **grids)
    assert len(got) == 2 * 2 * 2
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]


ANALYSIS = {"flops": 3.0e12, "bytes": 4.0e10}


@pytest.fixture
def ref_bits_memo(monkeypatch):
    """The reference's wire bits are one eval_shape a leaf: memoized per
    candidate (each search here is over the one smoke tree)."""
    from repro.tune import model as RM

    bits, cache = RM.predicted_wire_bits, {}

    def memo(cand, wtree_like):
        if cand not in cache:
            cache[cand] = bits(cand, wtree_like)
        return cache[cand]

    monkeypatch.setattr(RM, "predicted_wire_bits", memo)


def _search_pair(verify_top, modes=None, **kw):
    comp, jcomp = _comps(compressor="natural")
    mesh = HostMesh(data=W, device="cpu")
    link, jlink = T.LinkModel(2e-5, 1 / 80e9), RT.LinkModel(2e-5, 1 / 80e9)
    rates, jrates = (T.DeviceRates(5e13, 2e12), RT.DeviceRates(5e13, 2e12))
    got = T.search_plan(comp, _wlike("qwen3-0.6b"), mesh, W,
                        fingerprint="f", analysis=ANALYSIS, link=link,
                        rates=rates, verify_top=verify_top, modes=modes,
                        cap_bytes=4096, **kw.get("port", {}))
    want = RT.search_plan(jcomp, _jax_wlike("qwen3-0.6b"), None, W,
                          fingerprint="f", analysis=ANALYSIS, link=jlink,
                          rates=jrates, verify_top=verify_top, modes=modes,
                          cap_bytes=4096, **kw.get("ref", {}))
    return got, want


def _assert_plans_agree(got, want):
    a, b = got.to_dict(), want.to_dict()
    ra, rb = a.pop("candidates"), b.pop("candidates")
    pa, pb = a.pop("predicted_step_s"), b.pop("predicted_step_s")
    assert pa == pytest.approx(pb, rel=RTOL, abs=0.0)
    assert a == b
    assert [r["label"] for r in ra] == [r["label"] for r in rb]
    for x, y in zip(ra, rb):
        for k in x:
            if isinstance(x[k], float) and isinstance(y[k], float):
                assert x[k] == pytest.approx(y[k], rel=RTOL, abs=0.0), k
            else:
                assert x[k] == y[k], k


def test_search_plan_predicted_ranking_matches(ref_bits_memo):
    got, want = _search_pair(0)
    _assert_plans_agree(got, want)
    assert sum(r["chosen"] for r in got.candidates) == 1


def _fake_seconds(c):
    """A deterministic 'measurement': a function of the label alone."""
    return 1e-3 * (1 + sum(map(ord, c.label)) % 97)


def test_search_plan_verified_ranking_matches(ref_bits_memo):
    got, want = _search_pair(
        2, modes=("dense", "randk_shared", "q8_ring", "efbv"),
        port=dict(measure_fn=lambda c, t, noise: _fake_seconds(c)),
        ref=dict(measure_fn=lambda c, t, key: _fake_seconds(c)))
    _assert_plans_agree(got, want)
    measured = [r for r in got.candidates if r["measured_step_s"] is not None]
    assert len(measured) == 2 and got.measured_step_s is not None


class _Sink:
    def __init__(self):
        self.records = []

    def emit(self, rec):
        self.records.append(rec)


def test_omega_unavailable_record_is_the_reference(capsys):
    """``top_k`` has no unbiased certificate: the search records it, on a
    sink as an event, else as a printed warning."""
    comp, jcomp = _comps(compressor="topk")
    kw = dict(fingerprint="", link=None, verify_top=0, modes=("dense",))
    sinks = _Sink(), _Sink()
    T.search_plan(comp, _wlike("qwen3-0.6b"), None, W, obs_sink=sinks[0],
                  **kw)
    RT.search_plan(jcomp, _jax_wlike("qwen3-0.6b"), None, W,
                   obs_sink=sinks[1], **kw)
    (a,), (b,) = sinks[0].records, sinks[1].records
    for rec in (a, b):
        rec.pop("ts", None)
        rec.pop("time", None)
    assert a == b and a["name"] == "omega_unavailable"
    capsys.readouterr()
    plan = T.search_plan(comp, _wlike("qwen3-0.6b"), None, W, **kw)
    got = capsys.readouterr().out
    RT.search_plan(jcomp, _jax_wlike("qwen3-0.6b"), None, W, **kw)
    assert got == capsys.readouterr().out and "WARNING" in got
    assert plan.omega_source == "none" and plan.omega is None


# -- autotune ---------------------------------------------------------------

def _boom():
    raise AssertionError("a supplier was called on a cache hit")


def test_autotune_cache_and_suppliers(tmp_path):
    comp = CompressionConfig(comm_mode="auto", compressor="natural")
    mesh = HostMesh(data=W, device="cpu")
    like = TR.params_like(get_smoke_config("qwen3-0.6b"))
    calls = []

    def supply(name, value):
        def fn():
            calls.append(name)
            return value
        return fn

    kw = dict(cache_dir=str(tmp_path), link=T.LinkModel(1e-5, 1e-10),
              cap_bytes=4096, measure_iters=1,
              measure_fn=lambda c, t, noise: _fake_seconds(c))
    plan, hit = T.autotune(
        comp, like, mesh, W, modes=("dense", "q8_ring"),
        analysis_fn=supply("analysis", dict(ANALYSIS)),
        rates_fn=supply("rates", T.DeviceRates(5e13, 2e12)),
        hide_fn=supply("hide", T.OverlapMeasurement(0.3, 1.0, 1.0, 1.7)),
        omega_fn=supply("omega", T.OmegaMeasurement(0.0625, 0.06, 3, 99)),
        **kw)
    assert not hit and calls == ["analysis", "rates", "hide", "omega"]
    assert plan.omega == 0.0625 and plan.omega_source == "measured"
    assert plan.hide_fraction == 0.3 and plan.hide_source == "measured"
    assert os.path.exists(T.cache_path(str(tmp_path), plan.fingerprint))
    again, hit = T.autotune(comp, like, mesh, W, modes=("q8_ring", "dense"),
                            analysis_fn=_boom, rates_fn=_boom, hide_fn=_boom,
                            omega_fn=_boom, **kw)
    assert hit and again == plan
    # the narrowed plan does not satisfy a full-grid lookup
    full, hit = T.autotune(comp, like, mesh, W, omega_fn=lambda: None, **kw)
    assert not hit and full.fingerprint != plan.fingerprint
    assert full.omega_source == "analytic"
    # a forced search overwrites its entry
    forced, hit = T.autotune(comp, like, mesh, W, modes=("dense", "q8_ring"),
                             force=True, **kw)
    assert not hit and forced.fingerprint == plan.fingerprint
    assert T.load_cached_plan(str(tmp_path), plan.fingerprint) == forced
    assert forced.omega_source == "analytic"


def test_tune_all_is_the_reference_plus_extras():
    assert set(T.__all__) == set(RT.__all__) | {"encode_time_s",
                                                "fit_alpha_beta"}
    assert T.PLAN_VERSION == RT.PLAN_VERSION
    assert T.DEFAULT_CACHE_DIR == RT.DEFAULT_CACHE_DIR
    for name in ("DEFAULT_BUCKET_GRID", "DEFAULT_RANDK_GRID",
                 "DEFAULT_MOE_WIRE_GRID", "DEFAULT_ACT_WIRE_GRID",
                 "DEFAULT_MODEL_WIRE_GRID"):
        assert getattr(T, name) == getattr(RT, name), name


# -- the trainer ------------------------------------------------------------

CLI = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "2", "--batch", "2",
       "--seq", "16", "--device", "cpu"]


def _params(state):
    return {k: v.clone() for k, v in state.params.items()}


def test_train_cli_auto_searches_then_hits_then_replays(tmp_path, capsys):
    auto = CLI + ["--comm_mode", "auto", "--tune-cache", str(tmp_path),
                  "--tune-modes", "dense,randk_shared,q8_ring"]
    first = _params(TR.main(auto))
    out = capsys.readouterr().out
    assert "tune: searched" in out
    (plan_file,) = os.listdir(tmp_path)
    plan = T.load_plan(str(tmp_path / plan_file))
    assert sum(r["chosen"] for r in plan.candidates) == 1
    assert {r["comm_mode"] for r in plan.candidates} == {
        "dense", "randk_shared", "q8_ring"}
    second = _params(TR.main(auto))
    assert "tune: cache hit" in capsys.readouterr().out
    replay = _params(TR.main(CLI + ["--comm_mode", "auto", "--tune-plan",
                                    str(tmp_path / plan_file)]))
    assert "tune: plan file" in capsys.readouterr().out
    for k in first:
        assert torch.equal(first[k], second[k]), k
        assert torch.equal(second[k], replay[k]), k


def test_train_cli_auto_flags_need_auto():
    """The reference's message (read from its source: its CLI is not
    run here)."""
    from repro.launch import train as jax_train

    want = ("--autotune/--tune_plan replace the communication plan; they "
            "require --comm_mode auto (you passed --comm_mode dense)")
    src = open(jax_train.__file__).read()
    assert '"--autotune/--tune_plan replace the communication plan; they "' \
        in src and '"require --comm_mode auto (you passed "' in src
    for flags in (["--autotune"], ["--tune-plan", "x.json"],
                  ["--tune_plan", "x.json"]):
        with pytest.raises(SystemExit) as e:
            TR.main(CLI + ["--comm_mode", "dense"] + flags)
        assert str(e.value) == want


def test_train_cli_disabled_auto_is_dense(capsys):
    dense = _params(TR.main(CLI + ["--no-compression"]))
    auto = _params(TR.main(CLI + ["--no-compression", "--comm_mode",
                                  "auto"]))
    assert "tune:" not in capsys.readouterr().out
    for k in dense:
        assert torch.equal(dense[k], auto[k]), k
    args = TR.build_parser().parse_args(
        ["--arch", "x", "--comm_mode", "auto", "--autotune", "--tune_plan",
         "p.json", "--tune_cache", "d", "--tune_modes", "dense"])
    assert (args.comm_mode, args.autotune, args.tune_plan, args.tune_cache,
            args.tune_modes) == ("auto", True, "p.json", "d", "dense")


def test_make_channel_auto_is_a_sentinel():
    """``auto`` is no transport: the reference's ValueError (its wording,
    the port's package named); a disabled config's is the dense mean;
    ``aggregation_mode`` names the port's tuner."""
    from repro.comm import make_channel as jax_make
    from repro_torch.comm.channel import MeshChannel, make_channel

    for mode in ("auto", CompressionConfig(comm_mode="auto")):
        with pytest.raises(ValueError) as got:
            make_channel(mode)
        jmode = mode if isinstance(mode, str) else JaxComp(comm_mode="auto")
        with pytest.raises(ValueError) as want:
            jax_make(jmode)
        assert str(got.value) == str(want.value).replace(
            "repro.tune", "repro_torch.tune")
    ch = make_channel(CompressionConfig(enabled=False, comm_mode="auto"))
    assert isinstance(ch, MeshChannel) and ch.mode == "dense"
    with pytest.raises(ValueError, match="repro_torch.tune.autotune"):
        CompressionConfig(comm_mode="auto").aggregation_mode
