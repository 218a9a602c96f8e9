"""Port parity: the step's cost pass (``repro_torch.launch.hlo_cost``), the
roofline (``hlo_stats``), the dry-run (``dryrun``) and ``grad_dominated``
against the reference's, on small shapes and the smoke configs.

* One product, one batched product and one elementwise chain: the port's
  ``flops`` and ``transcendentals`` on meta tensors are EXACTLY those of
  the reference's ``analyze`` of the jitted function's HLO.
* The smoke qwen3 dense step at W = 1 (each package's
  ``dense_step_analysis``): the port's products are exactly 3x the
  forward's, counted from the shapes (6 x tokens x weights + the
  attention and head products); the whole step's flops are within 20%
  below the reference's (measured 0.825 of it): the reference's layer
  scan rematerializes most of each layer's forward inside its backward
  (its products are 86.0 MFLOP to the port's 70.8), and XLA's fusion
  changes the elementwise count.
* The round's collective bytes by kind for ``dense``, ``randk_shared``
  and ``q8_ring`` on the smoke qwen3 at W = 4 are exactly those of the
  reference's ``analyze`` of its jitted ``Channel.reduce_mean`` on 4 fake
  devices, and ``q8_ring``'s over 2 pods of 2 (the pod stage's
  all-reduce) too (one subprocess for every mode).
* The cost pass traces one worker and one WKV6 step and charges their
  trips: exactly the count of tracing every one.
* The dry-run: ``INPUT_SHAPES``, ``skip_reason`` and ``model_flops`` equal
  the reference's for every arch; ``tune_preview`` at one analysis and one
  set of rates gives the reference's choice; ``run_one`` on smoke configs
  ends ``ok`` for train, prefill and decode with the reference's record
  keys; ``grad_dominated.main`` ranks the modes as the reference's
  collective bytes do.
* A bf16 RWKV-6 (its r, k, v bf16 beside the f32 decay) runs: the WKV6
  op widens mixed dtypes to f32, bitwise the all-f32 call.
"""

import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as RT
from repro.configs import ARCH_IDS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import CompressionConfig as JaxComp
from repro.launch import hlo_cost as RH
from repro_torch import tune as T
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig, InputShape
from repro_torch.core.compressors import ShapeDtype
from repro_torch.launch import dryrun as D
from repro_torch.launch import grad_dominated as G
from repro_torch.launch import hlo_cost as H
from repro_torch.launch import hlo_stats as S
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import HostMesh

META = torch.device("meta")


def _reference_dryrun():
    """The reference's dry-run module: importing it sets XLA_FLAGS to 512
    fake devices for any process started after, so the variable is put
    back."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as RD

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return RD


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke work: one intra-op thread, so that test processes running
    side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the cost pass, op by op ------------------------------------------------

OPS = [
    ("dot", lambda a, b: jnp.dot(a, b), lambda a, b: a @ b,
     [(64, 48), (48, 32)]),
    ("batched einsum", lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
     lambda a, b: torch.einsum("bij,bjk->bik", a, b),
     [(3, 16, 24), (3, 24, 8)]),
    ("elementwise chain",
     lambda a, b, c: jnp.tanh(a * b + c) - jnp.exp(a) / b,
     lambda a, b, c: torch.tanh(a * b + c) - torch.exp(a) / b,
     [(37, 19)] * 3),
]


@pytest.mark.parametrize("name,jf,tf,shapes", OPS, ids=[o[0] for o in OPS])
def test_flops_equal_the_reference_hlo_count(name, jf, tf, shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    want = RH.analyze(jax.jit(jf).lower(*args).compile().as_text())
    got = H.analyze(tf, *[torch.empty(s, device=META) for s in shapes])
    assert got["flops"] == want["flops"] and got["flops"] > 0
    assert got["transcendentals"] == want["transcendentals"]
    assert set(want) <= set(got)
    assert got["while_trips"] == {} and got["unresolved_whiles"] == []
    if name == "dot":   # unfused, a lone op moves what XLA's dot moves
        assert got["bytes"] == want["bytes"]


def _smoke_forward_products(cfg, tokens: int, seq: int, batch: int) -> int:
    """The smoke dense model's forward products from its shapes: every
    weight matmul (2 x tokens x in x out), the attention scores and
    values (2 x B x H x S x S x dh each, every key position), the head."""
    from repro_torch.models.model import param_specs

    total = 0
    for _, shape, _ in param_specs(cfg):
        if len(shape) == 3:     # a stacked layer weight (L, in, out)
            total += 2 * tokens * shape[0] * shape[1] * shape[2]
    attn = 2 * 2 * batch * cfg.n_heads * seq * seq * cfg.head_dim
    return total + cfg.n_layers * attn + 2 * tokens * cfg.d_model \
        * cfg.vocab_size


def test_dense_step_flops_against_the_reference():
    from repro.launch import train as RTR
    from repro.launch.mesh import make_host_mesh

    batch, seq = 2, 16
    jcfg = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    want = RTR.dense_step_analysis(jcfg, make_host_mesh(), 1, 3e-4, batch,
                                   seq)
    table = {}
    got = TR.step_cost(cfg, TR.TrainConfig(
        compression=CompressionConfig(enabled=False)), 1,
        HostMesh(device="cpu"), {"tokens": torch.empty((batch, seq),
                                                       dtype=torch.int64)},
        table=table)
    assert got == TR.dense_step_analysis(cfg, HostMesh(device="cpu"), 1,
                                         3e-4, batch, seq)
    products = sum(r["flops"] for op, r in table.items()
                   if op in ("mm", "bmm", "addmm", "baddbmm"))
    assert products == 3 * _smoke_forward_products(cfg, batch * seq, seq,
                                                    batch)
    ratio = got["flops"] / want["flops"]
    assert 0.8 <= ratio <= 1.0, ratio
    assert got["collective_bytes_by_kind"] == {}   # one worker


# -- the round's collectives against the reference's lowering ----------------

_REFERENCE_ROUND = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.comm import make_channel
    from repro.configs import get_smoke_config
    from repro.launch import hlo_cost
    from repro.models import model as M

    cfg = get_smoke_config("qwen3-0.6b")
    ps = jax.eval_shape(lambda k: M.init_params(k, cfg),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    wl = jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct((4, *p.shape), p.dtype), ps)
    out = {}
    for name in sys.argv[1:]:
        pod, _, mode = name.rpartition(":")
        mesh = (jax.make_mesh((2, 2, 1), ("pod", "data", "model")) if pod
                else jax.make_mesh((4, 1), ("data", "model")))
        axes = ("pod", "data") if pod else "data"
        shard = jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P(axes)), wl)
        ch = make_channel(mode, mesh)
        with jax.sharding.set_mesh(mesh):
            f = jax.jit(ch.reduce_mean,
                        in_shardings=(NamedSharding(mesh, P()), shard))
            hlo = f.lower(jax.random.PRNGKey(0), wl).compile().as_text()
        out[name] = hlo_cost.analyze(hlo)["collective_bytes_by_kind"]
    print(json.dumps(out))
""")

#: the modes of the reference's round, on 4 data positions and (``pod:``)
#: over 2 pods of 2
ROUND_MODES = ("dense", "randk_shared", "q8_ring", "pod:q8_ring")


@pytest.fixture(scope="module", autouse=True)
def _reference_round():
    """The reference's round on 4 fake devices, started with the module's
    first test and read by the last ones (its compiles run beside the
    in-process tests)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_ROUND,
                             *ROUND_MODES], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_round_bytes(_reference_round):
    out, err = _reference_round.communicate(timeout=600)
    assert _reference_round.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# -- loops traced once ------------------------------------------------------

def test_traced_loops_count_every_trip():
    from repro_torch.dist.worker_grads import per_worker_grads
    from repro_torch.kernels.wkv6.kernel import wkv6_forward
    from repro_torch.kernels.wkv6.ref import wkv6_fwd_ref

    params = {"a": torch.empty((8, 6), device=META),
              "b": torch.empty((6,), device=META)}
    wbatch = {"x": torch.empty((3, 5, 8), device=META)}

    def loss_fn(p, batch):
        y = torch.tanh(batch["x"] @ p["a"] + p["b"])
        return (y * y).sum(), {"m": y.mean()}

    every = H.CostMode()            # no pass registered: every worker runs
    with every:
        per_worker_grads(loss_fn, params, wbatch)
    once = H.analyze(per_worker_grads, loss_fn, params, wbatch)
    assert once["repeated_loops"] == {"workers": 3}
    assert (once["flops"], once["bytes"], once["transcendentals"]) == (
        every.flops, every.bytes, every.transcendentals)

    bh, t, k = 2, 8, 16
    rkw = [torch.empty((bh, t, k), device=META) for _ in range(4)]
    u = torch.empty((bh, k), device=META)
    every = H.CostMode()
    with every:
        wkv6_fwd_ref(*rkw, u)
    once = H.analyze(wkv6_forward, *rkw, u)
    assert once["repeated_loops"] == {"wkv6_steps": t}
    assert once["flops"] == every.flops
    assert once["transcendentals"] == every.transcendentals
    # the zero state is written once a call: T times in the traced step
    zero_state = bh * k * k * 4
    assert once["bytes"] == every.bytes + (t - 1) * zero_state


# -- the dry-run ------------------------------------------------------------

def test_input_shapes_and_skips_equal_the_reference():
    RD = _reference_dryrun()
    assert ARCH_IDS == tuple(JAX_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            assert D.skip_reason(arch, shape) == \
                RD.skip_reason(arch, JAX_SHAPES[name]), (arch, name)


def test_model_flops_equal_the_reference(monkeypatch):
    RD = _reference_dryrun()
    from repro.models import model as JM

    # one abstract init a config, not one a shape
    monkeypatch.setattr(RD.M, "count_params_analytic", functools.lru_cache(
        JM.count_params_analytic))
    from repro.launch.serve import serving_config as jax_serving
    from repro_torch.launch.serve import serving_config

    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            if D.skip_reason(arch, shape):
                continue
            cfg, jcfg = get_config(arch), jax_config(arch)
            if shape.kind == "decode":
                cfg, jcfg = serving_config(cfg, name), jax_serving(jcfg,
                                                                   name)
            assert D.model_flops(cfg, shape) == \
                RD.model_flops(jcfg, JAX_SHAPES[name]), (arch, name)


def test_tune_preview_choice_is_the_reference(monkeypatch):
    RD = _reference_dryrun()
    from repro.tune import model as RM

    # the reference's wire bits are one eval_shape a leaf: memoized per
    # candidate (every preview here is over the same smoke tree)
    bits, cache = RM.predicted_wire_bits, {}

    def memo(cand, wtree_like):
        if cand not in cache:
            cache[cand] = bits(cand, wtree_like)
        return cache[cand]

    monkeypatch.setattr(RM, "predicted_wire_bits", memo)
    link, rates = (1e-5, 1 / 450e9), (67e12, 3.35e12)
    for mod in (T, RT):
        monkeypatch.setattr(mod.LinkModel, "nominal", classmethod(
            lambda cls: cls(*link)))
        monkeypatch.setattr(mod.DeviceRates, "nominal", classmethod(
            lambda cls, *a: cls(*rates)))
    mesh = HostMesh(data=4, model=2, device=META)
    jmesh = SimpleNamespace(axis_names=mesh.axis_names,
                            devices=np.empty((4, 2)))
    cases = (({"flops": 1e13, "bytes": 5e11}, "natural"),
             ({"flops": 0, "bytes": 0}, "q8_block"),
             ({"flops": 4e15, "bytes": 1e11}, "natural"))
    for analysis, compressor in cases:
        got = D.tune_preview(get_smoke_config("qwen3-0.6b"),
                             CompressionConfig(compressor=compressor), mesh,
                             analysis)
        want = RD.tune_preview(jax_smoke("qwen3-0.6b"),
                               JaxComp(compressor=compressor), jmesh,
                               analysis)
        assert set(got) == set(want)
        for k in ("predicted_choice", "configured_comm_mode", "hide_source",
                  "omega_source", "predicted_moe_wire"):
            assert got[k] == want[k], (analysis, compressor, k)
        assert got["predicted_step_s"] == pytest.approx(
            want["predicted_step_s"], rel=1e-12)
        assert [c["label"] for c in got["candidates"]] == \
            [c["label"] for c in want["candidates"]]


def _reference_record_keys():
    """The keys the reference's ``run_one`` writes on success, read off
    its source (its dry-run compiles for 512 devices: not run here)."""
    RD = _reference_dryrun()
    tree = ast.parse(open(RD.__file__).read())
    keys, sub = set(), {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "update" and node.args
                and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys |= {k.value for k in d.keys}
            for k, v in zip(d.keys, d.values):
                if isinstance(v, ast.Dict):
                    sub[k.value] = {kk.value for kk in v.keys
                                    if isinstance(kk, ast.Constant)}
        if (isinstance(node, ast.Subscript) and isinstance(node.value,
                                                           ast.Name)
                and node.value.id == "rec" and isinstance(node.slice,
                                                          ast.Constant)):
            keys.add(node.slice.value)
    # those of the skipped and failed records
    return keys - {"reason", "error", "traceback"}, sub


def test_run_one_on_smoke_configs(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    monkeypatch.setattr(D, "INPUT_SHAPES", {
        "train_4k": InputShape("train_4k", 16, 8, "train"),
        "prefill_32k": InputShape("prefill_32k", 32, 2, "prefill"),
        "decode_32k": InputShape("decode_32k", 32, 4, "decode"),
        "long_500k": InputShape("long_500k", 64, 1, "decode")})
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False: HostMesh(
                            data=2, model=2, pod=2 if multi_pod else None,
                            device=META))
    keys, sub = _reference_record_keys()
    tcfg = TR.TrainConfig()
    for arch, shape in (("qwen3-0.6b", "train_4k"),
                        ("qwen3-0.6b", "prefill_32k"),
                        ("qwen3-0.6b", "decode_32k"),
                        ("rwkv6-3b", "train_4k"),
                        ("qwen2-moe-a2.7b", "long_500k")):
        rec = D.run_one(arch, shape, False, tcfg, str(tmp_path),
                        save_hlo=shape == "prefill_32k")
        assert rec["status"] == "ok", rec.get("traceback")
        want = keys if D.INPUT_SHAPES[shape].kind == "train" else \
            keys - {"wires", "tune_preview"}
        assert want <= set(rec), want - set(rec)
        for k, inner in sub.items():
            assert inner <= set(rec[k]), (k, inner - set(rec[k]))
        assert rec["compile_s"] is None and rec["memory"]["temp_bytes"] \
            is None and rec["memory"]["fits_one_card"]
        assert rec["roofline"]["hlo_flops"] > 0
    assert os.path.exists(tmp_path / "qwen3-0.6b_prefill_32k_pod256"
                          ".ops.json")
    rc = D.main(["--arch", "qwen3-0.6b", "--shape", "train_4k", "--out",
                 str(tmp_path), "--multi-pod", "--comm-mode", "q8_ring"])
    out = capsys.readouterr().out
    assert rc == 0 and "DRY-RUN SUMMARY: 1 ok, 0 skipped, 0 errors" in out
    assert "tune preview: predicted choice" in out
    rec = json.loads((tmp_path / "qwen3-0.6b_train_4k_pod512_q8_ring.json"
                      ).read_text())
    assert set(rec["roofline"]["collective_by_kind"]) == {
        "collective-permute", "all-reduce"}     # the ring and the pod stage


def test_roofline_uses_the_card_constants():
    c = {"flops": 67e12, "bytes": 3.35e12, "collective_bytes": 450e9,
         "collective_bytes_by_kind": {"all-reduce": 450e9},
         "unresolved_whiles": []}
    r = S.roofline(c, c, 67e12, 1)
    assert r["compute_s"] == r["memory_s"] == r["collective_s"] == 1.0
    assert r["useful_flops_frac"] == 1.0
    assert S.roofline(c, c, 0, 1, dtype="bfloat16")["compute_s"] == \
        67e12 / 989e12
    assert S.collective_bytes_of(c)["all-reduce"] == int(450e9)


def test_mixed_dtype_wkv6_widens_to_f32():
    """A bf16 RWKV-6's r, k, v beside its f32 decay raised a dtype error;
    they are widened to f32, exactly."""
    from repro_torch.kernels.wkv6.ops import wkv6

    g = torch.Generator().manual_seed(0)
    b, t, h, k = 2, 5, 2, 16
    r, kk, v = (torch.randn((b, t, h, k), generator=g).to(torch.bfloat16)
                for _ in range(3))
    w = torch.rand((b, t, h, k), generator=g) * 0.5 + 0.4
    u = torch.randn((h, k), generator=g)
    got = wkv6(r, kk, v, w, u)
    want = wkv6(r.float(), kk.float(), v.float(), w, u)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


# -- the round against the reference's lowering (the subprocess's) -----

def _smoke_wlike(w, arch="qwen3-0.6b"):
    return {k: ShapeDtype((w, *p.shape), p.dtype, META)
            for k, p in TR.params_like(get_smoke_config(arch)).items()}


@pytest.mark.parametrize("name", ROUND_MODES)
def test_round_collective_bytes_equal_the_reference(name,
                                                    reference_round_bytes):
    pod, _, mode = name.rpartition(":")
    mesh = (HostMesh(data=2, pod=2, device=META) if pod
            else HostMesh(data=4, device=META))
    got = H.round_collective_bytes(mode, _smoke_wlike(4), mesh)
    assert got == reference_round_bytes[name]
    assert H.round_collective_bytes(mode, _smoke_wlike(1),
                                    HostMesh(device=META)) == {}


def test_grad_dominated_ranks_as_the_reference(tmp_path,
                                               reference_round_bytes):
    out = tmp_path / "grad_dominated.json"
    rows = G.main(["--out", str(out)],
                  cfg=get_smoke_config("qwen3-0.6b"),
                  mesh=HostMesh(data=4, device=META),
                  shape=InputShape("grad_dom", 16, 8, "train"))
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    got = sorted(G.MODES, key=lambda m: rows[m]["collective_bytes"])
    want = sorted(G.MODES,
                  key=lambda m: sum(reference_round_bytes[m].values()))
    assert got == want
    for m in G.MODES:
        assert rows[m]["by_kind"] == reference_round_bytes[m]
