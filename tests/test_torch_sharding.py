"""Port parity for the partition specs (``repro_torch.dist.sharding``,
``launch.train.state_pspecs`` / ``batch_pspecs``,
``launch.serve.decode_state_pspecs``) and the mesh's axes
(``launch.mesh.HostMesh``).

The specs need only a mesh's axis names and sizes, so the reference's
mesh is a stub object (``axis_names``, ``devices = np.empty(shape)``)
in-process, and the port's the ``HostMesh`` of the same sizes: (1, 1),
(2, 2) and (2, 2, 2), the last with the ``pod`` axis.  The trees are the
smoke qwen3-0.6b and rwkv6-3b params; every spec tree equals the
reference's leaf by leaf (the reference's nested paths joined by
``/``), entry by entry.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import TrainConfig as JaxTrain
from repro.dist import sharding as JS
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as TS
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import HostMesh, make_host_mesh, n_workers
from repro_torch.models import model as TM


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ("qwen3-0.6b", "rwkv6-3b")
MESHES = {(1, 1): dict(data=1, model=1), (2, 2): dict(data=2, model=2),
          (2, 2, 2): dict(pod=2, data=2, model=2)}


def _stub(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _flat(tree):
    """``{"/"-joined path: spec tuple}`` of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(sp) for path, sp in leaves}


def _port(tree):
    return {k: tuple(sp) for k, sp in tree.items()}


def _shapes(arch):
    cfg = jax_smoke(arch).with_(dtype="float32")
    ref = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    port = port_train.params_like(get_smoke_config(arch).with_(
        dtype="float32"))
    assert list(_flat(jax.tree_util.tree_map(lambda a: P(), ref))) == list(
        port)
    return ref, port


def test_host_mesh_axes():
    """The reference's axis names and sizes; the worker count pod x
    data; ``HostMesh(data=n)`` as before (no pod axis)."""
    m = HostMesh(pod=2, data=2, model=2)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert n_workers(m) == 4 and m.pods == 2
    m = HostMesh(data=4)
    assert (m.axis_names, m.shape, n_workers(m), m.pods) == (
        ("data", "model"), {"data": 4, "model": 1}, 4, 1)
    assert make_host_mesh("cpu") == HostMesh(data=1, device="cpu")
    for shape, kw in MESHES.items():
        assert (tuple(HostMesh(**kw).shape.values()),
                HostMesh(**kw).axis_names) == (shape, _stub(shape).axis_names)
    for bad in (dict(data=0), dict(model=0), dict(pod=0)):
        with pytest.raises(ValueError):
            HostMesh(**bad)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", list(MESHES))
def test_params_and_validated_specs(arch, fsdp, shape):
    ref, port = _shapes(arch)
    ref_specs = JS.params_pspecs(ref, fsdp=fsdp)
    port_specs = TS.params_pspecs(port, fsdp=fsdp)
    assert _port(port_specs) == _flat(ref_specs)
    assert all(isinstance(sp, TS.PSpec) for sp in port_specs.values())
    mesh, stub = HostMesh(**MESHES[shape]), _stub(shape)
    want = _flat(JS.validate_pspecs(ref, ref_specs, stub))
    assert _port(TS.validate_pspecs(port, port_specs, mesh)) == want
    if shape == (2, 2):
        assert any("model" in sp for sp in want.values())


def test_validate_downgrades_as_reference():
    """Axes missing from the mesh dropped, products that do not divide
    replicated, tuples kept, short specs padded."""
    shapes = {"a": SimpleNamespace(shape=(6, 4)),
              "b": SimpleNamespace(shape=(8, 3, 2)),
              "c": SimpleNamespace(shape=(5,))}
    specs = [("model", "data"), (("pod", "data"), "model"), ("data",)]
    for shape in MESHES:
        ref = JS.validate_pspecs(
            {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
             for k, v in shapes.items()},
            {k: P(*sp) for k, sp in zip(shapes, specs)}, _stub(shape))
        got = TS.validate_pspecs(
            shapes, {k: TS.PSpec(*sp) for k, sp in zip(shapes, specs)},
            HostMesh(**MESHES[shape]))
        assert _port(got) == _flat(ref)
    with pytest.raises(ValueError):
        TS.validate_pspecs(shapes, {"a": TS.PSpec()}, HostMesh())


@pytest.mark.parametrize("shape", list(MESHES))
def test_worker_stacked_pspec(shape):
    stub, mesh = _stub(shape), HostMesh(**MESHES[shape])
    for inner in [(), (None, "model"), ("data", "model"),
                  (("pod", "model"), None), (("data", "pod"),)]:
        assert tuple(TS.worker_stacked_pspec(mesh, TS.PSpec(*inner))) == \
            tuple(JS.worker_stacked_pspec(stub, P(*inner)))
    no_workers = SimpleNamespace(axis_names=("model",),
                                 devices=np.empty((2,)))
    assert tuple(TS.worker_stacked_pspec(no_workers, TS.PSpec("model"))) \
        == tuple(JS.worker_stacked_pspec(no_workers, P("model")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(MESHES))
def test_channel_wspecs_as_reference(arch, shape):
    """``build_channel``'s worker-stacked specs, the reference's
    ``build_channel`` assembly, for W = 8 workers."""
    ref, port = _shapes(arch)
    stub, mesh = _stub(shape), HostMesh(**MESHES[shape])
    inner = JS.validate_pspecs(ref, JS.params_pspecs(ref), stub)
    wspecs = jax.tree_util.tree_map(
        lambda sp: JS.worker_stacked_pspec(stub, sp), inner,
        is_leaf=lambda x: isinstance(x, P))
    wshapes = jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct((8, *p.shape), p.dtype), ref)
    want = _flat(JS.validate_pspecs(wshapes, wspecs, stub))
    assert _port(TS.worker_stacked_pspecs(mesh, port, 8)) == want
    from repro_torch.configs.base import CompressionConfig

    cfg = get_smoke_config(arch).with_(dtype="float32")
    for mode in ("q8_ring", "q8_ring_fused", "randk_shared"):
        ch = port_train.build_channel(CompressionConfig(comm_mode=mode), cfg,
                                      mesh, 8)
        assert _port(ch.wspecs) == want
    for mode in ("dense", "ef21"):
        assert port_train.build_channel(CompressionConfig(comm_mode=mode),
                                        cfg, mesh, 8).wspecs is None
    assert port_train.build_channel(CompressionConfig(comm_mode="q8_ring"),
                                    cfg, None, 8).wspecs is None


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("fsdp,zero", [(False, True), (True, False)])
def test_state_and_batch_pspecs(arch, shape, fsdp, zero):
    """``state_pspecs`` of a DIANA state (params, AdamW moments, the
    worker-stacked shifts, the master shift) and ``batch_pspecs``."""
    jcfg = jax_smoke(arch).with_(dtype="float32")
    w = 4
    jt = JaxTrain(fsdp_params=fsdp, zero_opt_state=zero)
    state = jax.eval_shape(lambda k: jax_train.init_state(k, jcfg, jt, w),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    stub, mesh = _stub(shape), HostMesh(**MESHES[shape])
    ref = jax_train.state_pspecs(state, stub, jt)
    cfg = get_smoke_config(arch).with_(dtype="float32")
    tt = TrainConfig(fsdp_params=fsdp, zero_opt_state=zero)
    pstate = port_train.init_state(0, cfg, tt, w, "cpu")
    got = port_train.state_pspecs(pstate, mesh, tt)
    for name in ("params", "h", "h_bar"):
        assert _port(getattr(got, name)) == _flat(getattr(ref, name)), name
    for name in ("m", "v"):
        assert _port(getattr(got.opt, name)) == _flat(getattr(ref.opt,
                                                              name)), name
    assert tuple(got.opt.step) == tuple(ref.opt.step) == ()
    assert tuple(got.step) == tuple(got.bits) == tuple(got.noise) == ()
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int64)}
    jb = jax_train.batch_pspecs({"tokens": jax.ShapeDtypeStruct(
        (8, 16), jnp.int32)}, stub)
    assert _port(port_train.batch_pspecs(batch, mesh)) == _flat(jb)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(MESHES))
def test_decode_state_pspecs(arch, shape):
    """The decode cache's specs: batch over the worker axes, the
    sequence over ``model``, ``kpos`` replicated, validated."""
    jcfg = jax_smoke(arch).with_(dtype="float32")
    ref_state = jax.eval_shape(lambda: JM.make_decode_state(jcfg, 4, 16))
    cfg = get_smoke_config(arch).with_(dtype="float32")
    state = TM.make_decode_state(cfg, 4, 16, "meta")
    stub, mesh = _stub(shape), HostMesh(**MESHES[shape])
    want = _flat(jax_serve.decode_state_pspecs(ref_state, stub))
    assert _port(port_serve.decode_state_pspecs(state, mesh)) == want
