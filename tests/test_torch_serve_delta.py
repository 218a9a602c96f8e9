"""The port's trainer -> fleet model-delta stream
(``repro_torch.serving``): the contracts of the reference's
``tests/test_serve_delta.py`` and the parity of the stream itself.

  (a) dense wire (lossless bit-pattern deltas): a replica that applied
      every message is BIT-IDENTICAL to the trainer, even after a lossy
      initial sync;
  (b) lossy wire (q8): bounded error that the publisher reports exactly
      (the replica is in bitwise lockstep with its h_bar), zero after a
      resync;
  (c) the fleet serves off the stream with staleness <= K, and a
      staleness breach triggers a dense resync.

Parity: the q8 stream's ``h_bar`` after a sync and 3 publishes is
BITWISE the reference's, its uniforms replayed by address
(``StreamReplay``) from the reference's own key chain.  The reference
is taken jitted, as it runs everywhere else (XLA multiplies the q8 scale
by f32(1/127) there; op by op it divides by 127, which differs in the
last bit of some scales): its publish message jitted, and the new
``h_bar`` as the reference's ``apply_msg`` computes it, jitted -- the
stream's lockstep invariant (a replica holds exactly the publisher's
``h_bar``).  Jitted whole, the reference's ``EFBVShift.apply`` would
contract the decode's product and the add into one FMA and leave its
replicas an ulp away; the port keeps the two sides on one function.
``err_rel`` sums over leaves in f32 in another order: 1e-5 relative.
The bit-pattern delta is pinned bitwise on signed zeros, infinities,
NaN payloads, subnormals and pairs whose difference wraps.

The smoke ``run_fleet_demo`` row's structural numbers equal the
reference's committed ``BENCH_serve_delta`` row
(``experiments/obs/baseline.json``) exactly.  The port's weights, tokens
and draws are torch's, not the reference's, so its loss and ``err_rel``
agree in distribution only: within 1% and 5% (measured: 0.2% and 1.6%).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import SimChannel as JaxSim
from repro.comm import wire_stream as jax_wire_stream
from repro.configs import get_smoke_config as jax_smoke
from repro.core.compressors import Int8Stochastic as JaxInt8
from repro.core.shift_rules import EFBVShift as JaxEFBV
from repro.models import model as JM
from repro.serving import delta as JD
from repro.serving import tree_rel_err as jax_rel_err
from repro_torch.comm.channel import SimChannel
from repro_torch.comm.transport import Wire, build_transport, wire_flag_codec
from repro_torch.comm.wire import AddressedNoise
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import CompressionConfig
from repro_torch.core.compressors import ShapeDtype
from repro_torch.launch.serve import broadcast_params
from repro_torch.models import model as TM
from repro_torch.optim.optimizers import adamw
from repro_torch.serving import (
    DeltaPublisher,
    Request,
    ServingFleet,
    apply_msg,
    dense_tree_bits,
    run_fleet_demo,
    tree_rel_err,
)
from repro_torch.serving import delta as TD
from repro_torch.weights import flatten_tree, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized work: one intra-op thread, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent
tmap = jax.tree_util.tree_map


def _model_wire(flag):
    return Wire(name="model", topology="broadcast",
                codec=wire_flag_codec(flag), channel=SimChannel())


def _perturb(params, i, scale=0.01):
    """A synthetic optimizer step: params + scale * N(0, 1), numpy draws."""
    rng = np.random.default_rng(777 + i)
    return {k: p + scale * torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for k, p in params.items()}


def _bit_equal(a, b) -> bool:
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in a)


@pytest.fixture(scope="module")
def dense_setup():
    cfg_j = jax_smoke("qwen3-0.6b").with_(dtype="float32")
    params_j = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg = get_smoke_config("qwen3-0.6b").with_(dtype="float32")
    return cfg, params_from_jax(tmap(np.asarray, params_j)), params_j


def _probe_logits(cfg, params, toks):
    state = TM.make_decode_state(cfg, 1, 16, "cpu")
    out = []
    for t, tok in enumerate(toks):
        logits, state = TM.decode_step(params, cfg, torch.tensor([[tok]]),
                                       state, t)
        out.append(logits)
    return out


# -- contract (a): lossless stream ------------------------------------------


def test_dense_wire_bit_identical_logits(dense_setup):
    cfg, params, _ = dense_setup
    pub = DeltaPublisher(_model_wire("dense"), noise=AddressedNoise(3, "cpu"))
    sync = pub.initial_sync(params)
    replica = sync.payload
    assert _bit_equal(replica, params)
    for i in range(3):
        params = _perturb(params, i)
        msg = pub.publish(params, step=i + 1)
        assert msg.exact
        replica = apply_msg(replica, msg)
        assert _bit_equal(replica, params)
        assert msg.err_rel == 0.0
    for r, g in zip(_probe_logits(cfg, params, [5, 17, 99]),
                    _probe_logits(cfg, replica, [5, 17, 99])):
        assert torch.equal(r, g)


def test_dense_wire_exact_after_lossy_sync(dense_setup):
    _, params, _ = dense_setup
    pub = DeltaPublisher(_model_wire("dense"), noise=AddressedNoise(4, "cpu"))
    sync = pub.initial_sync(params, sync_codec=wire_flag_codec("natural"))
    replica = sync.payload
    assert not _bit_equal(replica, params)
    assert sync.err_rel > 0.0
    replica = apply_msg(replica, pub.publish(params, step=1))
    assert _bit_equal(replica, params)
    assert pub.err_history == [0.0]


# -- contract (b): lossy stream ---------------------------------------------


def test_q8_wire_bounded_error_and_lockstep(dense_setup):
    _, params, _ = dense_setup
    pub = DeltaPublisher(_model_wire("q8"), noise=AddressedNoise(5, "cpu"))
    replica = pub.initial_sync(params).payload
    errs = []
    for i in range(4):
        params = _perturb(params, 100 + i)
        msg = pub.publish(params, step=i + 1)
        assert not msg.exact
        replica = apply_msg(replica, msg)
        assert _bit_equal(replica, pub.h_bar)
        assert msg.err_rel == pytest.approx(tree_rel_err(params, replica))
        errs.append(msg.err_rel)
    assert 0.0 < max(errs) < 0.05
    snap = pub.snapshot(params, step=5)
    replica = apply_msg(replica, snap)
    assert _bit_equal(replica, params) and snap.err_rel == 0.0


# -- parity of the q8 stream with the reference -----------------------------


class StreamReplay:
    """The reference stream's uniforms by ADDRESS: the model wire's
    stream, round r, (leaf, worker).  Round 0 is the sync's broadcast
    (``leaf_key(fold_in(base, 0), i)``, no worker); a publish after
    ``seq`` messages is round ``seq + 1`` (``fold_in(base, seq + 1)``,
    its message key, the leaf's key, worker 0's split): rounds 2, 3, ...
    after the sync.  Every draw may be taken once."""

    def __init__(self, base, shapes, publishes):
        self.table = {}
        for i, shape in enumerate(shapes):
            k0 = jax.random.fold_in(jax.random.fold_in(base, 0), i)
            self.table[(0, i, None)] = jax.random.uniform(k0, shape)
            for r in range(2, publishes + 2):
                k_msg = jax.random.split(jax.random.fold_in(base, r), 3)[0]
                wk = jax.random.split(jax.random.fold_in(k_msg, i), 1)[0]
                self.table[(r, i, 0)] = jax.random.uniform(wk, shape)
        self.round = None

    def stream(self, name):
        assert name == "model"
        return self

    def at_round(self, r):
        out = StreamReplay.__new__(StreamReplay)
        out.table, out.round = self.table, r
        return out

    def uniform(self, leaf, worker, shape, part=None):
        u = self.table.pop((self.round, leaf, worker))
        assert u.shape == tuple(shape)
        return torch.from_numpy(np.array(u, np.float32))


def _reference_q8_stream(params_seq, key):
    """The reference's q8 stream (sync, then a publish per params),
    jitted: ``DeltaPublisher.initial_sync``'s broadcast and
    ``publish``'s lossy message op for op, then the new ``h_bar`` by the
    reference's ``apply_msg``.  Returns ``[(h_bar, bits)]`` a publish."""
    base = jax_wire_stream(key, "model")
    q, ch, rule = JaxInt8(), JaxSim(), JaxEFBV()
    sync = jax.jit(lambda k, p: ch.broadcast(q, k, p))

    def message(k, params, h_bar):
        k_msg, _, k_agg = jax.random.split(k, 3)
        wp = tmap(lambda p: p[None], params)
        wh = tmap(lambda hb: hb[None], h_bar)
        m, bits = rule.message(q, k_msg, wp, wh)
        return ch.reduce_mean(k_agg, m), bits

    message = jax.jit(message)
    apply = jax.jit(lambda hb, mb: JD.apply_msg(hb, JD.DeltaMsg(
        kind="delta", seq=0, step=0, payload=mb, scale=rule.eta,
        exact=False, bits=0.0, err_rel=0.0)))
    h_bar, _ = sync(jax.random.fold_in(base, 0), params_seq[0])
    out = []
    for seq, params in enumerate(params_seq[1:], start=1):   # seq: sent
        m_bar, bits = message(jax.random.fold_in(base, seq + 1), params,
                              h_bar)
        h_bar = apply(h_bar, m_bar)
        out.append((h_bar, float(bits)))
    return out


def test_q8_stream_h_bar_matches_reference_bitwise(dense_setup):
    """Sync + 3 publishes of the q8 stream: the port's h_bar after each
    publish bitwise the reference's with the reference's uniforms
    replayed by address; bits equal; err_rel within 1e-5."""
    _, params, _ = dense_setup
    seq = [params] + [_perturb(params, 400 + i) for i in range(3)]
    seq_j = [_nested({k: jnp.asarray(v.numpy()) for k, v in p.items()})
             for p in seq]
    key = jax.random.PRNGKey(11)
    want = _reference_q8_stream(seq_j, key)
    replay = StreamReplay(jax_wire_stream(key, "model"),
                          [tuple(p.shape) for p in params.values()], 3)
    pub = DeltaPublisher(_model_wire("q8"), noise=replay)
    pub.initial_sync(seq[0])
    for s in range(1, 4):
        msg = pub.publish(seq[s], step=s)
        hb_j, bits_j = want[s - 1]
        wnt = flatten_tree(tmap(np.asarray, hb_j))
        for k, v in pub.h_bar.items():
            np.testing.assert_array_equal(v.numpy().view(np.int32),
                                          wnt[k].view(np.int32), err_msg=k)
        assert msg.bits == bits_j
        assert msg.err_rel == pytest.approx(
            jax_rel_err(seq_j[s], hb_j), rel=1e-5)
    assert not replay.table


def _nested(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# -- the lossless stream on special values ----------------------------------


def _specials(dtype, int_dtype, pairs):
    p = np.array([a for a, _ in pairs], int_dtype).view(dtype)
    h = np.array([b for _, b in pairs], int_dtype).view(dtype)
    return p, h


F32_PAIRS = [
    (0x00000000, 0x80000000),    # +0 from -0
    (0x80000000, 0x00000000),    # -0 from +0
    (0x7F800000, 0x3F800000),    # +inf from 1
    (0xFF800000, 0x7F800000),    # -inf from +inf
    (0x7FC00001, 0x7FC00000),    # NaN payloads
    (0xFFC12345, 0x00000001),    # negative NaN from the smallest subnormal
    (0x7F800001, 0x40490FDB),    # signalling NaN from pi
    (0x00000001, 0x807FFFFF),    # subnormals of both signs
    (0x80000001, 0x7F800000),    # the difference wraps (int32)
    (0x7F7FFFFF, 0xFF7FFFFF),    # max from -max: wraps the other way
    (0x3F800001, 0x3F800000),    # nearby floats: a delta of one
]


@pytest.mark.parametrize("dtype,int_dtype,tdtype,pairs", [
    (np.float32, np.uint32, torch.float32, F32_PAIRS),
    (np.float64, np.uint64, torch.float64,
     [(0x7FF0000000000001, 0x8000000000000000),
      (0x8000000000000001, 0x7FF0000000000000),
      (0x0000000000000001, 0xFFF8000000000000)]),
])
def test_lossless_delta_special_values(dtype, int_dtype, tdtype, pairs):
    """The bit-pattern delta and its apply, bitwise the reference's, and
    the apply recovers p bit for bit, wrap-around included."""
    p, h = _specials(dtype, int_dtype, pairs)
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        dj = np.asarray(JD._int_delta_leaf(jnp.asarray(p), jnp.asarray(h)))
        rj = np.asarray(JD._int_apply_leaf(jnp.asarray(h), jnp.asarray(dj)))
    finally:
        jax.config.update("jax_enable_x64", False)
    pt, ht = torch.from_numpy(p), torch.from_numpy(h)
    assert pt.dtype == tdtype
    dt = TD._int_delta_leaf(pt, ht)
    np.testing.assert_array_equal(dt.numpy(), dj)
    back = TD._int_apply_leaf(ht, dt)
    np.testing.assert_array_equal(back.numpy().view(int_dtype),
                                  p.view(int_dtype))
    np.testing.assert_array_equal(rj.view(int_dtype), p.view(int_dtype))


def test_lossless_delta_bf16():
    """bf16 leaves take the int16 bit-pattern path."""
    p = torch.tensor([0.0, -0.0, float("inf"), float("nan"), 1e-40, 3.0],
                     dtype=torch.bfloat16)
    h = torch.tensor([-0.0, 0.0, -float("inf"), 1.0, -1e-40, 3.0078125],
                     dtype=torch.bfloat16)
    d = TD._int_delta_leaf(p, h)
    assert d.dtype == torch.int16
    assert torch.equal(TD._int_apply_leaf(h, d).view(torch.int16),
                       p.view(torch.int16))


# -- ownership: the in-place optimizer and the stream ------------------------


def test_stream_holds_no_trainer_tensor(dense_setup):
    """The port's AdamW updates params IN PLACE.  After a dense initial
    sync (whose decode hands back its input) and after a snapshot, an
    in-place optimizer step leaves the publisher's h_bar, the sent
    payloads and every replica as they were; the next exact publish
    brings the replicas to the new params bitwise."""
    cfg, params0, _ = dense_setup
    params = {k: v.clone() for k, v in params0.items()}
    opt = adamw(lr=1e-2)
    ostate = opt.init(params)
    rng = np.random.default_rng(9)

    def adamw_step():
        before = {k: v.clone() for k, v in params.items()}
        grads = {k: torch.from_numpy(rng.standard_normal(
            tuple(v.shape)).astype(np.float32)) for k, v in params.items()}
        opt.update(grads, ostate, params)
        assert not _bit_equal(params, before)
        return before

    pub = DeltaPublisher(_model_wire("dense"), noise=AddressedNoise(8, "cpu"))
    sync = pub.initial_sync(params)
    fleet = ServingFleet(cfg, sync, 2, stale_k=4, max_batch=1, cache_len=16)
    for step, resync in ((1, False), (2, True)):
        if resync:
            snap = pub.snapshot(params, step=step - 1)
            fleet.deliver(snap)
            fleet.tick()
            sent = snap.payload
        else:
            sent = sync.payload
        before = adamw_step()
        assert _bit_equal(pub.h_bar, before) and _bit_equal(sent, before)
        for rep in fleet.replicas:
            assert _bit_equal(rep.params, before)
        fleet.deliver(pub.publish(params, step=step))
        fleet.tick()
        for rep in fleet.replicas:
            assert _bit_equal(rep.params, params)


# -- contract (c): the fleet ------------------------------------------------


def test_fleet_serves_off_dense_stream(dense_setup):
    cfg, params, _ = dense_setup
    pub = DeltaPublisher(_model_wire("dense"), noise=AddressedNoise(6, "cpu"))
    fleet = ServingFleet(cfg, pub.initial_sync(params), 2, stale_k=4,
                         max_batch=2, cache_len=64)
    for i, prompt in enumerate([[5, 17, 99], [42, 7], [123, 9, 11], [88, 3]]):
        fleet.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
    done = []
    for i in range(6):
        params = _perturb(params, 200 + i, scale=1e-3)
        fleet.deliver(pub.publish(params, step=i + 1))
        done.extend(fleet.tick())
    done.extend(fleet.run_drain())
    assert sorted(r.uid for r in done) == [0, 1, 2, 3]
    assert all(r.done for r in done)
    assert fleet.max_staleness_seen <= 4
    for rep in fleet.replicas:
        assert _bit_equal(rep.params, params)


def test_fleet_staleness_triggers_resync(dense_setup):
    cfg, params, _ = dense_setup
    pub = DeltaPublisher(_model_wire("q8"), noise=AddressedNoise(7, "cpu"))
    fleet = ServingFleet(cfg, pub.initial_sync(params), 1, stale_k=2,
                         max_batch=1, cache_len=64, max_apply_per_tick=1)
    fleet.submit(Request(uid=0, prompt=[5, 17], max_new_tokens=32))
    for i in range(5):
        params = _perturb(params, 300 + i, scale=1e-3)
        fleet.deliver(pub.publish(params, step=i + 1))
    fleet.tick()
    assert fleet.needs_resync()
    assert fleet.max_staleness_seen > 2
    snap = pub.snapshot(params, step=fleet.trainer_step)
    backlog = len(fleet.replicas[0].pending)
    fleet.deliver(snap)
    fleet.tick()
    rep = fleet.replicas[0]
    assert not fleet.needs_resync()
    assert rep.staleness(fleet.trainer_step) == 0
    assert rep.resyncs == 1
    assert _bit_equal(rep.params, params)
    assert rep.applied < backlog + 5


# -- accounting seams ---------------------------------------------------------


def _transport_for(cfg, flag, publish_every):
    comp = CompressionConfig(enabled=False, model_wire=flag,
                             publish_every=publish_every)
    like = {path: ShapeDtype(shape, torch.float32, torch.device("meta"))
            for path, shape, _ in TM.param_specs(cfg)}
    return build_transport(comp, cfg, SimChannel(), params_like=like)


def test_transport_model_wire_accounting(dense_setup):
    cfg, _, _ = dense_setup
    b1 = _transport_for(cfg, "q8", 1).per_wire_bits()["model"]
    b4 = _transport_for(cfg, "q8", 4).per_wire_bits()["model"]
    assert b4 == pytest.approx(b1 / 4.0)
    assert b1 < _transport_for(cfg, "dense", 1).per_wire_bits()["model"]
    assert _transport_for(cfg, "q8", 1)["model"].topology == "broadcast"


def test_broadcast_params_rejects_auto():
    """The serve-side broadcast builds its channel through make_channel:
    the tuner's ``auto`` sentinel fails naming itself (the reference's
    ValueError: resolve it first), a typo naming the accepted modes."""
    params = {"w": torch.ones(4, 4)}
    with pytest.raises(ValueError, match="'auto' is a tuner sentinel"):
        broadcast_params(params, comm_mode="auto")
    with pytest.raises(ValueError, match="sim"):
        broadcast_params(params, comm_mode="definitely-not-a-mode")


def test_dense_tree_bits_matches_identity_payload():
    tree = {"a": torch.zeros(3, 5), "b": torch.zeros(7)}
    assert dense_tree_bits(tree) == 32.0 * (15 + 7)


# -- the smoke demo against the reference's committed row --------------------


def _flatten_row(row, prefix=""):
    out = {}
    for k, v in row.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_row(v, name + "."))
        elif isinstance(v, list):
            out.update({f"{name}[{i}]": x for i, x in enumerate(v)})
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[name] = float(v)
    return out


@pytest.mark.parametrize("wire", ["dense", "q8", "natural"])
def test_smoke_fleet_demo_matches_baseline(wire):
    """The reference bench's configuration (2 replicas, a publish every
    2 of 4 steps, K = 4, 4 requests of 8 tokens): every structural
    number of its row exactly; loss within 1%, err_rel within 5%."""
    base = json.loads((ROOT / "experiments/obs/baseline.json").read_text())
    metrics = base["artifacts"]["BENCH_serve_delta.json"]["metrics"]
    want = {k[len(wire) + 1:]: v for k, v in metrics.items()
            if k.startswith(wire + ".")}
    row = run_fleet_demo("qwen3-0.6b", n_replicas=2, model_wire=wire,
                         publish_every=2, stale_k=4, steps=4, n_requests=4,
                         gen_len=8, device="cpu")
    got = _flatten_row(row)
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        if k == "final_loss":
            assert got[k] == pytest.approx(v, rel=1e-2), k
        elif k.startswith("err_rel") and v != 0.0:
            assert got[k] == pytest.approx(v, rel=5e-2), k
        else:
            assert got[k] == v, (k, got[k], v)
