"""The plan search: predict every candidate, measure the top few -- the
port of the reference's ``repro/tune/search.py``.

The grid covers {comm mode} x {bucket-byte budgets for the overlap
modes} x {codec parameters}: Rand-K keep-fractions, the fused q8 ring's
scale-block rows, and EF-BV ``(eta, nu)`` derived from the configured
compressor's ESTIMATED variance (``estimate_omega``: size-weighted
``omega(d)`` over the real leaf dimensions, the quantity EF-BV's optimal
damping ``eta = 1/(1+omega)`` needs).

Ranking is two-stage: the alpha-beta predictor (``tune.model``) orders
ALL candidates structurally; the top ``verify_top`` are then VERIFIED
by timed micro-reduces of the real leaf shapes through the real channels
(``measure_candidate`` times ``Channel.reduce_mean``, the device
synchronised around every call: on the card the q8 candidates run the q8
kernels; the overlap modes' measured number is the drained pipeline,
their overlap credit comes from the composition model, and both numbers
are recorded in the plan).  The measured winner becomes the
``TunePlan``.

The reference draws its synthetic traffic and its rounds' randomness
from ``jax.random.PRNGKey(0)``; the port takes an integer ``seed`` for
the same two things: ``synth_wtree``'s data and the rounds'
``AddressedNoise``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.comm.channel import make_channel
from repro_torch.comm.wire import AddressedNoise
from repro_torch.core.algorithms import efbv_params
from repro_torch.core.compressors import make_compressor
from repro_torch.tune.measure import (
    DEFAULT_MEASURE_BYTES_CAP,
    DeviceRates,
    LinkModel,
    _device_of,
    calibrate_link,
    measure_subtree,
    synth_wtree,
    time_fn,
)
from repro_torch.tune.model import (
    TUNABLE_MODES,
    Candidate,
    compose_step_s,
    predict_step,
)
from repro_torch.tune.plan import TunePlan

#: overlap bucket budgets searched by default (uncompressed per-worker
#: message bytes -- the plan_buckets unit)
DEFAULT_BUCKET_GRID = (1 << 20, 4 << 20, 16 << 20)
DEFAULT_RANDK_GRID = (0.01, 0.05, 0.1)
DEFAULT_Q8_BLOCK_GRID = (64,)
#: per-wire codec-flag grids -- ("none",) keeps non-grad wires out of the
#: search (and the grid size unchanged) unless the caller has registered
#: wire traffic to trade against
DEFAULT_MOE_WIRE_GRID = ("none",)
DEFAULT_ACT_WIRE_GRID = ("none",)
DEFAULT_MODEL_WIRE_GRID = ("none",)


def _leaf_d(leaf) -> int:
    n = 1
    for s in leaf.shape[1:]:
        n *= s
    return n


def _size_weighted(cert, wtree_like) -> Optional[float]:
    """``sum_leaf cert(d) d / sum_leaf d`` over the worker-stacked leaves
    (``{path: anything with .shape}``); None when ``cert`` raises
    ``NotImplementedError`` for a leaf or the tree is empty."""
    total, acc = 0, 0.0
    for leaf in wtree_like.values():
        d = _leaf_d(leaf)
        try:
            acc += cert(d) * d
        except NotImplementedError:
            return None
        total += d
    return acc / total if total else None


def estimate_omega(codec, wtree_like) -> Optional[float]:
    """Size-weighted unbiased variance ``omega`` of a codec over the
    REAL leaf dimensions (per-leaf messages see per-leaf d, so a single
    ``omega(total_d)`` would be wrong for sparsifiers).  ``None`` when
    the codec has no unbiased certificate."""
    if not hasattr(codec, "omega"):
        return None
    return _size_weighted(codec.omega, wtree_like)


def estimate_delta(codec, wtree_like) -> Optional[float]:
    """Size-weighted contraction ``delta`` (B-class certificate)."""
    if not hasattr(codec, "delta"):
        return None
    return _size_weighted(codec.delta, wtree_like)


def default_candidates(
    comp,
    wtree_like,
    *,
    modes: Optional[Sequence[str]] = None,
    bucket_grid: Sequence[int] = DEFAULT_BUCKET_GRID,
    randk_grid: Sequence[float] = DEFAULT_RANDK_GRID,
    q8_block_grid: Sequence[int] = DEFAULT_Q8_BLOCK_GRID,
    moe_wire_grid: Sequence[str] = DEFAULT_MOE_WIRE_GRID,
    act_wire_grid: Sequence[str] = DEFAULT_ACT_WIRE_GRID,
    model_wire_grid: Sequence[str] = DEFAULT_MODEL_WIRE_GRID,
    omega: Optional[float] = None,
) -> Tuple[Candidate, ...]:
    """The search grid for one ``CompressionConfig`` (module docstring).

    ``modes`` restricts the grid to a subset of ``TUNABLE_MODES``.  The
    wire grids cross every mode candidate with per-wire codec flags
    (``WIRE_CODEC_FLAGS``), letting the search pick a DIFFERENT codec per
    registered wire.  ``omega`` overrides the analytic ``estimate_omega``
    in the EF-BV eta/nu derivation (pass ``measure_omega(...).omega_hat``
    so the damping runs on the variance REALIZED on this traffic).
    """
    allowed = set(TUNABLE_MODES if modes is None else modes)
    unknown = allowed - set(TUNABLE_MODES)
    if unknown:
        raise ValueError(
            f"unknown tune modes {sorted(unknown)}; have {TUNABLE_MODES}"
        )
    base = dict(compressor=comp.compressor,
                compressor_kwargs=tuple(comp.compressor_kwargs))
    q = make_compressor(comp.compressor, **dict(comp.compressor_kwargs))
    if omega is None:
        omega = estimate_omega(q, wtree_like)
    delta = estimate_delta(q, wtree_like)
    eta, nu = efbv_params(delta=delta or 0.0, omega=omega)

    out = []
    if "dense" in allowed:
        out.append(Candidate("dense", **base))
    if "randk_shared" in allowed:
        for rq in dict.fromkeys(tuple(randk_grid) + (comp.randk_q,)):
            out.append(Candidate("randk_shared", randk_q=rq, **base))
    if "q8_ring" in allowed:
        out.append(Candidate("q8_ring", **base))
    if "q8_ring_fused" in allowed:
        for br in q8_block_grid:
            out.append(Candidate("q8_ring_fused", q8_block_rows=br, **base))
    if "q8_ring_overlap" in allowed:
        for bb in bucket_grid:
            for br in q8_block_grid:
                out.append(Candidate("q8_ring_overlap", bucket_bytes=bb,
                                     q8_block_rows=br, **base))
    if "q8_ring_fused_vjp" in allowed:
        # per-leaf buckets by construction: no bucket-byte axis
        for br in q8_block_grid:
            out.append(Candidate("q8_ring_fused_vjp",
                                 q8_block_rows=br, **base))
    if "ef21" in allowed and delta is not None and delta > 0.0:
        out.append(Candidate("ef21", **base))
    if "efbv" in allowed:
        out.append(Candidate("efbv", efbv_eta=eta, efbv_nu=nu, **base))
    if "efbv_overlap" in allowed:
        for bb in bucket_grid:
            out.append(Candidate("efbv_overlap", bucket_bytes=bb,
                                 efbv_eta=eta, efbv_nu=nu, **base))
    wire_points = [
        (mw, aw, dw)
        for mw in dict.fromkeys(moe_wire_grid)
        for aw in dict.fromkeys(act_wire_grid)
        for dw in dict.fromkeys(model_wire_grid)
    ]
    if wire_points != [("none", "none", "none")]:
        out = [
            dataclasses.replace(c, moe_wire=mw, act_wire=aw, model_wire=dw)
            for c in out
            for mw, aw, dw in wire_points
        ]
    return tuple(out)


def measure_candidate(cand: Candidate, mesh, wtree, noise, *,
                      iters: int = 3) -> float:
    """Median seconds of one drained aggregation round through the REAL
    channel this candidate configures (a micro-reduce of the given
    worker-stacked data ``wtree`` over ``mesh``, the round's draws from
    ``noise``), the device synchronised around every call
    (``tune.measure.time_fn``)."""
    kw = {}
    if cand.overlap:
        kw["bucket_bytes"] = cand.bucket_bytes
    ch = make_channel(cand.comm_mode, mesh, randk_q=cand.randk_q,
                      q8_block_rows=cand.q8_block_rows, **kw)
    return time_fn(ch.reduce_mean, noise, wtree, iters=iters)


def _omega_unavailable(codec_name: str, comp, obs_sink) -> None:
    """The search's record that the codec has no variance certificate:
    an ``omega_unavailable`` event on ``obs_sink``, else a printed
    warning (the reference's wording)."""
    if obs_sink is not None:
        from repro_torch.obs.metrics import event_record

        obs_sink.emit(event_record(
            "omega_unavailable", 0, codec=codec_name,
            compressor=comp.compressor,
            fallback="efbv eta/nu from delta or 0.0",
        ))
    else:
        print(
            f"tune: WARNING: codec {codec_name} has no unbiased "
            "variance certificate (.omega); EF-BV eta/nu fall "
            "back to the contraction delta or 0.0 "
            "(omega_source='none')"
        )


def search_plan(
    comp,
    wtree_like,
    mesh,
    w: int,
    *,
    fingerprint: str = "",
    analysis: Optional[dict] = None,
    link: Optional[LinkModel] = None,
    rates: Optional[DeviceRates] = None,
    modes: Optional[Sequence[str]] = None,
    bucket_grid: Sequence[int] = DEFAULT_BUCKET_GRID,
    randk_grid: Sequence[float] = DEFAULT_RANDK_GRID,
    q8_block_grid: Sequence[int] = DEFAULT_Q8_BLOCK_GRID,
    moe_wire_grid: Sequence[str] = DEFAULT_MOE_WIRE_GRID,
    act_wire_grid: Sequence[str] = DEFAULT_ACT_WIRE_GRID,
    model_wire_grid: Sequence[str] = DEFAULT_MODEL_WIRE_GRID,
    wire_traffic=None,
    verify_top: int = 2,
    measure_iters: int = 3,
    cap_bytes: int = DEFAULT_MEASURE_BYTES_CAP,
    measure_fn: Optional[Callable] = None,
    seed: int = 0,
    hide: Optional[float] = None,
    hide_source: Optional[str] = None,
    omega: Optional[float] = None,
    omega_source: Optional[str] = None,
    obs_sink=None,
) -> TunePlan:
    """Predict-all, measure-top-``verify_top``, pick the measured winner.

    ``wtree_like`` is ``{path: (W, ...) leaf-like}``.
    ``measure_fn(candidate, wtree_data, noise) -> comm_seconds`` is
    injectable for tests; the default times the real channel
    (``measure_candidate``) on data drawn from ``seed`` over the capped
    measure subtree, on the mesh's device.  With ``verify_top=0`` the
    predicted ranking alone decides (the dry-run preview path: nothing
    is timed).  ``wire_traffic`` is ``Transport.extra_traffic()``.
    ``hide`` replaces the nominal overlap-hide constant in BOTH the
    predicted and the measured composition; ``omega`` replaces the
    analytic ``estimate_omega`` in the EF-BV eta/nu derivation; the plan
    records each with its source.  A codec with NO variance certificate
    gets ``omega_source="none"`` and the ``omega_unavailable`` record.
    """
    q = make_compressor(comp.compressor, **dict(comp.compressor_kwargs))
    if omega is not None:
        omega = float(omega)
        omega_source = omega_source or "measured"
    else:
        omega = estimate_omega(q, wtree_like)
        if omega is not None:
            omega_source = omega_source or "analytic"
        else:
            omega_source = "none"
            _omega_unavailable(type(q).__name__, comp, obs_sink)
    candidates = default_candidates(
        comp, wtree_like, modes=modes, bucket_grid=bucket_grid,
        randk_grid=randk_grid, q8_block_grid=q8_block_grid,
        moe_wire_grid=moe_wire_grid, act_wire_grid=act_wire_grid,
        model_wire_grid=model_wire_grid, omega=omega,
    )
    if not candidates:
        raise ValueError("empty candidate grid (modes filtered everything)")
    if link is None:
        link = (calibrate_link(mesh, wtree_like, cap_bytes=cap_bytes,
                               iters=measure_iters)
                if verify_top > 0 else LinkModel.nominal())
    preds = [predict_step(c, wtree_like, link, w, analysis=analysis,
                          rates=rates, wire_traffic=wire_traffic, hide=hide)
             for c in candidates]
    order = sorted(range(len(candidates)), key=lambda i: preds[i].step_s)

    measured_step = {}
    measured_comm = {}
    if verify_top > 0:
        dev = _device_of(mesh, None)
        sub = measure_subtree(wtree_like, cap_bytes)
        data = synth_wtree(seed, sub, device=dev)
        noise = AddressedNoise(seed, dev)
        if measure_fn is None:
            def measure_fn(c, t, nz):
                return measure_candidate(c, mesh, t, nz, iters=measure_iters)
        for i in order[:verify_top]:
            comm_s = float(measure_fn(candidates[i], data, noise))
            measured_comm[i] = comm_s
            measured_step[i] = compose_step_s(
                preds[i].compute_s, comm_s, candidates[i].overlap, hide
            ) + preds[i].encode_s
        chosen_i = min(measured_step, key=lambda i: measured_step[i])
    else:
        chosen_i = order[0]

    rows = []
    for rank, i in enumerate(order):
        p = preds[i]
        rows.append({
            "label": candidates[i].label,
            "comm_mode": candidates[i].comm_mode,
            "moe_wire": candidates[i].moe_wire,
            "act_wire": candidates[i].act_wire,
            "model_wire": candidates[i].model_wire,
            "rank": rank,
            "predicted_step_s": p.step_s,
            "predicted_comm_s": p.comm_s,
            "compute_s": p.compute_s,
            "wire_bytes": p.wire_bytes,
            "n_buckets": p.n_buckets,
            "encode_s": p.encode_s,
            "measured_comm_s": measured_comm.get(i),
            "measured_step_s": measured_step.get(i),
            "chosen": i == chosen_i,
        })
    c = candidates[chosen_i]
    return TunePlan(
        fingerprint=fingerprint,
        comm_mode=c.comm_mode,
        overlap_bucket_bytes=c.bucket_bytes,
        randk_q=c.randk_q,
        q8_block_rows=c.q8_block_rows,
        efbv_eta=c.efbv_eta,
        efbv_nu=c.efbv_nu,
        moe_wire=c.moe_wire,
        act_wire=c.act_wire,
        model_wire=c.model_wire,
        predicted_step_s=preds[chosen_i].step_s,
        measured_step_s=measured_step.get(chosen_i),
        hide_fraction=hide,
        hide_source=(hide_source or
                     ("nominal" if hide is None else "measured")),
        omega=omega,
        omega_source=omega_source,
        candidates=tuple(rows),
    )
