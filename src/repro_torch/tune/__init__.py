"""repro_torch.tune -- the cost-model-driven communication autotuner, the
port of the reference's ``repro/tune``:

  ``measure``   the alpha-beta link model calibrated by timed
                micro-reduces of the REAL leaf shapes, device compute
                rates, and the measured overlap hide fraction and
                compressor variance.
  ``model``     the step-time predictor: the step cost pass's flops and
                bytes (``launch.hlo_cost``) + structural ``wire_bits``
                from each comm mode's own codec + ``plan_buckets`` launch
                counts over a link model.
  ``search``    predict every candidate in {comm mode x bucket grid x
                codec params}, verify the top few by measurement, pick
                the measured winner.
  ``plan``      the frozen ``TunePlan``: strict-JSON persistence and a
                fingerprint cache keyed on model leaves x mesh x world
                size x compressor x search space (the reference's hash,
                so a plan file loads in either package).

``autotune`` is the one-call entry ``launch/train.py`` uses for
``--comm_mode auto``: fingerprint, cache lookup, search on miss, save.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

from repro_torch.core.compressors import ShapeDtype
from repro_torch.tune.measure import (
    DEFAULT_MEASURE_BYTES_CAP,
    DeviceRates,
    LinkModel,
    OmegaMeasurement,
    OverlapMeasurement,
    calibrate_link,
    calibrate_rates,
    fit_alpha_beta,
    measure_omega,
    measure_overlap_hide,
    measure_subtree,
    synth_wtree,
    time_fn,
)
from repro_torch.tune.model import (
    OVERLAP_HIDE,
    TUNABLE_MODES,
    Candidate,
    StepPrediction,
    comm_time_s,
    compose_step_s,
    compute_time_s,
    encode_time_s,
    extra_wire_bits,
    predict_step,
    predicted_wire_bits,
    wire_codec,
)
from repro_torch.tune.plan import (
    PLAN_VERSION,
    TunePlan,
    apply_plan,
    cache_path,
    load_cached_plan,
    load_plan,
    plan_fingerprint,
    save_plan,
)
from repro_torch.tune.search import (
    DEFAULT_ACT_WIRE_GRID,
    DEFAULT_BUCKET_GRID,
    DEFAULT_MODEL_WIRE_GRID,
    DEFAULT_MOE_WIRE_GRID,
    DEFAULT_RANDK_GRID,
    default_candidates,
    estimate_delta,
    estimate_omega,
    measure_candidate,
    search_plan,
)

#: default on-disk home of the fingerprint cache
DEFAULT_CACHE_DIR = os.path.join("experiments", "tune")

#: the search_plan keywords that shape the search space, and so enter
#: the fingerprint
_GRID_KW = ("bucket_grid", "randk_grid", "q8_block_grid", "moe_wire_grid",
            "act_wire_grid", "model_wire_grid")


def autotune(
    comp,
    params_like,
    mesh,
    w: int,
    *,
    cache_dir: str = DEFAULT_CACHE_DIR,
    force: bool = False,
    modes: Optional[Sequence[str]] = None,
    verify_top: int = 2,
    analysis: Optional[dict] = None,
    analysis_fn=None,
    link: Optional[LinkModel] = None,
    rates: Optional[DeviceRates] = None,
    rates_fn=None,
    cap_bytes: int = DEFAULT_MEASURE_BYTES_CAP,
    measure_iters: int = 3,
    hide: Optional[float] = None,
    hide_fn=None,
    omega: Optional[float] = None,
    omega_fn=None,
    obs_sink=None,
    **search_kw,
) -> Tuple[TunePlan, bool]:
    """Resolve one workload to a ``TunePlan``: ``(plan, cache_hit)``.

    ``params_like`` is the (unstacked) parameter tree, ``{path: anything
    with .shape and .dtype}``; everything structural runs ahead of time
    off the shapes, only calibration and top-candidate verification touch
    the device.  ``force=True`` re-searches even on a fingerprint hit
    (the ``--autotune`` CLI flag); a fresh plan always overwrites the
    cache entry for its fingerprint.  ``analysis_fn`` / ``rates_fn`` /
    ``hide_fn`` / ``omega_fn`` are LAZY suppliers of the step's cost
    analysis, the device rates, the measured overlap hide fraction and
    the measured compressor variance, called only on a cache miss: a hit
    measures nothing.  ``hide_fn`` returns an ``OverlapMeasurement`` (or
    a bare float) and ``omega_fn`` an ``OmegaMeasurement`` (or a bare
    float, or ``None`` to decline); both are invoked only when
    ``verify_top > 0`` (the measuring path).  ``obs_sink`` receives the
    search's structured warning events (``omega_unavailable``).
    """
    # the search space is part of the cache key: a plan from a narrowed
    # --tune-modes/grid run must MISS a later full-grid lookup
    search_sig = {
        "modes": "all" if modes is None else tuple(sorted(modes)),
        "verify_top": verify_top,
        **{k: search_kw[k] for k in _GRID_KW if k in search_kw},
    }
    fp = plan_fingerprint(params_like, mesh, w, comp.compressor,
                          comp.compressor_kwargs, search=search_sig)
    if not force:
        cached = load_cached_plan(cache_dir, fp)
        if cached is not None:
            return cached, True
    if analysis is None and analysis_fn is not None:
        analysis = analysis_fn()
    if rates is None and rates_fn is not None and analysis is not None:
        rates = rates_fn()
    hide_source = None if hide is None else "measured"
    if hide is None and hide_fn is not None and verify_top > 0:
        m = hide_fn()
        hide = getattr(m, "hide_fraction", m)
        hide_source = getattr(m, "source", "measured")
    omega_source = None if omega is None else "measured"
    if omega is None and omega_fn is not None and verify_top > 0:
        m = omega_fn()
        if m is not None:
            omega = getattr(m, "omega_hat", m)
            omega_source = getattr(m, "source", "measured")
    wlike = {k: ShapeDtype((w, *p.shape), p.dtype, getattr(p, "device", None))
             for k, p in params_like.items()}
    plan = search_plan(
        comp, wlike, mesh, w, fingerprint=fp, analysis=analysis, link=link,
        rates=rates, modes=modes, verify_top=verify_top,
        measure_iters=measure_iters, cap_bytes=cap_bytes,
        hide=hide, hide_source=hide_source,
        omega=omega, omega_source=omega_source, obs_sink=obs_sink,
        **search_kw,
    )
    save_plan(plan, cache_path(cache_dir, fp))
    return plan, False


__all__ = [
    "Candidate",
    "DEFAULT_ACT_WIRE_GRID",
    "DEFAULT_BUCKET_GRID",
    "DEFAULT_CACHE_DIR",
    "DEFAULT_MEASURE_BYTES_CAP",
    "DEFAULT_MODEL_WIRE_GRID",
    "DEFAULT_MOE_WIRE_GRID",
    "DEFAULT_RANDK_GRID",
    "DeviceRates",
    "LinkModel",
    "OVERLAP_HIDE",
    "OmegaMeasurement",
    "OverlapMeasurement",
    "PLAN_VERSION",
    "StepPrediction",
    "TUNABLE_MODES",
    "TunePlan",
    "apply_plan",
    "autotune",
    "cache_path",
    "calibrate_link",
    "calibrate_rates",
    "comm_time_s",
    "compose_step_s",
    "compute_time_s",
    "default_candidates",
    "encode_time_s",
    "estimate_delta",
    "estimate_omega",
    "extra_wire_bits",
    "fit_alpha_beta",
    "load_cached_plan",
    "load_plan",
    "measure_candidate",
    "measure_omega",
    "measure_overlap_hide",
    "measure_subtree",
    "plan_fingerprint",
    "predict_step",
    "predicted_wire_bits",
    "save_plan",
    "search_plan",
    "synth_wtree",
    "time_fn",
    "wire_codec",
]
