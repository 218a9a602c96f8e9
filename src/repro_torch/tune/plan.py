"""The frozen ``TunePlan``, its persistence and its fingerprint cache -- the
port of the reference's ``repro/tune/plan.py``.

A plan is the tuner's OUTPUT: the concrete communication configuration
(``comm_mode``, bucket budget, codec parameters) chosen for one
(model x mesh x world-size) workload, together with the evidence
(predicted and measured step times per candidate) that picked it.  Plans
are:

  * strict JSON on disk (``allow_nan=False``: non-finite values become
    ``null``, through ``obs.metrics.sanitize_tree``),
  * cached by FINGERPRINT: a sha256 over the model's leaf signature
    (shape + dtype per parameter leaf, in the reference's flatten order
    and with numpy's dtype names), the mesh (axis names + sizes), the
    worker count, the configured compressor and the search space.  The
    blob hashed is the reference's, byte for byte, so the same workload
    has the same fingerprint in both packages and a plan file written by
    one loads in the other.

``apply_plan`` folds a plan back into a ``CompressionConfig``: the ONE
place the ``comm_mode="auto"`` sentinel becomes a concrete mode.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

#: bump when the plan schema or the search semantics change -- a cached
#: plan from an older tuner must MISS, not silently misconfigure a run
#: (the reference's version: v6 added omega/omega_source)
PLAN_VERSION = 6


def _leaves(tree, prefix=()):
    """``(path tuple, leaf)`` of a flat ``{"a/b": leaf}`` or nested dict
    tree, in the reference's flatten order: jax sorts the keys at every
    level of a nested dict, which is the order of the path tuples (not of
    the ``/``-joined names: ``-`` and ``.`` sort below ``/``)."""
    out = []
    for k, v in tree.items():
        path = prefix + tuple(str(k).split("/"))
        if isinstance(v, dict):
            out += _leaves(v, path)
        else:
            out.append((path, v))
    return sorted(out, key=lambda pv: pv[0])


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype (``float32``, ``bfloat16``), as the
    reference's ``str(jnp.dtype(...))``."""
    return str(dtype).removeprefix("torch.")


def _mesh_sig(mesh) -> Optional[dict]:
    """``{"axes", "shape"}`` of a ``HostMesh`` (sizes in axis order), or
    of anything with ``axis_names`` and ``devices.shape``."""
    if mesh is None:
        return None
    shape = mesh.shape
    sizes = ([shape[a] for a in mesh.axis_names] if isinstance(shape, dict)
             else list(mesh.devices.shape))
    return {"axes": list(mesh.axis_names), "shape": [int(s) for s in sizes]}


def plan_fingerprint(params_like, mesh, w: int, compressor: str,
                     compressor_kwargs=(), search: Optional[dict] = None
                     ) -> str:
    """Cache key for one tuning workload.

    ``params_like`` is the (unstacked) parameter tree, ``{path: anything
    with .shape and .dtype}`` (or a nested dict of them); only shapes and
    dtypes enter the hash, so the fingerprint is computable ahead of time
    and identical across hosts.  ``search`` captures the SEARCH SPACE
    (mode restriction, candidate grids, verify depth): a plan found by a
    narrowed search must not satisfy a later full-grid lookup on the same
    workload.
    """
    leaf_sig = [(list(leaf.shape), _dtype_name(leaf.dtype))
                for _, leaf in _leaves(params_like)]
    blob = json.dumps(
        {
            "version": PLAN_VERSION,
            "leaves": leaf_sig,
            "mesh": _mesh_sig(mesh),
            "workers": int(w),
            "compressor": compressor,
            "compressor_kwargs": sorted(
                (str(k), str(v)) for k, v in dict(compressor_kwargs).items()
            ),
            "search": {str(k): str(v)
                       for k, v in sorted((search or {}).items())},
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclass(frozen=True)
class TunePlan:
    """The chosen communication plan (see module docstring).

    ``candidates`` keeps the ranked evidence: one dict per candidate with
    its label, predicted step time, measured step time (None if it was
    ranked out before verification), and wire bytes.
    """

    fingerprint: str
    comm_mode: str
    overlap_bucket_bytes: int
    randk_q: float
    q8_block_rows: int
    efbv_eta: float
    efbv_nu: float
    predicted_step_s: float
    measured_step_s: Optional[float] = None
    moe_wire: str = "none"
    act_wire: str = "none"
    model_wire: str = "none"
    hide_fraction: Optional[float] = None  # overlap hide the search used
    hide_source: str = "nominal"           # "nominal" | "measured"
    omega: Optional[float] = None          # compressor variance the
    #                                        eta/nu derivation used
    omega_source: str = "analytic"         # "measured"|"analytic"|"none"
    candidates: Tuple[dict, ...] = field(default_factory=tuple)
    version: int = PLAN_VERSION

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidates"] = list(d["candidates"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TunePlan":
        if int(d.get("version", -1)) != PLAN_VERSION:
            raise ValueError(
                f"tune plan version {d.get('version')!r} != {PLAN_VERSION} "
                "(re-run the tuner; stale plans must not configure a run)"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown TunePlan fields {sorted(unknown)}")
        d = dict(d)
        d["candidates"] = tuple(d.get("candidates") or ())
        return cls(**d)


def save_plan(plan: TunePlan, path: str) -> str:
    from repro_torch.obs.metrics import sanitize_tree

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(sanitize_tree(plan.to_dict()), f, indent=2, sort_keys=True,
                  allow_nan=False)
    return path


def load_plan(path: str) -> TunePlan:
    with open(path) as f:
        return TunePlan.from_dict(json.load(f))


def cache_path(cache_dir: str, fingerprint: str) -> str:
    return os.path.join(cache_dir, f"tuneplan_{fingerprint[:16]}.json")


def load_cached_plan(cache_dir: str, fingerprint: str) -> Optional[TunePlan]:
    """The cached plan for this fingerprint, or None.  A plan that does
    not load, or whose recorded fingerprint disagrees with its filename
    (hand-edited / copied across workloads), is a miss, not an error."""
    path = cache_path(cache_dir, fingerprint)
    if not os.path.exists(path):
        return None
    try:
        plan = load_plan(path)
    except (ValueError, KeyError, TypeError, json.JSONDecodeError):
        return None
    if plan.fingerprint != fingerprint:
        return None
    return plan


def apply_plan(comp, plan: TunePlan):
    """Resolve a ``CompressionConfig`` through a plan: the concrete
    ``comm_mode`` plus every knob the search optimized.  This is the only
    place ``comm_mode="auto"`` becomes a real mode."""
    return dataclasses.replace(
        comp,
        comm_mode=plan.comm_mode,
        overlap_bucket_bytes=plan.overlap_bucket_bytes,
        randk_q=plan.randk_q,
        q8_block_rows=plan.q8_block_rows,
        efbv_eta=plan.efbv_eta,
        efbv_nu=plan.efbv_nu,
        moe_wire=plan.moe_wire,
        act_wire=plan.act_wire,
        model_wire=plan.model_wire,
    )
