"""Roofline accounting from the step's cost pass -- the port of the
reference's ``repro/launch/hlo_stats.py``.

``roofline`` combines the cost pass's output (``launch.hlo_cost``) with
the NVIDIA H100 SXM5's published rates, ``tune.measure``'s nominal ones
(data sheet): 67 TFLOP/s for f32 products on the CUDA cores (the port's
f32 products run with TF32 off), 989 TFLOP/s dense bf16 on the tensor
cores, HBM3 at 3.35 TB/s, and NVLink 4 at 450 GB/s a direction.  The
reference's are a TPU v5e's.

The reference's ``collective_bytes(text)`` parses HLO.  The port has no
HLO: its counterpart is ``collective_bytes_of(analysis)``, the cost
pass's ``collective_bytes_by_kind`` with the reference's ``_counts`` key
(how many collectives of each kind one round issues, from the same
structural accounting).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.tune.measure import DeviceRates, LinkModel

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def collective_bytes_of(analysis: Dict[str, Any],
                        counts: Optional[Dict[str, int]] = None
                        ) -> Dict[str, Any]:
    """Per-kind bytes of the cost pass's collectives, every kind present
    (zero where none), with ``_counts`` (``counts``: collectives issued
    per kind, zero where not given) -- the shape of the reference's
    ``collective_bytes``."""
    by_kind = analysis.get("collective_bytes_by_kind") or {}
    out: Dict[str, Any] = {k: int(by_kind.get(k, 0)) for k in _COLLECTIVES}
    out["_counts"] = {k: int((counts or {}).get(k, 0)) for k in _COLLECTIVES}
    return out


def roofline(corrected: Dict[str, Any], raw_cost: Dict[str, Any],
             model_flops_global: float, n_chips: int,
             dtype: str = "float32") -> Dict[str, Any]:
    """Three roofline terms (seconds, per card), the reference's keys.

    ``corrected`` is the cost pass's output (``hlo_cost.analyze``);
    ``raw_cost`` stands where the reference keeps XLA's own
    ``cost_analysis()``: the port has none, so it is the pass's own dict
    again (``flops``, ``bytes``).  ``dtype`` picks the product peak.
    """
    rates, link = DeviceRates.nominal(dtype), LinkModel.nominal()
    flops = float(corrected["flops"])
    bytes_hbm = float(corrected["bytes"])
    cbytes = float(corrected["collective_bytes"])
    t_compute = flops / rates.flops_per_s
    t_memory = bytes_hbm / rates.hbm_bytes_per_s
    t_coll = cbytes * link.beta_s_per_byte
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    model_flops_chip = model_flops_global / n_chips
    return {
        **terms,
        "dominant": dom,
        "hlo_flops": flops,
        "hlo_bytes": bytes_hbm,
        "collective_bytes": cbytes,
        "collective_by_kind": corrected["collective_bytes_by_kind"],
        "raw_cost_analysis_flops": float(raw_cost.get("flops", 0.0) or 0.0),
        "raw_cost_analysis_bytes": float(
            raw_cost.get("bytes accessed", 0.0)
            or raw_cost.get("bytes", 0.0) or 0.0
        ),
        "model_flops_global": model_flops_global,
        "model_flops_per_chip": model_flops_chip,
        "useful_flops_frac": (model_flops_chip / flops) if flops else 0.0,
        "unresolved_whiles": corrected["unresolved_whiles"],
    }
