"""repro_torch.tune -- the cost model of the communication autotuner, the
part of the reference's ``repro/tune`` that observability and the
trainer's ``--metrics_out`` read:

  ``measure``   the alpha-beta link model calibrated by timed
                micro-reduces of the REAL leaf shapes, device compute
                rates, and the measured overlap hide fraction and
                compressor variance.
  ``model``     the step-time predictor: structural ``wire_bits`` from
                each comm mode's own codec + ``plan_buckets`` launch
                counts over a link model.

``plan``, ``search`` and ``autotune`` (with the ``auto`` comm mode)
come in the next slice of the port.
"""

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

__all__ = [
    "Candidate",
    "DEFAULT_MEASURE_BYTES_CAP",
    "DeviceRates",
    "LinkModel",
    "OVERLAP_HIDE",
    "OmegaMeasurement",
    "OverlapMeasurement",
    "StepPrediction",
    "TUNABLE_MODES",
    "calibrate_link",
    "calibrate_rates",
    "comm_time_s",
    "compose_step_s",
    "compute_time_s",
    "encode_time_s",
    "extra_wire_bits",
    "fit_alpha_beta",
    "measure_omega",
    "measure_overlap_hide",
    "measure_subtree",
    "predict_step",
    "predicted_wire_bits",
    "synth_wtree",
    "time_fn",
    "wire_codec",
]
