"""Device time a step of the kernels launched inside the step's
``train/apply`` annotation: AdamW's update of the params and moments."""


def read(run):
    return run.phase_ms("train/apply")
