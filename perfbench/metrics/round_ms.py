"""Device time a step of the kernels launched inside the step's
``train/round`` annotation: the messages, their aggregation and the
shifts' update."""


def read(run):
    return run.phase_ms("train/round")
