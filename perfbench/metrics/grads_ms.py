"""Device time a step of the kernels launched inside the step's
``train/grads`` annotation: the workers' forward and backward passes,
with the moe and act wires' sends where a cell sets them."""


def read(run):
    return run.phase_ms("train/grads")
