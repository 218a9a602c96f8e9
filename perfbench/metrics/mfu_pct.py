"""The model FLOPs of the traced run's unprofiled steps (``counts.flops``)
over their wall time, as a share of the card's f32 peak."""

from perfbench.counts import peaks


def read(run):
    if not run.window_steps or run.window_s <= 0:
        return None
    rate = run.flops_per_step * run.window_steps / run.window_s
    return 100.0 * rate / peaks.F32_FLOPS_PER_S
