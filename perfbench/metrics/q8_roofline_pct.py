"""The q8 kernels' share of their roofline over the profiled steps: the
sum of every launch's bound (``counts.q8``, from the leaf layouts and
the mesh) over the sum of the device times the profiler gave the
launches.  Nothing is read where no q8 kernel ran, or where the
profiler saw another number of launches than the layouts give."""

from perfbench.counts import q8


def read(run):
    s = run.summary
    if s is None or not run.q8_launches:
        return None
    seen = {wrapper: 0 for wrapper in q8.KERNELS.values()}
    device_s = 0.0
    for name, (count, secs) in s.kernels.items():
        wrapper = q8.KERNELS.get(q8.function_name(name))
        if wrapper is not None:
            seen[wrapper] += count
            device_s += secs
    want = q8.launch_counts(run.q8_launches)
    per_step = {k: v / s.steps for k, v in seen.items()}
    run.note(f"q8 launches a step: profiler {per_step}, layouts {want}")
    if device_s <= 0 or any(per_step.get(k, 0) != v for k, v in want.items()):
        return None
    bound_s = s.steps * sum(b for _, b in run.q8_launches) * 1e-3
    return 100.0 * bound_s / device_s
