"""The reduction of a profiled timeline (``trace.reduce_trace``) and the
readers over it, on a timeline written by hand: two steps, each with
its gradients, round and apply annotations, kernels launched inside
them (one whose launch the timeline lacks), and idle gaps."""

from perfbench import harness, trace


def _timeline():
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "args": args})

    corr = iter(range(1, 100))
    for s, t0 in enumerate((0.0, 1000.0)):
        x("user_annotation", "bench/step", t0, 900)
        for name, a, b, kern in (("train/grads", 0, 500, "gemm"),
                                 ("train/round", 500, 800,
                                  "q8_quantize_kernel"),
                                 ("train/apply", 800, 900, "adam")):
            x("user_annotation", name, t0 + a, b - a)
            x("cpu_op", "aten::launch", t0 + a + 1, 5)
            c = next(corr)
            x("cuda_runtime", "cudaLaunchKernel", t0 + a + 2, 3, correlation=c)
            x("kernel", kern, t0 + a + 10, (b - a) / 2, correlation=c)
        # a kernel whose launch the timeline lacks, inside the round's span
        x("kernel", "q8_dequant_add_kernel", t0 + 520, 10, correlation=999 + s)
    return {"traceEvents": ev}


def test_reduce_trace():
    s = trace.reduce_trace(_timeline())
    assert s.steps == 2
    assert abs(s.phase_ms_per_step("train/grads") - 250e-3) < 1e-9
    assert abs(s.phase_ms_per_step("train/round") - 160e-3) < 1e-9
    assert abs(s.phase_ms_per_step("train/apply") - 50e-3) < 1e-9
    assert s.kernels["q8_quantize_kernel"][0] == 2
    assert abs(s.window_s - 1.9e-3) < 1e-12
    assert abs(s.busy_s - 2 * (250 + 150 + 50) * 1e-6) < 1e-12
    assert len(s.gaps) <= 10 and s.gaps[0][1] >= s.gaps[-1][1]
    assert all(isinstance(g[0], str) for g in s.gaps)
    assert s.device_ops()[0][0] == "gemm"


def test_readers_over_the_reduction():
    s = trace.reduce_trace(_timeline())
    run = harness.Run(s, 2e12, 10, 2.0, [("q8_quantize_2d", 0.05),
                                          ("q8_dequant_add_2d", 0.002)])
    assert abs(harness.reader("grads_ms")(run) - 0.25) < 1e-9
    idle = harness.reader("device_idle_pct")(run)
    assert 0 < idle < 100
    assert abs(harness.reader("mfu_pct")(run) - 100 * 1e13 / 67e12) < 1e-9
    # two launches a step, as the layouts say; bound 0.052 ms over 0.16 ms
    roof = harness.reader("q8_roofline_pct")(run)
    assert abs(roof - 100 * 0.052 / 0.160) < 1e-9
    run.q8_launches.append(("q8_quantize_chunk_3d", 0.01))
    assert harness.reader("q8_roofline_pct")(run) is None
    empty = harness.Run(None, 1.0, 1, 1.0, [])
    assert harness.reader("round_ms")(empty) is None
    assert harness.reader("device_idle_pct")(empty) is None
