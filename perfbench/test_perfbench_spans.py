"""The reduction of a profiled timeline by the program's spans
(``spans.reduce``), on a timeline written by hand: two steps, each with
the step's phases and, nested inside them, the workers' passes, a wire
send, the round's parts and a garbage collection; the backward pass's
launch on the autograd engine's thread, one graph launch feeding two
kernels, a kernel whose launch the timeline lacks, a ``cudaMalloc``
inside an idle gap.  And the host's issue time of a step whose phases
are spans."""

import pytest

from perfbench import spans, trace


def _timeline():
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "tid": tid, "args": args})

    corr = iter(range(1, 100))

    def launch(ts, kernels, tid=1, call="cudaLaunchKernel"):
        c = next(corr)
        x("cuda_runtime", call, ts, 3, tid, correlation=c)
        for name, a, dur in kernels:
            x("kernel", name, a, dur, correlation=c)

    for s, t0 in enumerate((0.0, 2000.0)):
        x("user_annotation", "bench/step", t0, 1900)
        x("user_annotation", "train/grads", t0, 1000)
        x("user_annotation", "grads/forward", t0 + 10, 290)
        x("cpu_op", "aten::mm", t0 + 20, 10)
        launch(t0 + 22, [("fwd_gemm", t0 + 40, 100)])
        x("user_annotation", "wire/moe", t0 + 150, 100)
        launch(t0 + 160, [("q8_quantize", t0 + 170, 20)])
        # the caching allocator asks for memory: no device activity
        x("cpu_op", "aten::empty", t0 + 255, 80)
        x("cuda_runtime", "cudaMalloc", t0 + 260, 70, correlation=next(corr))
        x("user_annotation", "grads/backward", t0 + 300, 600)
        # the engine's thread: one graph launch, two kernels
        x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
          t0 + 310, 290, tid=2)
        launch(t0 + 320, [("bwd_a", t0 + 400, 100), ("bwd_b", t0 + 500, 100)],
               tid=2, call="cudaGraphLaunch")
        x("user_annotation", "host/gc", t0 + 650, 200)
        x("user_annotation", "train/round", t0 + 1000, 500)
        x("user_annotation", "round/message", t0 + 1000, 200)
        launch(t0 + 1010, [("msg", t0 + 1020, 100)])
        x("user_annotation", "round/aggregate", t0 + 1200, 100)
        launch(t0 + 1210, [("agg", t0 + 1220, 40)])
        # a kernel whose launch the timeline lacks, under the aggregation
        x("kernel", "ring_hop", t0 + 1230, 10, correlation=900 + s)
        x("user_annotation", "round/apply", t0 + 1300, 150)
        x("cpu_op", "aten::add", t0 + 1308, 6)
        launch(t0 + 1310, [("apply", t0 + 1320, 60)])
        x("user_annotation", "train/apply", t0 + 1500, 300)
        x("cpu_op", "aten::_foreach_add_", t0 + 1505, 20)
        launch(t0 + 1510, [("adam", t0 + 1520, 180)])
    return {"traceEvents": ev}


WANT_MS = {"train/grads": 0.32, "grads/forward": 0.12, "wire/moe": 0.02,
           "grads/backward": 0.2, "train/round": 0.21,
           "round/message": 0.1, "round/aggregate": 0.05,
           "round/apply": 0.06, "train/apply": 0.18}


def test_nested_spans_inclusive_and_self():
    s = spans.reduce(_timeline())
    assert s.steps == 2
    for name, ms in WANT_MS.items():
        assert s.ms(name) == pytest.approx(ms, abs=1e-12), name
    # self time: the innermost span's only
    assert 1e3 * s.self_s["grads/forward"] / 2 == pytest.approx(0.1)
    assert 1e3 * s.self_s["wire/moe"] / 2 == pytest.approx(0.02)
    assert "train/grads" not in s.self_s
    assert 1e3 * s.self_s["round/aggregate"] / 2 == pytest.approx(0.05)
    assert s.ms("host/gc") is None
    assert s.ms_of("wire/") == pytest.approx(0.02)


def test_backward_launch_from_another_thread_counted_once():
    s = spans.reduce(_timeline())
    # the engine thread's graph launch lies inside grads/backward in time
    assert s.ms("grads/backward") == pytest.approx(0.2)
    assert s.launches["grads/backward"] == 2            # once a step
    assert s.launches["train/grads"] == 2 * 3
    # seven launches a step: the cudaMalloc feeds no device activity, and
    # the kernel without a launch is not one
    assert s.launches_per_step() == 7


def test_train_phases_equal_reduce_trace():
    tl = _timeline()
    s, summary = spans.reduce(tl), trace.reduce_trace(tl)
    for name in spans.PHASES:
        assert s.ms(name) == pytest.approx(summary.phase_ms_per_step(name),
                                           rel=1e-12), name
    ratios = spans.checks(s, summary)
    assert ratios["round parts/round"] == pytest.approx(1.0)
    assert ratios["passes/grads"] == pytest.approx(1.0)
    assert ratios["wire/forward"] == pytest.approx(0.02 / 0.12)


def test_gap_labels_name_the_cuda_call_and_gc():
    s = spans.reduce(_timeline())
    labels = dict((round(1e6 * sec), label) for label, sec in s.gaps)
    # 600-1020 us: the device idles while the host collects garbage
    assert labels[420].startswith("train/grads>grads/backward>host/gc")
    # 190-400 us: the allocator's cudaMalloc inside aten::empty
    assert labels[210] == ("train/grads>grads/forward; op aten::empty; "
                           "cuda cudaMalloc")
    # 1380-1520 us: Python at the end of the round's apply
    assert labels[140].startswith("train/round>round/apply; after op "
                                  "aten::add (0.136 ms before")
    assert s.gaps[0][1] >= s.gaps[-1][1] and len(s.gaps) == 10


def test_metrics_and_table():
    s = spans.reduce(_timeline())
    host = {"steps": 2, "spans": {
        n: {"count": 2, "total_s": t, "self_s": t / 2, "mean_s": t / 2,
            "parent": None}
        for n, t in (("train/grads", 0.004), ("train/round", 0.002),
                     ("train/apply", 0.001))}}
    got = spans.metrics(s, host)
    assert got == pytest.approx({
        "message_ms": 0.1, "aggregation_ms": 0.05, "shift_apply_ms": 0.06,
        "forward_ms": 0.12, "backward_ms": 0.2, "wire_ms": 0.02,
        "launches_per_step": 7.0, "host_issue_ms": 3.5})
    assert spans.metrics(None, None) == {}
    lines = spans.table(s, host)
    assert lines[0].split() == ["span", "device_ms", "self_ms", "launches",
                                "host_ms", "host_self_ms"]
    assert any(line.startswith("train/grads ") for line in lines)


def test_host_issue_of_a_step_made_of_spans():
    import torch

    from repro_torch.spans import active_recorder, span

    def step(state, batch):
        with span("train/grads"):
            for _ in range(2):
                with span("grads/forward"):
                    y = batch @ state
                with span("grads/backward"):
                    y = y.t() @ batch
        with span("train/round"):
            with span("round/message"):
                y = y + 1
        with span("train/apply"):
            state = state - 1e-3 * y
        return state, None

    state = torch.ones(8, 8)
    host = spans.host_issue(step, state,
                            lambda i: torch.full((8, 8), float(i)), 0, "cpu")
    assert active_recorder() is None
    got = host["spans"]
    assert host["steps"] == spans.HOST_STEPS
    assert got["train/grads"]["count"] == spans.HOST_STEPS
    assert got["grads/forward"]["count"] == 2 * spans.HOST_STEPS
    assert got["grads/forward"]["parent"] == "train/grads"
    assert got["train/grads"]["parent"] is None
    for sp in got.values():
        assert 0.0 <= sp["self_s"] <= sp["total_s"]
    assert spans.metrics(None, host)["host_issue_ms"] > 0.0


def test_traced_run_of_a_smoke_cell_on_the_cpu():
    from perfbench import harness
    from perfbench.smoke import smoke_cell

    profile = harness.profile
    seen = spans.traced_run(smoke_cell("dsv2lite-wires-s128"), 2**31 + 7,
                            0.05, device="cpu", log=lambda line: None)
    assert harness.profile is profile and seen["result"]["correct"]
    # the CPU profiler records no device activity; the host's spans
    assert seen["spans"].steps >= 2 and not seen["spans"].device_s
    host = seen["host"]["spans"]
    for name in ("train/grads", "grads/forward", "grads/backward",
                 "wire/moe", "wire/act", "train/round", "round/message",
                 "round/aggregate", "round/apply", "train/apply"):
        assert host[name]["count"] >= spans.HOST_STEPS, name
    assert host["wire/moe"]["parent"] == "grads/forward"
    assert host["round/aggregate"]["parent"] == "train/round"
    got = spans.metrics(seen["spans"], seen["host"])
    assert set(got) == {"host_issue_ms", "launches_per_step"}
    assert got["launches_per_step"] == 0 and got["host_issue_ms"] > 0


@pytest.mark.parametrize("host_spans", ["recorder", "gc", "both", "none"])
def test_untraced_run_of_a_smoke_cell_with_host_spans(host_spans):
    import gc

    from perfbench.smoke import smoke_cell
    from repro_torch.spans import _on_gc, active_recorder

    result, got = spans.untraced_run(smoke_cell("qwen3-natural-s128"),
                                     2**31 + 11, 0.05, host_spans,
                                     device="cpu", log=lambda line: None)
    assert result["correct"] and "breakdown" not in result
    assert active_recorder() is None and _on_gc not in gc.callbacks
    if host_spans in ("recorder", "both"):
        for name in spans.PHASES + ("grads/forward", "round/message"):
            assert got[name]["count"] >= 1, name
        for sp in got.values():
            assert 0.0 <= sp["self_s"] <= sp["total_s"]
    else:
        assert got == {}
