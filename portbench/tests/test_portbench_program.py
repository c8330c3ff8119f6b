"""The reduction of the program's ``tgq.`` spans (``lib/program.py``) on
synthetic Chrome events, and a traced tiny serve run through
``engine_split.patched`` on the CPU."""
import math

import pytest
import torch

from portbench import engine_split
from portbench.lib import bench, program
from portbench.lib.trace import reduce_events
from portbench.tests import tiny


def x(name, ts, dur, cat="user_annotation", **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if args:
        e["args"] = args
    return e


# the harness's window 0-1000 us; device busy 100-300, 600-700, 950-1000;
# two ticks of the engine, the first around the harness's decode span
HARNESS = [
    x("portbench.window", 0, 1000),
    x("portbench.decode_steps", 70, 320),
    x("cudaLaunchKernel", 80, 5, cat="cuda_runtime", correlation=1),
    x("cudaLaunchKernel", 90, 5, cat="cuda_runtime", correlation=2),
    x("cudaLaunchKernel", 200, 5, cat="cuda_runtime", correlation=3),
    x("k3", 100, 100, cat="kernel", correlation=1),
    x("k5", 150, 150, cat="kernel", correlation=2),
    x("k3", 600, 100, cat="kernel", correlation=3),
    x("copy", 950, 150, cat="gpu_memcpy"),
    x("aten::mul", 120, 30, cat="cpu_op"),
]
PROGRAM = [
    x("tgq.engine.step", 50, 850),
    x("tgq.engine.decode_dispatch", 60, 340),
    x("tgq.engine.fetch", 400, 250),
    x("tgq.engine.fold", 650, 230),
    x("tgq.engine.step", 905, 85),
    x("tgq.engine.schedule", 910, 20),
]


def test_self_seconds_and_counts_of_nested_spans():
    got = program.reduce_program(HARNESS + PROGRAM)["program"]
    want = {"tgq.engine.step": (95, 2), "tgq.engine.decode_dispatch": (340, 1),
            "tgq.engine.fetch": (250, 1), "tgq.engine.fold": (230, 1),
            "tgq.engine.schedule": (20, 1)}
    assert set(got) == set(want)
    for name, (us, n) in want.items():
        assert got[name]["self_s"] == pytest.approx(us * 1e-6, abs=1e-12), name
        assert got[name]["count"] == n


def test_idle_split_is_exact():
    events = HARNESS + PROGRAM
    split = program.reduce_program(events)["idle_by_program"]
    want = {"outside": 55, "tgq.engine.step": 55, "tgq.engine.decode_dispatch": 140,
            "tgq.engine.fetch": 200, "tgq.engine.fold": 180, "tgq.engine.schedule": 20}
    assert split == pytest.approx({k: v * 1e-6 for k, v in want.items()}, abs=1e-12)
    s = reduce_events(events, 1.0)
    assert sum(split.values()) == pytest.approx(s["window_s"] - s["busy_s"], abs=1e-12)


def test_a_span_over_more_than_400_host_ops_keeps_its_idle_time():
    ops = [x("aten::add", 10.5 + 2 * i, 1, cat="cpu_op") for i in range(1000)]
    events = [x("portbench.window", 0, 3000), x("tgq.engine.decode_dispatch", 5, 2500),
              x("k", 0, 1005, cat="kernel"), x("k", 1995, 1005, cat="kernel")] + ops
    # the gap 1005-1995 has its middle between two ops, 745 ops after the span opened
    split = program.reduce_program(events)["idle_by_program"]
    assert split == pytest.approx({"tgq.engine.decode_dispatch": 990e-6}, abs=1e-12)
    assert reduce_events(events, 1.0)["idle_gaps"][0][0] == "host: no operation"


def test_the_program_s_spans_leave_the_harness_s_readings_alone():
    """What the accepted per-layer metrics read is the same with the
    program's spans in the trace as without them."""
    before, after = reduce_events(HARNESS, 1.0), reduce_events(HARNESS + PROGRAM, 1.0)
    for key in ("busy_s", "window_s", "kernels", "spans", "n_kernels", "launch_source",
                "device_ops"):
        assert after[key] == before[key], key
    rec = {"traced_decode_steps": 4}
    for name in ("decode.device_ms_per_step", "decode.launches_per_step",
                 "device.idle_share.serve-decode"):
        read = bench.reader(name).read
        assert read({**rec, "trace": after}) == read({**rec, "trace": before}), name
    assert before["spans"]["decode_steps"]["launches"] == 3


def test_engine_metrics_by_hand():
    p = {"tgq.engine.decode_dispatch": {"self_s": 0.4, "count": 5}}
    idle = {"tgq.engine.decode_dispatch": 0.1, "tgq.engine.fold": 0.03,
            "tgq.engine.step": 0.01, "outside": 0.5}
    m = program.engine_metrics(p, idle, steps=20, chunks=5, spec_chunks=1)
    assert m == pytest.approx({"engine.dispatch_ms_per_step": 20.0,
                               "engine.dispatch_idle_ms_per_step": 5.0,
                               "engine.host_idle_ms_per_step": 2.0,
                               "engine.overlap_share": 20.0, "engine.steps_per_chunk": 4.0})
    # a program without the spans or counters (the parent's) reads nothing
    assert program.engine_metrics({}, {"outside": 1.0}, 20, None, None) == {}


def test_a_traced_tiny_serve_run_is_split_by_the_engine_s_spans():
    c = tiny.cell("qwen3-8b.serve-decode", tiny.QWEN, tiny.CLOSED)
    # the process's first profiler takes seconds to start: not inside the window
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass
    with engine_split.patched({}) as seen:
        tiny.run(c, seconds=1.0, trace=True)
    r = engine_split.report(seen)
    names = {"tgq.engine." + s for s in ("step", "schedule", "decode_dispatch", "fetch", "fold")}
    assert names <= set(r["program"])
    assert r["split_gap"] < 1e-9
    assert r["traced_chunks"] == r["program"]["tgq.engine.decode_dispatch"]["count"] > 0
    assert 0 <= r["traced_spec_chunks"] <= r["traced_chunks"]
    assert set(r["metrics"]) == {"engine.dispatch_ms_per_step", "engine.dispatch_idle_ms_per_step",
                                 "engine.host_idle_ms_per_step", "engine.overlap_share",
                                 "engine.steps_per_chunk"}
    assert all(math.isfinite(v) for v in r["metrics"].values())
