"""The span reductions of ``sigebench/trace.py`` and the readers of the
port's spans and counters, on synthetic spans and records; then a tiny
DDPM cell run on the CPU with the program's spans and counters on its
record."""

import json
import time
from pathlib import Path

import pytest
import torch

from sigebench import harness, spans, trace
from sigebench.layers import reader
from tiny import cell

ROOT = Path(__file__).resolve().parents[2]
#: the per-layer metrics that read what the program records
PROGRAM_READ = [m["name"] for m in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"]
    if m["source"] in ("program_span", "program_counter")]


def test_span_table_counts_calls_total_and_self():
    table = trace.span_table([
        ("sige.serving.step", 0, 100),
        ("sige.serving.install", 0, 30),
        ("sige.serving.stack", 5, 15),
        ("sige.serving.upload", 15, 25),
        ("sige.engine.sparse", 30, 95),
        ("sige.op.conv", 40, 50),
        ("sige.op.conv", 60, 75),
        ("sige.serving.step", 200, 260),
        ("sige.serving.install", 200, 202),
        ("sige.engine.sparse", 202, 259)])
    assert table["sige.serving.step"] == [2, 160e-6, pytest.approx(6e-6)]
    assert table["sige.serving.install"] == [2, 32e-6,
                                             pytest.approx(12e-6)]
    assert table["sige.engine.sparse"] == [2, 122e-6, pytest.approx(97e-6)]
    assert table["sige.op.conv"] == [2, 25e-6, 25e-6]


def test_idle_inside_spans_is_an_intersection():
    gaps = [(0, 10), (20, 40), (50, 55)]
    sparse = [(5, 25), (35, 60)]
    # 5 of the first gap, 5 + 5 of the second, all 5 of the third
    assert trace.overlap_s(gaps, sparse) == pytest.approx(20e-6)
    assert trace.overlap_s(gaps, []) == 0.0
    # overlapping intervals count once
    assert trace.overlap_s([(0, 10)], [(0, 6), (4, 8)]) == pytest.approx(
        8e-6)


def test_gap_label_is_the_innermost_span():
    host = [("sigebench.step", 0, 100), ("sige.serving.step", 1, 99),
            ("sige.serving.install", 2, 40), ("sigebench.set_masks",
                                              110, 130)]
    assert trace.label(trace.innermost(20, host)) == "sige.serving.install"
    assert trace.label(trace.innermost(60, host)) == "sige.serving.step"
    # under the harness's span alone the label stays as it was
    assert trace.label(trace.innermost(99.5, host)) == "step"
    assert trace.label(trace.innermost(120, host)) == "set_masks"
    assert trace.label(trace.innermost(105, host)) == "other"


def _record(span_rows=None, forward_idle_s=0.0, counters=None, steps=200):
    t = trace.Trace(window_s=1.0, busy_s=1.0, conv_s=0, flash_s=0,
                    session_s=0, flash_bound_s=0, session_bytes=0,
                    device_ops=[], idle_gaps=[], spans=span_rows or {},
                    forward_idle_s=forward_idle_s)
    return harness.Record(sessions=8, steps=steps, trace=t, trace_steps=25,
                          counters=counters)


def test_the_five_readers():
    rows = {"sige.serving.install": [25, 0.1, 0.02],
            "sige.engine.sparse": [25, 0.5, 0.3],
            "sige.kernel.crop": [2500, 0.05, 0.05],
            "sige.kernel.paste": [1500, 0.03, 0.03]}
    rec = _record(rows, 0.25, {"edits": 60, "plans_built": 66,
                               "conv_new_shapes": 4})
    assert reader("install_ms")(rec) == pytest.approx(4.0)
    assert reader("forward_idle_ms")(rec) == pytest.approx(10.0)
    assert reader("sessions_launch_us")(rec) == pytest.approx(20.0)
    assert reader("plans_per_edit")(rec) == pytest.approx(1.1)
    assert reader("conv_new_shapes")(rec) == pytest.approx(20.0)
    # no idle inside the forward reads 0, not nothing
    assert reader("forward_idle_ms")(_record(rows, 0.0)) == 0.0


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_readers_find_nothing_without_spans_or_counters(name):
    """A record of an untraced run against a program without counters,
    and a traced one against a program that records nothing."""
    bare = harness.Record(sessions=8, steps=200, trace_steps=25)
    assert reader(name)(bare) is None
    assert reader(name)(_record({}, 0.0, None)) is None


def test_program_readers_are_in_the_manifest():
    assert {"install_ms", "forward_idle_ms", "sessions_launch_us",
            "plans_per_edit", "conv_new_shapes"} <= set(PROGRAM_READ)


def test_a_tiny_cell_carries_the_program_spans_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        c_ = cell("ddpm_church256", "window_s8")
        out = harness.run_cell(c_, 2**31 + 5, 0.3, True, "cpu",
                               time.perf_counter(), cache_dir=None)
    finally:
        torch.set_num_threads(n)
    rec = out["record"]
    c = rec.counters
    # the timed window's counters, and each of its sends one edit
    assert c is not None and c["edits"] == len(rec.plan_s) > 0
    assert c["plans_built"] >= c["edits"]
    table = rec.trace.spans
    steps = table["sige.serving.step"][0]
    assert steps == rec.trace_steps  # one a traced step
    assert table["sige.engine.sparse"][0] == steps
    assert table["sige.serving.install"][0] == steps
    for name in ("install_ms", "forward_idle_ms", "plans_per_edit",
                 "conv_new_shapes"):
        assert reader(name)(rec) is not None, name
    # no session kernel runs on the CPU
    assert reader("sessions_launch_us")(rec) is None
    line = spans.result_line(c_, out)
    assert line["correct"]
    # DDPM's cell reads the step's tail and what moves it as host-paced
    assert set(line["metrics"]) >= {
        "install_ms.host_paced", "forward_idle_ms",
        "plans_per_edit.host_paced", "conv_new_shapes.host_paced",
        "enqueue_ms", "plan_ms.host_paced", "step_ms_p95.host_paced"}
    means = line["step_mean_ms"]
    assert means["sige.serving.step"] <= means["sigebench.step"]
    assert line["spans"]["sige.serving.step"][0] == 1.0
