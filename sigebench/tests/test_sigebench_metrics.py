"""The yardstick's arithmetic on synthetic numbers and traces."""

import math

import numpy as np
import pytest
import torch

from sigebench import metrics
from sigebench.harness import Record, Reservoir, verdict
from sigebench.layers import reader
from sigebench.trace import CallLog, Trace, reduce, span_table


def test_p95_is_over_every_step_and_rate_over_the_whole_window():
    steps = [0.010] * 95 + [0.100] * 5
    assert metrics.p95_ms(steps) == pytest.approx(
        np.percentile(np.array(steps) * 1e3, 95))
    # one slow step in a hundred moves the p95 of all steps, not of a chunk
    assert metrics.p95_ms([0.01] * 94 + [1.0] * 6) > 10
    assert metrics.session_steps_per_s(8, 100, 4.0) == 200.0


def test_idle_is_the_union_of_kernel_intervals():
    ivals = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert metrics.union_s(ivals) == 15 + 11 + 1
    assert metrics.gaps(ivals, 0, 50) == [(15, 20), (31, 40), (41, 50)]
    t = Trace(window_s=50.0, busy_s=27.0, conv_s=0, flash_s=0, session_s=0,
              flash_bound_s=0, session_bytes=0, device_ops=[], idle_gaps=[])
    rec = Record(sessions=1, trace=t, trace_steps=1)
    assert reader("device_idle")(rec) == pytest.approx(100 * 23 / 50)


def test_flash_roofline_formula():
    B, N, M, H, D, rows = 8, 4096, 4096, 8, 40, 4
    flops = 4 * B * H * N * M * D
    nbytes = 4 * (2 * B * N * H * D + 2 * B * M * H * D + rows * M)
    assert metrics.flash_flops(B, N, M, H, D) == flops
    assert metrics.flash_bytes(B, N, M, H, D, rows) == nbytes
    assert metrics.flash_bound_s(B, N, M, H, D, rows) == pytest.approx(
        max(flops / 495e12, nbytes / 3.35e12))
    calls = CallLog()
    calls.flash = [(B, N, M, H, D, rows)] * 3
    t = Trace(window_s=1, busy_s=1, conv_s=0, flash_s=0.01, session_s=0,
              flash_bound_s=calls.flash_bound_s(), session_bytes=0,
              device_ops=[], idle_gaps=[])
    share = reader("flash_roofline")(Record(sessions=1, trace=t,
                                            trace_steps=1))
    assert share == pytest.approx(100 * 3 * flops / 495e12 / 0.01)


def test_session_kernels_bytes_once_in_once_out():
    calls = CallLog()
    # two sessions' 8x8 windows on a 2-sample 16x16 map with 4 channels:
    # session 0 inside, session 1 half above the top border
    org = torch.tensor([[2, 2], [-4, 6]])
    calls.crop = [{"x": (4, 16, 16, 4), "elem": 4, "EH": 8, "EW": 8,
                   "org": org, "clamp": False}]
    calls.paste = [{"base": (4, 16, 16, 4), "elem": 4, "in_elem": 4}]
    out = 4 * 8 * 8 * 4 * 4
    read = 2 * 4 * 4 * (64 + 32)
    paste = 2 * (4 * 16 * 16 * 4 * 4)
    assert calls.session_bytes() == out + read + paste
    # a 4-form meta: the virtual origin is meta[:, :2] - meta[:, 2:4]
    calls.paste = []
    calls.crop[0]["org"] = torch.tensor([[3, 3, 1, 1], [0, 6, 4, 0]])
    assert calls.session_bytes() == out + read
    t = Trace(window_s=1, busy_s=1, conv_s=0, flash_s=0, session_s=1e-6,
              flash_bound_s=0, session_bytes=out + read, device_ops=[],
              idle_gaps=[])
    assert reader("sessions_roofline")(Record(sessions=2, trace=t,
                                              trace_steps=1)) == \
        pytest.approx(100 * (out + read) / 3.35e12 / 1e-6)


def test_in_image_clamps_like_the_kernels():
    o = np.array([[-3, 0], [10, 12]])
    assert metrics.in_image(o, 2, 16, 16, 8, 8, clamp=False) == 5 * 8 + 6 * 4
    assert metrics.in_image(o, 2, 16, 16, 8, 8, clamp=True) == 2 * 64


def test_needed_flops_scales_sparse_regions_by_their_mask():
    by = {None: 100.0, (8, 8): 40.0, (4, 4): 10.0}
    assert metrics.needed_flops(by, {(8, 8): 0.25, (4, 4): 0.5}) == 115.0
    rec = Record(sessions=2, window_s=2.0, step_entries=[[0, 1], [1, 1]],
                 flops=[[1e12, 2e12], [3e12, 4e12]])
    assert reader("step_mfu")(rec) == pytest.approx(
        100 * (1e12 + 4e12 + 2e12 + 4e12) / (2.0 * 495e12))


def test_verdict_counts_non_finite_and_over_limit():
    assert verdict([1e-6, 2e-6], 1e-5) == (True, 0)
    assert verdict([1e-6, math.inf], 1e-5) == (False, 1)
    assert verdict([1e-6, math.nan, 1.0], 1e-5) == (False, 2)
    assert verdict([], 1e-5) == (False, 0)


def test_reservoir_is_seeded_and_keeps_its_size():
    def draw(seed):
        r = Reservoir(4, seed)
        for k in range(200):
            r.offer(lambda: k)
        return sorted(r.kept)
    assert draw(5) == draw(5) and draw(5) != draw(6)
    assert len(draw(5)) == 4


class _Event:
    def __init__(self, name, a, b, cuda=False):
        self.name, self.kernels = name, []
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("Range", (), {"start": a, "end": b})()


def test_reduce_carries_the_program_spans_and_labels_gaps_by_the_innermost():
    host = [("sigebench.window", 0, 1000), ("sigebench.step", 100, 400),
            ("sige.serving.step", 110, 390),
            ("sige.serving.install", 110, 150),
            ("sige.engine.sparse", 150, 380), ("sige.op.conv", 200, 250),
            ("sigebench.set_masks", 500, 700),
            ("sige.serving.set_masks", 510, 690),
            ("sigebench.step", 800, 990),
            ("sige.serving.step", -50, -10)]  # before the window
    dev = [(0, 160), (180, 300), (320, 500), (720, 950), (960, 1000)]
    events = [_Event(*h) for h in host] + [
        _Event("kernel", a, b, cuda=True) for a, b in dev] + [
        _Event("sigebench.step", 100, 400, cuda=True)]  # a mirrored range
    prof = type("Prof", (), {"events": lambda self: events})()
    t = reduce(prof, CallLog())
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(730e-6)
    # the gaps inside sige.engine.sparse: 160-180 and 300-320
    assert t.forward_idle_s == pytest.approx(40e-6)
    assert [g[0] for g in t.idle_gaps] == [
        "sige.serving.set_masks", "sige.engine.sparse", "sige.engine.sparse",
        "step"]  # the last under sigebench.step alone
    assert [g[1] for g in t.idle_gaps] == pytest.approx(
        [220e-6, 20e-6, 20e-6, 10e-6])
    table = t.spans
    assert table["sige.serving.step"] == [1, pytest.approx(280e-6),
                                          pytest.approx(10e-6)]
    assert table["sige.engine.sparse"] == [1, pytest.approx(230e-6),
                                           pytest.approx(180e-6)]
    assert table["sigebench.step"] == [2, pytest.approx(490e-6),
                                       pytest.approx(210e-6)]
    # the program's rows are its spans' own table: no harness span nests
    # inside a program span
    program = [h for h in host if h[0].startswith("sige.") and h[1] >= 0]
    assert {n: v for n, v in table.items() if n.startswith("sige.")} == \
        span_table(program)
