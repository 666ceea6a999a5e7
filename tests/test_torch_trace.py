"""The port's spans and counters (``sige_torch/utils/trace.py``) on the
CPU, on a tiny window-layout DDPM U-Net (``tests/test_torch_demo.py``'s
TINY: ch 32, ch_mult (1, 2), 32^2):

  * under a CPU ``torch.profiler`` a ``SessionServer`` step records
    ``sige.serving.install`` (holding ``stack`` and ``upload``) and
    ``sige.engine.sparse`` inside ``sige.serving.step``, SIGE op spans
    inside the sparse forward, and ``sige.serving.set_masks``;
  * with no profiler no ``record_function`` is entered at all;
  * ``edits`` and ``plans_built`` count a session's edit and the plans a
    re-pin rebuilds; an unchanged mask counts nothing;
  * ``conv_new_shapes`` counts a repeated forward's convs once and counts
    again after a new window extent.
"""

import numpy as np
import pytest
import torch

from sige_torch.core.masks import dilate_mask, downsample_mask
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.ops import conv2d_nhwc
from sige_torch.parallel import PlanStack, SessionServer
from sige_torch.utils import trace

R = 32
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=R, sparse_resolution_threshold=32)
# interior edits of two window extents, then one that outgrows both
SMALL = [(10, 15, 10, 16), (14, 18, 14, 18)]
LARGE = (6, 22, 8, 26)


def _masks(box):
    m = np.zeros((R, R), bool)
    r0, r1, c0, c1 = box
    m[r0:r1, c0:c1] = True
    return downsample_mask(dilate_mask(m, 2), min_res=4)


def _server(S=2):
    model = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), device="cpu")
    model.init(0)
    server = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)),
                           model.module.state_dict(), bucket_min=1,
                           layout="window", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (S, 1, R, R, 3)).astype(np.float32))
    tb = torch.zeros(S, 1)
    server.prime(x, tb)
    for i in range(S):
        server.set_masks(i, _masks(SMALL[i]))
    return server, x, tb


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("sige.")]


def _inside(e, outer):
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def _within(events, name, parent):
    """Whether every ``name`` span lies inside a ``parent`` span (and
    there is one)."""
    inner = [e for e in events if e.name == name]
    outer = [e for e in events if e.name == parent]
    return bool(inner) and all(any(_inside(e, o) for o in outer)
                               for e in inner)


def test_step_spans_nest_under_a_profiler():
    server, x, tb = _server()
    server.step(x, tb)
    assert trace.span("sige.serving.step") is trace.OFF
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        server.set_masks(0, _masks(SMALL[1]))
        server.step(x, tb)
    events = _spans(prof)
    names = {e.name for e in events}
    assert {"sige.serving.set_masks", "sige.serving.step",
            "sige.serving.install", "sige.serving.stack",
            "sige.serving.upload", "sige.engine.sparse"} <= names
    assert _within(events, "sige.serving.install", "sige.serving.step")
    assert _within(events, "sige.engine.sparse", "sige.serving.step")
    assert _within(events, "sige.serving.stack", "sige.serving.install")
    assert _within(events, "sige.serving.upload", "sige.serving.install")
    ops = [e for e in events if e.name.startswith("sige.op.")]
    sparse = [e for e in events if e.name == "sige.engine.sparse"]
    assert ops and all(any(_inside(e, s) for s in sparse) for e in ops)
    assert {"sige.op.conv", "sige.op.norm", "sige.op.attention",
            "sige.op.chain"} <= {e.name for e in ops}


def test_no_record_function_without_a_profiler(monkeypatch):
    server, x, tb = _server()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    server.step(x, tb)
    server.set_masks(1, _masks(LARGE))
    y = server.step(x, tb)
    assert y.shape == (2, 1, R, R, 3)


def test_plans_built_counts_the_rebuilds_of_a_repin(monkeypatch):
    from sige_torch.parallel import serving

    built = []
    plan = serving.build_plan
    monkeypatch.setattr(serving, "build_plan",
                        lambda *a, **k: built.append(1) or plan(*a, **k))
    model = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), device="cpu")
    model.init(0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, R, R, 3)).astype(np.float32))
    model.full(x, torch.zeros(1))
    stack = PlanStack(model.meta, 2, bucket_min=1, layout="window")
    for i, box in enumerate(SMALL):
        stack.set(i, _masks(box))
    stack.stacked()

    before = trace.snapshot()
    stack.set(1, _masks(LARGE))
    after_set = trace.snapshot()
    assert after_set["edits"] - before["edits"] == 1
    assert after_set["plans_built"] - before["plans_built"] == 1

    plans = list(stack.plans)
    del built[:]
    stack.stacked()
    assert any(a is not b for a, b in zip(plans, stack.plans))  # re-pinned
    assert (trace.snapshot()["plans_built"] - after_set["plans_built"]
            == len(built) > 0)

    unchanged = trace.snapshot()
    assert not stack.set_if_changed(1, _masks(LARGE))
    assert stack.set_if_changed(0, _masks(SMALL[1]))
    now = trace.snapshot()
    assert now["edits"] - unchanged["edits"] == 1
    assert now["plans_built"] - unchanged["plans_built"] == 1


def test_conv_new_shapes_counts_each_key_once(monkeypatch):
    monkeypatch.setattr(trace, "_conv_keys", set())
    model = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)),
                      layout="window", bucket_min=1, device="cpu")
    model.init(0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, R, R, 3)).astype(
        np.float32))
    t = torch.zeros(1)

    def new_shapes(fn):
        before = trace.counters["conv_new_shapes"]
        fn()
        return trace.counters["conv_new_shapes"] - before

    assert new_shapes(lambda: model.full(x, t)) > 0
    assert new_shapes(lambda: model.full(x, t)) == 0
    model.set_masks(_masks(SMALL[0]))
    assert new_shapes(lambda: model.sparse(x, t)) > 0
    assert new_shapes(lambda: model.sparse(x, t)) == 0
    model.set_masks(_masks(LARGE))
    assert new_shapes(lambda: model.sparse(x, t)) > 0
    # outside the engine's fp32_scope a new conv is not counted
    assert new_shapes(lambda: conv2d_nhwc(
        torch.zeros(1, 5, 5, 3), torch.zeros(2, 3, 3, 3), padding=1)) == 0


def test_snapshot_holds_the_launch_counters():
    from sige_torch.ops.flash import flash_mha
    from sige_torch.ops.sessions import crop_sessions, paste_sessions

    snap = trace.snapshot()
    assert snap["flash_launches"] == flash_mha.launches
    assert snap["flash_tc_launches"] == flash_mha.tc_launches
    assert snap["flash_combine_launches"] == flash_mha.combine_launches
    assert snap["crop_launches"] == crop_sessions.launches
    assert snap["paste_scalar_launches"] == paste_sessions.scalar_launches
    assert {"edits", "plans_built", "conv_new_shapes"} <= set(snap)


@pytest.mark.parametrize("name", ["sige.serving.step", "sige.op.conv"])
def test_span_is_a_range_while_recording(name):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span(name):
            torch.ones(2).add_(1)
    assert [e.name for e in prof.events()].count(name) == 1
