"""The port's ``PlanStack`` against ``sige_tpu.parallel.PlanStack`` on the
same meta (a full pass of ``tests/test_torch_demo.py``'s TINY U-Net:
ch 32, ch_mult (1, 2), 32^2) and the same sequences of per-session mask
pyramids, in the window and tile layouts: the stacked trees equal leaf
for leaf and exactly, with ``pins``, ``win_pins``, ``meta_fast`` and the
return values of ``set_if_changed``, through compact edits, a spread
edit that re-pins, a border edit that meets interior ones (the 4-form
flip) and an unchanged pyramid. Then, on the CPU, the resident plan
(``ResidentPlan``): after every install the device holds byte for byte
what ``upload_plan`` of a fresh restack gives, conforming edits write
their rows in place and take the row path, a re-pin and the 4-form flip
the full one, and a rank moves only its own rows.
"""

import numpy as np
import pytest
import torch

from sige_torch.core.masks import dilate_mask, downsample_mask
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.engine import upload_plan
from sige_torch.nn.planner import plan_leaves, plan_rows, stack_plans
from sige_torch.parallel import PlanStack, ResidentPlan
from sige_torch.utils import trace
from sige_tpu.parallel import PlanStack as JPlanStack
from test_torch_demo import TINY

R, S = 32, 3
# interior edits (every window meta in the 2-form) of two window extents
COMPACT = [(10, 15, 10, 16), (14, 18, 14, 18), (8, 14, 14, 20)]
# (session, box): a spread edit, the same box again, a border edit, then a
# compact edit back in session 1
SEQUENCE = [(1, (4, 26, 6, 28)), (1, (4, 26, 6, 28)), (2, (0, 6, 24, 32)),
            (1, (12, 18, 12, 18))]


@pytest.fixture(scope="module")
def meta():
    model = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), device="cpu")
    model.init(0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, R, R, 3)).astype(np.float32))
    model.full(x, torch.zeros(1))
    return model.meta


def _masks(box):
    m = np.zeros((R, R), bool)
    r0, r1, c0, c1 = box
    m[r0:r1, c0:c1] = True
    return downsample_mask(dilate_mask(m, 2), min_res=4)


def _flat(tree, path=()):
    """{path: leaf} of a plan tree, the leaves as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _assert_same(got: PlanStack, want: JPlanStack, note):
    a, b = (dict(plan_leaves(s.stacked())) for s in (got, want))
    assert a.keys() == b.keys(), note
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (note, k)
        assert np.array_equal(a[k], b[k]), (note, k)
    assert got.pins == want.pins, note
    assert got.win_pins == want.win_pins, note
    assert got.meta_fast == want.meta_fast, note


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_plan_stack_matches_sige_tpu(meta, layout):
    got = PlanStack(meta, S, bucket_min=1, layout=layout)
    want = JPlanStack(meta, S, bucket_min=1, layout=layout)
    with pytest.raises(RuntimeError, match="missing"):
        got.stacked()
    for i, box in enumerate(COMPACT):
        got.set(i, _masks(box))
        want.set(i, _masks(box))
    _assert_same(got, want, "compact")
    if layout == "window":
        assert got.win_pins and got.meta_fast
    for n, (i, box) in enumerate(SEQUENCE):
        changed = got.set_if_changed(i, _masks(box))
        assert changed == want.set_if_changed(i, _masks(box)), n
        assert changed == (n != 1)  # the repeated pyramid plans nothing
        _assert_same(got, want, f"step {n}")
    assert got.pins  # the spread edit re-pinned the capacities
    if layout == "window":
        # the border edit met interior ones: the 4-form for everyone
        assert not got.meta_fast


# moves of mixed sizes, session by session: some keep the pinned shapes
MOVES = (4, 1, 6, 1, 2, 1)


def _moved(n):
    r0, r1, c0, c1 = COMPACT[n % S]
    d = MOVES[n]
    return n % S, _masks((r0 + d, r1 + d, c0 - d, c1 - d))


def _buffer(t):
    """The whole byte buffer a packed leaf is a view of."""
    return torch.empty(0, dtype=torch.uint8).set_(t.untyped_storage())


def _assert_installed(plan: ResidentPlan, stack: PlanStack, note):
    """The resident trees equal a fresh restack and its ``upload_plan``:
    the host tree leaf for leaf, the device buffer byte for byte (padding
    included) and every device leaf in dtype, shape and value."""
    host = plan_rows(stack_plans(stack.plans), plan.rows)
    got, want = dict(plan_leaves(plan.host)), dict(plan_leaves(host))
    assert got.keys() == want.keys(), note
    for k in want:
        assert got[k].dtype == want[k].dtype, (note, k)
        assert np.array_equal(got[k], want[k]), (note, k)
    dev = upload_plan(host, torch.device("cpu"))
    _assert_equal_upload(plan.tree, dev, note)
    assert torch.equal(plan.buf, _buffer(next(iter(_flat(dev).values())))), \
        note


def _install(plan, stack):
    """One install; which counter it moved: "row", "full" or None."""
    before = dict(trace.counters)
    plan.update(stack)
    row = trace.counters["plan_row_installs"] - before["plan_row_installs"]
    full = trace.counters["plan_full_installs"] - before["plan_full_installs"]
    assert row + full <= 1
    return "row" if row else "full" if full else None


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_row_install_equals_full_upload(meta, layout):
    """Through the compact edits, the sequence (a spread edit, the same
    pyramid again, a border edit, a compact one) and a run of moved
    edits, every install leaves the device holding what ``upload_plan``
    of a fresh restack gives, and the host tree equal to that restack."""
    stack = PlanStack(meta, S, bucket_min=1, layout=layout)
    plan = ResidentPlan("cpu", slice(0, S))
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
        if i == S - 1:
            assert _install(plan, stack) == "full"
    _assert_installed(plan, stack, "compact")
    paths = set()
    for n, (i, box) in enumerate(SEQUENCE):
        stack.set_if_changed(i, _masks(box))
        paths.add(_install(plan, stack))
        _assert_installed(plan, stack, f"step {n}")
    for n in range(len(MOVES)):
        stack.set(*_moved(n))
        paths.add(_install(plan, stack))
        _assert_installed(plan, stack, f"move {n}")
    assert {"row", "full"} <= paths


def test_installs_count_their_path(meta):
    """Conforming edits take the row path and keep the device buffer; an
    edit that outgrows the pins (a re-pin) and the border edit (the
    4-form flip) take the full path; an unchanged pyramid writes
    nothing."""
    stack = PlanStack(meta, S, bucket_min=1, layout="window")
    plan = ResidentPlan("cpu", slice(0, S))
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
    assert _install(plan, stack) == "full"
    buf = plan.buf.untyped_storage().data_ptr()
    tree = plan.tree
    stack.set(0, _masks((11, 15, 11, 16)))  # a smaller edit: same shapes
    assert _install(plan, stack) == "row"
    stack.set(1, _masks((15, 19, 13, 17)))
    assert _install(plan, stack) == "row"
    assert plan.buf.untyped_storage().data_ptr() == buf
    assert plan.tree is tree
    assert all(t.untyped_storage().data_ptr() == buf
               for t in _flat(plan.tree).values())
    assert _install(plan, stack) is None  # nothing set since
    versions = list(stack.row_versions)
    assert not stack.set_if_changed(1, _masks((15, 19, 13, 17)))
    assert _install(plan, stack) is None
    assert stack.row_versions == versions
    pins = dict(stack.pins)
    stack.set(1, _masks((10, 17, 10, 18)))  # outgrows the pins: re-pin
    assert _install(plan, stack) == "full"
    assert stack.pins != pins
    assert stack.meta_fast
    stack.set(*SEQUENCE[2][:1], _masks(SEQUENCE[2][1]))  # border: 4-form
    assert _install(plan, stack) == "full"
    assert not stack.meta_fast
    _assert_installed(plan, stack, "after the flip")


def test_stacked_follows_edits_in_place(meta):
    """``stacked()`` is one tree across conforming edits, its rows
    rewritten in place to equal ``stack_plans(plans)``; only the edited
    session's row version moves."""
    stack = PlanStack(meta, S, bucket_min=1, layout="window")
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
    first = stack.stacked()
    held = dict(plan_leaves(first))
    assert stack.stacked() is first
    stack.set(2, _masks((9, 14, 15, 20)))
    assert stack.stacked() is first
    assert stack.row_versions == [0, 0, 1]
    want = dict(plan_leaves(stack_plans(stack.plans)))
    assert held.keys() == want.keys()
    changed = 0
    for k, a in dict(plan_leaves(first)).items():
        assert a is held[k]  # the same arrays, written in place
        assert np.array_equal(a, want[k]), k
        changed += not np.array_equal(a[2], a[0])
    assert changed
    stack.set(2, _masks((9, 14, 15, 20)))  # a set rewrites, even unchanged
    assert stack.stacked() is first and stack.row_versions == [0, 0, 2]


def test_rank_rows_move_only_their_own(meta):
    """A rank's resident plan holds its rows alone (``mesh.rows``): an
    edit outside them is written into the host tree and moves nothing to
    the device; an edit inside moves its row."""
    stack = PlanStack(meta, S, bucket_min=1, layout="window")
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
    plan = ResidentPlan("cpu", slice(1, 2))
    assert _install(plan, stack) == "full"
    before = plan.buf.clone()
    stack.set(0, _masks((11, 15, 11, 16)))
    assert _install(plan, stack) == "row"
    assert torch.equal(plan.buf, before)
    _assert_installed(plan, stack, "outside")
    stack.set(1, _masks((15, 19, 13, 17)))
    assert _install(plan, stack) == "row"
    assert not torch.equal(plan.buf, before)
    _assert_installed(plan, stack, "inside")
    assert all(a.shape[0] == 1 for _, a in plan_leaves(plan.host))


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_upload_plan_is_one_buffer_of_the_leaves(meta, layout):
    """``upload_plan`` moves a stacked plan as views of ONE buffer that
    holds the leaves' own bytes (bool masks at a byte an element), up to
    8-byte alignment, and nothing else."""
    stack = PlanStack(meta, S, bucket_min=1, layout=layout)
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
    dev = _flat(upload_plan(stack.stacked(), torch.device("cpu")))
    # window plans hold coverage and edge masks beside the int leaves
    assert {t.dtype for t in dev.values()} == (
        {torch.int64, torch.bool} if layout == "window" else {torch.int64})
    bufs = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in dev.values()}
    leaf_bytes = sum(t.nbytes for t in dev.values())
    assert len(bufs) == 1
    assert leaf_bytes <= sum(bufs.values()) < leaf_bytes + 8 * len(dev)


def _assert_equal_upload(dev, want, note=None):
    got, want = _flat(dev), _flat(want)
    assert got.keys() == want.keys(), note
    for k in want:
        assert got[k].dtype == want[k].dtype, (note, k)
        assert torch.equal(got[k], want[k]), (note, k)
