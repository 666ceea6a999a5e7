"""The port's ``PlanStack`` against ``sige_tpu.parallel.PlanStack`` on the
same meta (a full pass of ``tests/test_torch_demo.py``'s TINY U-Net:
ch 32, ch_mult (1, 2), 32^2) and the same sequences of per-session mask
pyramids, in the window and tile layouts: the stacked trees equal leaf
for leaf and exactly, with ``pins``, ``win_pins``, ``meta_fast`` and the
return values of ``set_if_changed``, through compact edits, a spread
edit that re-pins, a border edit that meets interior ones (the 4-form
flip) and an unchanged pyramid. Also ``stacked()``'s identity and
``upload_reuse`` on the CPU.
"""

import numpy as np
import pytest
import torch

from sige_torch.core.masks import dilate_mask, downsample_mask
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.engine import plan_leaves, upload_plan
from sige_torch.parallel import PlanStack, upload_reuse
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


def test_stacked_is_the_same_object_until_a_set(meta):
    stack = PlanStack(meta, 2, bucket_min=1, layout="window")
    stack.set(0, _masks(COMPACT[0]))
    stack.set(1, _masks(COMPACT[1]))
    first = stack.stacked()
    assert stack.stacked() is first
    assert not stack.set_if_changed(0, _masks(COMPACT[0]))
    assert stack.stacked() is first
    stack.set(0, _masks(COMPACT[0]))  # a set restacks, even unchanged
    assert stack.stacked() is not first


def test_upload_reuse_keeps_unchanged_leaves(meta):
    stack = PlanStack(meta, S, bucket_min=1, layout="window")
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
    host1 = stack.stacked()
    dev1 = upload_reuse("cpu", None, None, host1)
    _assert_equal_upload(dev1, host1)
    # session 2 moves its edit by a few pixels: few leaves change
    stack.set(2, _masks((11, 16, 20, 26)))
    host2 = stack.stacked()
    dev2 = upload_reuse("cpu", host1, dev1, host2)
    _assert_equal_upload(dev2, host2)
    old, new = _flat(dev1), _flat(dev2)
    a, b = dict(plan_leaves(host1)), dict(plan_leaves(host2))
    kept = 0
    for k in b:
        same = (a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                and np.array_equal(a[k], b[k]))
        assert (new[k] is old[k]) == same, k
        kept += same
    assert 0 < kept < len(b)
    # another tree structure uploads everything afresh
    dev3 = upload_reuse("cpu", {"x": np.zeros(2)}, {"x": torch.zeros(2)},
                        host2)
    assert not any(v is new[k] for k, v in _flat(dev3).items())


def test_upload_reuse_holds_at_most_two_buffers(meta):
    """Over a run of moved edits, every upload equals ``upload_plan``'s,
    keeps only unchanged leaves (some on every upload) and leaves the
    plan in at most two packed buffers: a kept leaf pins its whole
    buffer."""
    stack = PlanStack(meta, S, bucket_min=1, layout="window")
    for i, box in enumerate(COMPACT):
        stack.set(i, _masks(box))
    host = stack.stacked()
    dev = upload_reuse("cpu", None, None, host)
    # moves of mixed sizes: a big move changes leaves that a small one
    # after it keeps, so kept leaves come from more than one earlier upload
    for n, d in enumerate((4, 1, 6, 1, 2, 1)):
        r0, r1, c0, c1 = COMPACT[n % S]
        stack.set(n % S, _masks((r0 + d, r1 + d, c0 - d, c1 - d)))
        host2 = stack.stacked()
        dev2 = upload_reuse("cpu", host, dev, host2)
        _assert_equal_upload(dev2, host2)
        old, new = _flat(dev), _flat(dev2)
        a, b = dict(plan_leaves(host)), dict(plan_leaves(host2))
        kept = 0
        for k, t in new.items():
            if t is old.get(k):
                assert np.array_equal(a[k], b[k]), k
                kept += 1
        assert kept > 0, n
        bufs = {t.untyped_storage().data_ptr() for t in new.values()}
        assert len(bufs) <= 2, (n, len(bufs))
        host, dev = host2, dev2


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


def _assert_equal_upload(dev, host):
    got, want = _flat(dev), _flat(upload_plan(host, torch.device("cpu")))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
