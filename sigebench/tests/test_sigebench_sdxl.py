"""The SDXL cell on the CPU at its family's tiny cut: the harness runs it
and the plain reference agrees with the program's stacked sessions;
planted faults of the SDXL path (the middle on stale statistics, the
deeper blocks given block 0's keys and values) turn ``correct`` false;
its two new readers read a traced record; the cell sets up at full size,
where the sessions' first edits give equal window extents."""

import time

import pytest
import torch

from sige_torch.models.sd.unet import SIGESpatialTransformer
from sigebench import harness
from sigebench.layers import reader
from tiny import cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(c, seed, hook=None, trace=False):
    out = harness.run_cell(c, seed, 0.3, trace, "cpu", time.perf_counter(),
                           server_hook=hook, cache_dir=None)
    limit = float(c.config["limit"]["max_rel_err"])
    return out, harness.verdict(out["compared"]["errs"], limit)


@pytest.mark.parametrize("traffic,mix", [
    ("unet_window_s4", {}),
    ("tiles_s8", {"model": "unet", "area": [0.01, 0.03]})],
    ids=["window", "tiles"])
def test_the_tiny_cell_is_correct(traffic, mix):
    c = cell("sdxl_1024", traffic, **mix)
    out, (correct, failed) = _run(c, 2**31 + 11)
    assert correct and failed == 0, out["compared"]["errs"]
    assert max(out["compared"]["errs"]) < 1e-5
    assert out["record"].steps >= 1


def _stale_middle(server):
    """The middle's resblocks on the full pass's statistics."""
    m = server.model.module
    m.mid_block1.live_dense = m.mid_block2.live_dense = False
    return server


def _block0_kv(server):
    """Every deeper block's cached keys and values are block 0's."""
    for t in server.model.module.modules():
        if isinstance(t, SIGESpatialTransformer) and len(t.blocks) > 1:
            def cache_kv1(i, k, v, ctx, t=t, own=t._cache_kv1):
                if i:
                    k, v = t.cache["k1_0"], t.cache["v1_0"]
                own(i, k, v, ctx)
            t._cache_kv1 = cache_kv1
    return server


@pytest.mark.parametrize("fault", [_stale_middle, _block0_kv],
                         ids=["stale_middle", "block0_kv"])
def test_planted_faults_are_not_correct(fault):
    c = cell("sdxl_1024", "unet_window_s4", period=2, stagger=1)
    _, (correct, failed) = _run(c, 2**31 + 12, fault)
    assert not correct and failed >= 1


def test_transformer_readers_read_a_traced_record():
    c = cell("sdxl_1024", "unet_window_s4", sessions=2)
    out, (correct, _) = _run(c, 2**31 + 13, trace=True)
    assert correct
    rec = out["record"]
    assert reader("transformer_ms")(rec) > 0
    # TINY: 2 + 3 + 2 x 3 + 2 x 2 = 15 sparse blocks on the chain, the
    # middle's 3 dense
    assert reader("chain_block_share")(rec) == pytest.approx(100 * 15 / 18)
    assert rec.counters["transformer_chain_blocks"] == 15 * rec.steps


def test_the_cell_sets_up_at_full_size_with_equal_first_extents():
    """Every edit of SD v1's U-Net traffic at 1024² gives the same window
    extents: the accepted replay refuses them as first edits, the SDXL
    family's replay pins them at once, on the first draw."""
    from sigebench.reference.pinned_windows import PinnedWindows
    from sigebench.reference.windows import (SessionWindows,
                                             canonical_windows)

    c = harness.load_cell("sdxl_1024.unet_window_s4")
    traffic, prep, _ = harness.prepare(c, 2**31 + 14, "cpu", attempts=1)
    consumed, _ = harness.meta_pass(prep)
    first = [prep.pyramids[i][0] for i in range(traffic.sessions)]
    plain = SessionWindows(traffic.sessions, consumed)
    pinned = PinnedWindows(traffic.sessions, consumed)
    for i, m in enumerate(first):
        plain.set(i, m)
        pinned.set(i, m)
    with pytest.raises(ValueError, match="equal windows"):
        plain.current()
    windows = [dict(w) for w in pinned.current()]
    ext = {r: (w[2], w[3]) for r, w in windows[0].items()}
    assert pinned.pins == ext
    assert all({r: (w[2], w[3]) for r, w in s.items()} == ext
               for s in windows)
    # pinning equal extents moves no window of the first edits
    assert windows == [canonical_windows(m, consumed) for m in first]
