"""The engine's options against sige_tpu on the DDPM U-Net of
``tests/test_cache_dtype.py`` (32 px, two levels, the window chain across
them), weights bridged with ``utils/from_jax.py``:

  * ``merge_pins`` equals sige_tpu's on random pin maps (ints and shape
    tuples);
  * ``SIGEModel.pin_capacities`` gives sige_tpu's pin map on the same
    edit; a smaller edit planned afterwards keeps the pinned shapes and
    gives sige_tpu's pinned output (atol 1e-4); the pins belong to the
    session (a new state has none, a fork copies them, a new input shape
    drops them); ``merge_pins`` over two sessions' plans feeds one
    ``set_masks`` for each, whose plans then share every shape and whose
    outputs equal the unpinned ones;
  * ``cache_dtype=torch.bfloat16`` halves the scatter caches' bytes
    (the folded-norm affines keep fp32), as ``tests/test_cache_dtype.py``
    shows for sige_tpu;
  * the contract of narrow storage, in the tile and the window layout,
    with and without ``sparse_update``: one sparse forward with bf16
    caches equals, within 1e-5, the same forward with fp32 caches that
    hold the same bf16-rounded values, and a commit writes the bf16
    rounding of what the fp32 run commits, exactly. So only storage
    narrows: fresh windows stay fp32 (sige_tpu's window-chain joins cast
    them to the cache's dtype, which its own test hides at 0.05; the port
    is held to the contract instead);
  * where sige_tpu has no such join (the tile layout, and the window
    layout without chains), the port's bf16 run is within sige_tpu's own
    bf16 tolerance (0.05, ``tests/test_cache_dtype.py``) of sige_tpu's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.nn.planner import merge_pins as j_merge_pins
from sige_tpu.nn.planner import plan_pins as j_plan_pins
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel, merge_pins, plan_pins
from sige_torch.nn.planner import plan_leaves, plan_stats
from sige_torch.utils.from_jax import state_dict_from_flax, torch_path
from test_torch_sd_unet import (ATOL, box_mask, flax_params,  # noqa: F401
                                one_torch_thread)

R = 32
# tests/test_cache_dtype.py:19-21
TINY = dict(ch=16, ch_mult=(1, 2), num_res_blocks=2, attn_resolutions=(16,),
            resolution=R, num_groups=8, sparse_resolution_threshold=16)
BIG, SMALL, OTHER = (6, 20, 8, 24), (10, 14, 12, 16), (22, 28, 0, 30)
BF16_TOL = 0.05  # tests/test_cache_dtype.py: sige_tpu's bf16 tolerance
CONTRACT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks(box):
    return downsample_mask(dilate_mask(box_mask((R, R), box), 2), min_res=4)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    t = np.array([3.0], np.float32)
    edits = {}
    for i, box in enumerate((BIG, SMALL, OTHER)):
        m = box_mask((R, R), box)[None, :, :, None]
        edits[box] = (x0 + 0.5 * np.random.default_rng(i + 1)
                      .standard_normal(x0.shape) * m).astype(np.float32)
    params = flax_params(JUNet(cfg=JConfig(**TINY)), x0, t)
    return x0, t, edits, params


def _model(layout="tiles", cache_dtype=None, **kw):
    tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY, **kw)),
                   layout=layout, bucket_min=1, cache_dtype=cache_dtype,
                   device="cpu")
    tm.module.load_state_dict(state_dict_from_flax(_inputs()[3]))
    return tm


# --- merge_pins and pin_capacities ---------------------------------------------


def _random_pins(rng, n):
    pins = {}
    for _ in range(n):
        path = tuple(f"m{rng.integers(0, 6)}" for _ in range(
            rng.integers(1, 3)))
        if rng.random() < 0.5:
            pins[path] = int(rng.integers(1, 40))
        else:
            pins[path + (f"srcbox_{rng.integers(1, 3) * 8}x8",)] = tuple(
                int(v) for v in rng.integers(1, 30, 2))
    return pins


def test_merge_pins_equals_sige_tpu():
    rng = np.random.default_rng(7)
    for n_maps in (1, 2, 3, 5):
        maps = [_random_pins(rng, 8) for _ in range(n_maps)]
        assert merge_pins(*maps) == j_merge_pins(*maps)
    assert merge_pins() == j_merge_pins() == {}


def _port_key(path):
    """sige_tpu's pin key in the port's module names (the trailing box
    leaf name, when there is one, stays)."""
    tail = path[-1:] if path[-1].startswith(("srcbox_", "pixbox_")) else ()
    return torch_path(path[:len(path) - len(tail)]) + tail


@functools.lru_cache(maxsize=None)
def _j_pinned():
    """sige_tpu's pins after the big edit, and its sparse output on the
    small edit planned under them."""
    x0, t, edits, params = _inputs()
    jm = JModel(JUNet(cfg=JConfig(**TINY)), params, layout="tiles",
                bucket_min=1)
    jm.full(jnp.asarray(x0), jnp.asarray(t))
    jm.set_masks(_masks(BIG))
    pins = jm.pin_capacities()
    jm.set_masks(_masks(SMALL))
    small_plan = jax.device_get(jm.plan)
    out = np.asarray(jm.sparse(jnp.asarray(edits[SMALL]), jnp.asarray(t)))
    return pins, j_plan_pins(small_plan), out


def test_pin_capacities_equals_sige_tpu_and_keeps_the_shapes():
    x0, t, edits, _ = _inputs()
    j_pins, j_small_pins, j_out = _j_pinned()
    tm = _model()
    tm.full(_t(x0), _t(t))
    with pytest.raises(RuntimeError, match="set_masks"):
        tm.pin_capacities()
    unpinned_small = plan_pins(tm.set_masks(_masks(SMALL)))
    big = tm.set_masks(_masks(BIG))
    pins = tm.pin_capacities()
    assert pins == {_port_key(k): v for k, v in j_pins.items()}
    assert pins == plan_pins(big) == tm.state.pins
    small = tm.set_masks(_masks(SMALL))
    assert plan_pins(small) == pins
    assert plan_pins(small) == {_port_key(k): v
                                for k, v in j_small_pins.items()}
    assert unpinned_small != pins  # without pins the shapes shrink
    np.testing.assert_allclose(tm.sparse(_t(edits[SMALL]), _t(t)).numpy(),
                               j_out, atol=ATOL, rtol=0)
    # an explicit map wins over the session's pins
    assert plan_pins(tm.set_masks(_masks(SMALL),
                                  capacities=unpinned_small)) == unpinned_small


@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_set_masks_installs_a_one_session_stack(layout):
    """One session's plan is installed as a stack of one: every leaf of
    the plan on the device and on the host leads with 1, and row 0 is the
    plan ``set_masks`` returns. What reads one session's shapes reads that
    row: ``pin_capacities`` gives the pins of the unstacked plan, and
    ``stats`` its statistics."""
    x0, t, edits, _ = _inputs()
    tm = _model(layout)
    tm.full(_t(x0), _t(t))
    plan = tm.set_masks(_masks(BIG))
    device, host = plan_leaves(tm.plan), dict(plan_leaves(tm.plan_host))
    assert device and all(a.shape[0] == 1 for _, a in device)
    assert {p for p, _ in device} == set(host) == {
        p for p, _ in plan_leaves(plan)}
    for p, a in plan_leaves(plan):
        assert host[p].shape == (1, *a.shape)
        np.testing.assert_array_equal(host[p][0], a)
    assert tm.pin_capacities() == plan_pins(plan)
    assert tm.stats() == plan_stats(tm.meta, plan)
    assert tm.sparse(_t(edits[BIG]), _t(t)).shape == x0.shape


def test_pins_belong_to_the_session():
    x0, t, _, _ = _inputs()
    tm = _model()
    tm.full(_t(x0), _t(t))
    tm.set_masks(_masks(BIG))
    pins = tm.pin_capacities()
    first = tm.state
    fork = first.fork()
    other = tm.new_state()
    assert other.pins == {} and fork.pins == pins
    tm.use(other)
    tm.full(_t(x0), _t(t))
    small = plan_pins(tm.set_masks(_masks(SMALL)))
    assert small != pins  # the first session's pins did not leak here
    tm.use(first)
    assert plan_pins(tm.set_masks(_masks(SMALL))) == pins
    fork.pins.clear()
    assert first.pins == pins
    # a new input shape drops the plan and the pins
    tm.full(_t(np.zeros((2, R, R, 3), np.float32)), _t(np.zeros(2)))
    assert tm.state.pins == {} and tm.plan == {}


def test_merge_pins_over_two_sessions_feeds_one_set_masks():
    x0, t, edits, _ = _inputs()
    tm = _model()
    states = [tm.new_state(), tm.new_state()]
    outs, plans = [], []
    for state, box in zip(states, (BIG, OTHER)):
        tm.use(state)
        tm.full(_t(x0), _t(t))
        plans.append(tm.set_masks(_masks(box)))
        outs.append(tm.sparse(_t(edits[box]), _t(t)).numpy())
    merged = merge_pins(*(plan_pins(p) for p in plans))
    assert merged != plan_pins(plans[1])  # a plan grows to the shared shapes
    for p in plans:
        for k, v in plan_pins(p).items():
            assert np.all(np.asarray(merged[k]) >= np.asarray(v))
    for state, box, want in zip(states, (BIG, OTHER), outs):
        tm.use(state)
        assert plan_pins(tm.set_masks(_masks(box), capacities=merged)) == \
            merged
        np.testing.assert_allclose(tm.sparse(_t(edits[box]), _t(t)).numpy(),
                                   want, atol=ATOL, rtol=0)


# --- cache_dtype -----------------------------------------------------------------


def _scatter_bytes(state):
    return sum(v.numel() * v.element_size() for v in state.tensors()
               if v.ndim == 4)


@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_bf16_caches_halve_the_scatter_cache_bytes(layout):
    x0, t, _, _ = _inputs()
    states = {}
    for dtype in (torch.bfloat16, None):
        tm = _model(layout, dtype)
        tm.full(_t(x0), _t(t))
        states[dtype] = tm.state
    assert _scatter_bytes(states[torch.bfloat16]) * 2 == \
        _scatter_bytes(states[None])
    assert {v.dtype for v in states[torch.bfloat16].tensors()
            if v.ndim == 4} == {torch.bfloat16}
    assert {v.dtype for v in states[torch.bfloat16].tensors()
            if v.ndim == 2} == {torch.float32}  # the folded affines


def _rounded_twin(narrow, wide):
    """Put the narrow model's caches, widened, into the fp32 model's state:
    fp32 storage of the same bf16-rounded values."""
    for name, slots in narrow.state.caches.items():
        for k, d in enumerate(slots):
            for key, v in d.items():
                if v.dtype == torch.bfloat16:
                    wide.state.caches[name][k][key] = v.float()


@pytest.mark.parametrize("update", [False, True], ids=["sparse", "update"])
@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_bf16_storage_is_the_only_narrowing(layout, update, monkeypatch):
    x0, t, edits, _ = _inputs()
    narrow, wide = _model(layout, torch.bfloat16), _model(layout)
    for m in (narrow, wide):
        m.full(_t(x0), _t(t))
    _rounded_twin(narrow, wide)
    for m in (narrow, wide):
        m.set_masks(_masks(BIG))
    from sige_torch.models import blocks

    chains = []
    orig = blocks.ResBlock._chain_window

    def spy(self, x, ctx):
        chains.append(ctx.cache_dtype)
        return orig(self, x, ctx)

    monkeypatch.setattr(blocks.ResBlock, "_chain_window", spy)
    got = narrow.sparse(_t(edits[BIG]), _t(t), sparse_update=update)
    want = wide.sparse(_t(edits[BIG]), _t(t), sparse_update=update)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=CONTRACT_TOL, rtol=0)
    # the window layout ran its chains (their joins are held too), except
    # under the commit, where they step aside
    assert bool(chains) == (layout == "window" and not update)
    if update:
        n = 0
        for name, slots in narrow.state.caches.items():
            for key, v in slots[0].items():
                w = wide.state.caches[name][0][key]
                if v.dtype == torch.bfloat16:
                    torch.testing.assert_close(v, w.bfloat16(), atol=0,
                                               rtol=0)
                    n += 1
        assert n
        # the committed slot is the new baseline: sparse on the edit
        # replays the commit (the plan's windows are the commit's)
        torch.testing.assert_close(narrow.sparse(_t(edits[BIG]), _t(t)),
                                   got, atol=CONTRACT_TOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _j_bf16(layout, chain, update):
    x0, t, edits, params = _inputs()
    jm = JModel(JUNet(cfg=JConfig(**TINY, window_chain=chain)), params,
                layout=layout, bucket_min=1, cache_dtype=jnp.bfloat16)
    jm.full(jnp.asarray(x0), jnp.asarray(t))
    jm.set_masks(_masks(BIG))
    return np.asarray(jm.sparse(jnp.asarray(edits[BIG]), jnp.asarray(t),
                                sparse_update=update))


@pytest.mark.parametrize("update", [False, True], ids=["sparse", "update"])
@pytest.mark.parametrize("layout,chain", [("tiles", True),
                                          ("window", False)])
def test_bf16_within_sige_tpu_bf16_tolerance(layout, chain, update):
    x0, t, edits, _ = _inputs()
    tm = _model(layout, torch.bfloat16, window_chain=chain)
    tm.full(_t(x0), _t(t))
    tm.set_masks(_masks(BIG))
    got = tm.sparse(_t(edits[BIG]), _t(t), sparse_update=update).numpy()
    want = _j_bf16(layout, chain, update)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
