"""The port's window ops and window planning against sige_tpu's.

Ops: each window op of ``sige_torch.ops.window`` against
``sige_tpu.ops.window`` on the same numpy-seeded inputs, at atol 1e-6
(the same arithmetic in fp32). The port takes metas, origins and masks as
a one-session plan does (``[1, k]`` int64 tensors, ``[1, h, w]`` masks)
and extracts a border window by reading zero outside the image where
sige_tpu clamps, rolls and masks; the cases cover the 2-form (in-image)
and 4-form (border) metas and an extent wider than the canvas.

Planner: ``build_plan(layout="window")`` of both packages on the same
meta and masks, equal key by key with dtype and shape, for an interior,
a border and a hybrid edit (a resolution whose window would cover more
than ``max_cover`` of the canvas runs tiles), with ``chain_nesting`` on
and off; ``choose_layout`` on a compact and a scattered edit; the
engine's one-copy plan upload keeps bool leaves bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.nn import planner as jplanner
from sige_tpu.ops import window as jw
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn import planner as tplanner
from sige_torch.nn.engine import upload_plan
from sige_torch.ops import window as tw

ATOL = 1e-6
H, W, C = 12, 14, 5

# (name, virtual origin, extent) on an H x W canvas
WINDOWS = [
    ("interior", (3, 4), (6, 7)),
    ("border", (-1, 9), (6, 7)),
    ("wider_than_canvas", (-1, -1), (H + 2, W + 2)),
]


def _meta(v_org, ext):
    meta, edge = tplanner._window_meta(v_org, ext, (H, W))
    return meta, edge


def _s1(a):
    """A host plan leaf as the engine installs it for one session: a
    tensor with a leading session axis of 1 (ints as int64)."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype != np.bool_
                            else a)[None]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_window_metas_take_both_forms():
    forms = {name: len(_meta(v, e)[0]) for name, v, e in WINDOWS}
    assert forms == {"interior": 2, "border": 4, "wider_than_canvas": 4}


@pytest.mark.parametrize("name,v_org,ext", WINDOWS, ids=[w[0] for w in WINDOWS])
@pytest.mark.parametrize("epilogue", [False, True])
def test_window_gather(rng, name, v_org, ext, epilogue):
    x = _rand(rng, 2, H, W, C)
    meta, edge = _meta(v_org, ext)
    kw = {}
    if epilogue:
        kw = dict(activation="swish")
        scale, shift = _rand(rng, 2, C), _rand(rng, 2, C)
    else:
        scale = shift = None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got = tw.window_gather(t(x), _s1(meta), _s1(edge), t(scale), t(shift),
                           **kw)
    want = jw.window_gather(j(x), j(meta), j(edge), j(scale), j(shift), **kw)
    _close(got, want)


@pytest.mark.parametrize("name,v_org,ext", WINDOWS[:2], ids=["interior",
                                                             "border"])
def test_window_scatter_gather(rng, name, v_org, ext):
    """The fresh conv1 window sits at the conv offset (1, 1) inside the
    ring window."""
    WH, WW = ext[0] - 2, ext[1] - 2
    h_win, cache = _rand(rng, 1, WH, WW, C), _rand(rng, 1, H, W, C)
    cov = rng.random((WH, WW)) < 0.6
    scale, shift = _rand(rng, 1, C), _rand(rng, 1, C)
    meta, edge = _meta(v_org, ext)
    cache_t = torch.from_numpy(cache.copy())
    got = tw.window_scatter_gather(
        torch.from_numpy(h_win), cache_t, _s1(meta), _s1(edge), _s1(cov),
        (1, 1),
        torch.from_numpy(scale), torch.from_numpy(shift), "swish")
    want = jw.window_scatter_gather(
        jnp.asarray(h_win), jnp.asarray(cache), jnp.asarray(meta),
        jnp.asarray(edge), jnp.asarray(cov), (1, 1), jnp.asarray(scale),
        jnp.asarray(shift), "swish")
    _close(got, want)
    assert np.array_equal(cache_t.numpy(), cache)


@pytest.mark.parametrize("residual", [None, "map", "window", "channels"])
def test_window_scatter(rng, residual):
    WH, WW, org = 5, 6, (4, 7)
    h_win, cache = _rand(rng, 2, WH, WW, C), _rand(rng, 2, H, W, C)
    cov = rng.random((WH, WW)) < 0.6
    res = {None: None, "map": _rand(rng, 2, H, W, C),
           "window": _rand(rng, 2, WH, WW, C),
           "channels": _rand(rng, 2, C)}[residual]
    cache_t = torch.from_numpy(cache.copy())
    got = tw.window_scatter(torch.from_numpy(h_win), cache_t, _s1(org),
                            _s1(cov),
                            None if res is None else torch.from_numpy(res))
    want = jw.window_scatter(jnp.asarray(h_win), jnp.asarray(cache),
                             jnp.asarray(org, jnp.int32), jnp.asarray(cov),
                             None if res is None else jnp.asarray(res))
    _close(got, want)
    # the cache is the full pass's activation: never written
    assert np.array_equal(cache_t.numpy(), cache)


@pytest.mark.parametrize("form", ["rel_given", "rel_from_origin", "border"])
def test_window_chain_extend(rng, form):
    """The carried window overlaid on the cache's extraction window: with
    ``rel`` given (a stride-1 consumer's conv offset), with the offset
    computed from the origin, and for a 4-form border window."""
    WH, WW = 5, 6
    org = (0, 8) if form == "border" else (4, 5)
    v_org, ext = (org[0] - 1, org[1] - 1), (WH + 2, WW + 2)
    meta, edge = _meta(v_org, ext)
    assert len(meta) == (4 if form == "border" else 2)
    win, cache = _rand(rng, 1, WH, WW, C), _rand(rng, 1, H, W, C)
    scale, shift = _rand(rng, 1, C), _rand(rng, 1, C)
    rel = (1, 1) if form == "rel_given" else None
    cache_t = torch.from_numpy(cache.copy())
    got = tw.window_chain_extend(
        torch.from_numpy(win), _s1(org), cache_t, _s1(meta), _s1(edge),
        torch.from_numpy(scale), torch.from_numpy(shift), "swish", rel=rel)
    want = jw.window_chain_extend(
        jnp.asarray(win), jnp.asarray(org, jnp.int32),
        jnp.asarray(cache)[None], 0, jnp.asarray(meta), jnp.asarray(edge),
        jnp.asarray(scale), jnp.asarray(shift), "swish", rel=rel)
    _close(got, want)
    assert np.array_equal(cache_t.numpy(), cache)


@pytest.mark.parametrize("where", ["interior", "border"])
def test_window_chain_extend_up2(rng, where):
    """A doubled carried window sliced to a finer extraction window; at
    the border the extraction halo pokes out of the canvas."""
    WH2, WW2 = 8, 10
    org2 = (2, 4) if where == "interior" else (0, W - WW2)
    v_org = (org2[0] + 1, org2[1] + 1) if where == "interior" else (-1, W - 7)
    ext = (6, 8)
    meta, edge = _meta(v_org, ext)
    assert len(meta) == (2 if where == "interior" else 4)
    win2 = _rand(rng, 1, WH2, WW2, C)
    scale, shift = _rand(rng, 1, C), _rand(rng, 1, C)
    got = tw.window_chain_extend_up2(
        torch.from_numpy(win2), _s1(org2), _s1(meta), _s1(edge),
        torch.from_numpy(scale), torch.from_numpy(shift), "swish")
    want = jw.window_chain_extend_up2(
        jnp.asarray(win2), jnp.asarray(org2, jnp.int32), jnp.asarray(meta),
        jnp.asarray(edge), jnp.asarray(scale), jnp.asarray(shift), "swish")
    _close(got, want)


def test_window_state_materialize_and_epilogue(rng):
    win, cache = _rand(rng, 1, 5, 6, C), _rand(rng, 1, H, W, C)
    cache_t = torch.from_numpy(cache.copy())
    got = tw.window_state_materialize(cache_t, torch.from_numpy(win),
                                      _s1((3, 7)))
    want = jw.window_state_materialize(jnp.asarray(cache)[None], 0,
                                       jnp.asarray(win),
                                       jnp.asarray((3, 7), jnp.int32))
    _close(got, want)
    assert np.array_equal(cache_t.numpy(), cache)

    z = _rand(rng, 1, 8, 9, C)
    _, edge = _meta((-2, 8), (8, 9))
    scale, shift = _rand(rng, 1, C), _rand(rng, 1, C)
    got = tw.window_epilogue(torch.from_numpy(z), _s1(edge),
                             torch.from_numpy(scale), torch.from_numpy(shift),
                             "swish")
    want = jw.window_epilogue(jnp.asarray(z), jnp.asarray(edge),
                              jnp.asarray(scale), jnp.asarray(shift), "swish")
    _close(got, want)


def test_window_scatter_block_residual(rng):
    WH, WW, org = 5, 6, (2, 3)
    main, short = _rand(rng, 2, WH, WW, C), _rand(rng, 2, WH, WW, C)
    y0, y1 = _rand(rng, 2, H, W, C), _rand(rng, 2, H, W, C)
    cov_m = rng.random((WH, WW)) < 0.7
    cov_s = rng.random((WH, WW)) < 0.5
    y0_t = torch.from_numpy(y0.copy())
    got = tw.window_scatter_block_residual(
        torch.from_numpy(main), y0_t, torch.from_numpy(short),
        torch.from_numpy(y1), _s1(org), _s1(cov_m), _s1(cov_s))
    want = jw.window_scatter_block_residual(
        jnp.asarray(main), jnp.asarray(y0), jnp.asarray(short),
        jnp.asarray(y1), jnp.asarray(org, jnp.int32), jnp.asarray(cov_m),
        jnp.asarray(cov_s))
    _close(got, want)
    assert np.array_equal(y0_t.numpy(), y0)


# --- planning -------------------------------------------------------------

R = 32
CFG = dict(ch=16, ch_mult=(1, 2), num_res_blocks=2, attn_resolutions=(16,),
           resolution=R, num_groups=8, sparse_resolution_threshold=16)
EDITS = {
    "interior": (10, 18, 12, 22),
    "border": (0, 7, 26, 32),
    "hybrid": (7, 25, 7, 25),   # the 16 px window would cover > 75%
}


@pytest.fixture(scope="module")
def meta():
    """The meta tree of a full pass of a tiny port U-Net (equal to
    sige_tpu's: tests/test_torch_ddpm.py)."""
    model = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**CFG)), device="cpu")
    model.init(0)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, R, R, 3)).astype(
            np.float32))
    model.full(x, torch.zeros(1))
    return model.meta


def _masks(edit):
    mask = np.zeros((R, R), bool)
    r0, r1, c0, c1 = EDITS[edit]
    mask[r0:r1, c0:c1] = True
    return downsample_mask(dilate_mask(mask, 2), min_res=4)


def _flat(tree, path=(), leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,), leaf))
        else:
            out[path + (k,)] = leaf(v)
    return out


@pytest.mark.parametrize("edit", sorted(EDITS))
@pytest.mark.parametrize("nesting", [True, False])
def test_window_plans_equal_key_by_key(meta, edit, nesting):
    masks = _masks(edit)
    want = _flat(jplanner.build_plan(meta, masks, 2, None, layout="window",
                                     chain_nesting=nesting))
    got = _flat(tplanner.build_plan(meta, masks, 2, None, layout="window",
                                    chain_nesting=nesting))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    keys = {k[-1] for k in got}
    assert "win_in" in keys
    # the 16 px windows carry the up2 chain marker, when they exist
    assert ("wup_ok" in keys) == (nesting and edit != "hybrid")
    if edit == "hybrid":  # some gathers windowed, some on tiles
        assert any(k.startswith("srcbox_") for k in keys)
    else:
        assert not any(k.startswith("srcbox_") for k in keys)
    if edit == "border":
        assert any(k[-1] == "win_in" and v.shape == (4,)
                   for k, v in got.items())


@pytest.mark.parametrize("metafast", [True, False])
def test_pinned_window_plans_equal_key_by_key(meta, metafast):
    """Extent pins (``("__winext__",)``, from another edit's windows) and
    the pinned meta form (``("__metafast__",)``) plan as in sige_tpu."""
    windows = tplanner._plan_canonical_windows(
        _masks("interior"), consumed=tplanner._collect_window_reses(meta))
    caps = {("__winext__",): {res: w[2:] for res, w in windows.items()},
            ("__metafast__",): metafast}
    masks = _masks("border")
    want = _flat(jplanner.build_plan(meta, masks, 2, caps, layout="window"))
    got = _flat(tplanner.build_plan(meta, masks, 2, caps, layout="window"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    forms = {len(v) for k, v in got.items() if k[-1] == "win_in"}
    assert forms == ({2, 4} if metafast else {4})


def test_canonical_windows_equal_on_a_deep_pyramid():
    masks = {}
    res = 1024
    while res >= 4:
        m = np.zeros((res, res), bool)
        s = max(1, res // 12)
        m[res // 5: res // 5 + s, res // 3: res // 3 + s] = True
        masks[(res, res)] = m
        res //= 2
    for cover in (1.0, 0.75):
        assert (tplanner._plan_canonical_windows(masks, consumed=set(masks),
                                                 max_cover=cover)
                == jplanner._plan_canonical_windows(
                    masks, consumed=set(masks), max_cover=cover))


def test_choose_layout_compact_and_scattered():
    compact = np.zeros((R, R), bool)
    compact[10:18, 12:20] = True
    scattered = np.zeros((R, R), bool)
    scattered[2:6, 2:6] = True
    scattered[26:30, 26:30] = True
    for mask, want in ((compact, "window"), (scattered, "tiles")):
        masks = downsample_mask(dilate_mask(mask, 1), min_res=8)
        assert jplanner.choose_layout(masks) == want
        assert tplanner.choose_layout(masks) == want


def test_plan_upload_keeps_bool_leaves_bool(meta):
    plan = tplanner.build_plan(meta, _masks("border"), 2, None,
                               layout="window")
    dev = _flat(upload_plan(plan, torch.device("cpu")), leaf=lambda t: t)
    host = _flat(plan)
    assert dev.keys() == host.keys()
    assert any(v.dtype == np.bool_ for v in host.values())
    for k, v in host.items():
        t = dev[k]
        assert (t.dtype == torch.bool) == (v.dtype == np.bool_), k
        assert np.array_equal(t.numpy(), v), k
