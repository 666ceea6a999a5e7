"""The port's window and tile ops at S sessions against S calls of the
same op at S = 1 on each session's rows, on the CPU, exactly: fp32
throughout, and fp32 fresh values over bf16 caches
(``SIGEModel(cache_dtype=)``).

S sessions of B samples run as one batch of S*B (``SessionServer``);
session s's origins, metas, masks and lookups are row s of the stacked
plan, and the oracle runs the op on samples s*B .. s*B + B - 1 with row s
alone (a one-session stack: how the engine installs one session's plan),
compared bitwise except after transcendental activations (``_same``).
The two primitives, ``crop_sessions`` and ``paste_sessions``, are held to
plain slices of each session's samples instead (in-image and border
origins, an extent wider than the canvas, negative virtual origins, with
and without ``cov`` and ``edge``, every activation in both orders). The
ops covered: every window op of ``ops/window.py`` and the tile ops of
``ops/gather.py`` / ``ops/scatter.py`` on lookups a ``PlanStack`` built.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sige_torch.core.geometry import BlockGeometry
from sige_torch.core.masks import dilate_mask, downsample_mask
from sige_torch.nn.planner import _window_meta
from sige_torch.ops import gather as g
from sige_torch.ops.gather import apply_epilogue, broadcast_param
from sige_torch.ops import scatter as sc
from sige_torch.ops import sessions as ss
from sige_torch.ops import window as w
from sige_torch.parallel import PlanStack

S, B, H, W, C = 3, 2, 12, 14, 5
# per-session virtual origins of one extraction extent: in image (2-form
# metas), at the border (4-form), and wider than the canvas
WINDOWS = {
    "inside": ([(3, 4), (0, 5), (6, 1)], (6, 7)),
    "border": ([(-1, 9), (3, 4), (8, -1)], (6, 7)),
    "wide": ([(-1, -1), (-2, 0), (-1, -2)], (14, 16)),
}
ACTIVATIONS = ["identity", "swish", "relu", "leaky", "sigmoid", "tanh"]
DTYPES = [torch.float32, torch.bfloat16]


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


def _metas(kind):
    """(stacked [S, k] metas, edges [S, EH, EW], per-session host virtual
    origins, the canonical windows' origins [S, 2] and extent)."""
    origins, ext = WINDOWS[kind]
    fast = kind == "inside"
    pairs = [_window_meta(o, ext, (H, W), fast) for o in origins]
    metas = torch.from_numpy(np.stack([m for m, _ in pairs]).astype(np.int64))
    edges = torch.from_numpy(np.stack([e for _, e in pairs]))
    # a stride-1 3x3 consumer: the canonical window sits at v + 1, clamped
    WH, WW = min(ext[0] - 2, H), min(ext[1] - 2, W)
    orgs = [(max(0, min(o[0] + 1, H - WH)), max(0, min(o[1] + 1, W - WW)))
            for o in origins]
    return metas, edges, origins, torch.tensor(orgs), (WH, WW)


def _crop(x, r, c, eh, ew):
    """[B, eh, ew, C] window of ``x`` at (r, c): the part inside ``x``
    sliced, the rest zero."""
    _, H_, W_, _ = x.shape
    r0, r1 = max(r, 0), min(r + eh, H_)
    c0, c1 = max(c, 0), min(c + ew, W_)
    return F.pad(x[:, r0:r1, c0:c1],
                 (0, 0, c0 - c, c + ew - c1, r0 - r, r + eh - r1))


def _paste(base, win, r, c, cov=None):
    """A copy of ``base`` in ``win``'s dtype with ``win`` written at
    (r, c), where ``cov`` is set when given."""
    out = base.to(win.dtype, copy=True)
    h, w_ = win.shape[1:3]
    dst = out[:, r:r + h, c:c + w_]
    dst.copy_(win if cov is None
              else torch.where(cov[None, :, :, None], win, dst))
    return out


def _rows(t, s):
    return t[s * B:(s + 1) * B]


def _one(t, s):
    """Row s of a per-session plan product, as a stack of one."""
    return t[s:s + 1]


def _per_session(fn):
    """The oracle on every session's samples, concatenated."""
    return torch.cat([fn(s) for s in range(S)])


def _same(got, want, activation="identity"):
    """Equal bit for bit. After a transcendental activation (sigmoid,
    tanh, swish) within 1e-6 relative and 1e-7 absolute instead (a few
    ulp): PyTorch's CPU kernels compute those in vector lanes and the
    remainder of a tensor in scalar code, which round differently, and a
    batch of S*B samples puts other elements in the remainder than a
    batch of B."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if activation in ("identity", "relu", "leaky"):
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


# --- the two primitives ------------------------------------------------------


@pytest.mark.parametrize("kind", list(WINDOWS))
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("first", [False, True])
def test_crop_sessions_matches_host_crops(kind, edge, activation, first):
    gen = torch.Generator().manual_seed(0)
    x = _rand(gen, S * B, H, W, C)
    scale, shift = _rand(gen, S * B, C), _rand(gen, C)
    metas, edges, origins, _, _ = _metas(kind)
    EH, EW = edges.shape[1:]
    got = ss.crop_sessions(x, metas, EH, EW, edges if edge else None, scale,
                           shift, activation, first)

    def want(s):
        z = apply_epilogue(_crop(_rows(x, s), *origins[s], EH, EW),
                           broadcast_param(_rows(scale, s)),
                           broadcast_param(shift), activation, first)
        if edge:
            z = torch.where(edges[s][None, :, :, None], z, torch.zeros(()))
        return z

    _same(got, _per_session(want), activation)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cov", [None, "shared", "sessions"])
@pytest.mark.parametrize("origin", ["rows", "host"])
def test_paste_sessions_matches_host_pastes(dtype, cov, origin):
    gen = torch.Generator().manual_seed(1)
    base = _rand(gen, S * B, H, W, C, dtype=dtype)
    WH, WW = 5, 6
    win = _rand(gen, S * B, WH, WW, C)
    rows = [(0, 0), (7, 8), (3, 2)]
    org = torch.tensor(rows) if origin == "rows" else (4, 5)
    masks = {None: None, "shared": torch.rand(WH, WW, generator=gen) < 0.5,
             "sessions": torch.rand(S, WH, WW, generator=gen) < 0.5}
    m = masks[cov]
    got = ss.paste_sessions(base, win, org, m)
    want = _per_session(lambda s: _paste(
        _rows(base, s), _rows(win, s),
        *(rows[s] if origin == "rows" else org),
        None if m is None else (m[s] if m.ndim == 3 else m)))
    _same(got, want)


def test_cov_where_and_clamp_origin_sessions():
    gen = torch.Generator().manual_seed(2)
    a, b = _rand(gen, S * B, 4, 5, C), _rand(gen, S * B, 4, 5, C)
    cov = torch.rand(S, 4, 5, generator=gen) < 0.5
    _same(ss.cov_where(cov, a, b), _per_session(
        lambda s: torch.where(cov[s][None, :, :, None], _rows(a, s),
                              _rows(b, s))))
    # a clamped crop reads at the origin clamped so the window fits
    org = torch.tensor([[-3, 2], [9, 20], [4, 4]])
    x = _rand(gen, S * B, H, W, C)
    got = ss.crop_sessions(x, org, 5, 6, clamp=True)
    want = _per_session(lambda s: _crop(
        _rows(x, s), *(max(0, min(int(o), m - e))
                       for o, e, m in zip(org[s], (5, 6), (H, W))), 5, 6))
    _same(got, want)


# --- the window ops ----------------------------------------------------------


@pytest.mark.parametrize("kind", list(WINDOWS))
@pytest.mark.parametrize("activation", ["identity", "swish", "tanh"])
@pytest.mark.parametrize("first", [False, True])
def test_window_gather_sessions(kind, activation, first):
    gen = torch.Generator().manual_seed(3)
    x = _rand(gen, S * B, H, W, C)
    scale, shift = _rand(gen, S * B, C), _rand(gen, S * B, C)
    metas, edges, _, _, _ = _metas(kind)
    got = w.window_gather(x, metas, edges, scale, shift, activation, first)
    want = _per_session(lambda s: w.window_gather(
        _rows(x, s), _one(metas, s), _one(edges, s), _rows(scale, s),
        _rows(shift, s), activation, first))
    _same(got, want, activation)


@pytest.mark.parametrize("kind", list(WINDOWS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_scatter_gather_sessions(kind, dtype):
    gen = torch.Generator().manual_seed(4)
    metas, edges, _, _, _ = _metas(kind)
    EH, EW = edges.shape[1:]
    cache = _rand(gen, S * B, H, W, C, dtype=dtype)
    h_win = _rand(gen, S * B, EH - 2, EW - 2, C)
    cov = torch.rand(S, EH - 2, EW - 2, generator=gen) < 0.6
    scale, shift = _rand(gen, S * B, C), _rand(gen, S * B, C)
    got = w.window_scatter_gather(h_win, cache, metas, edges, cov, (1, 1),
                                  scale, shift, "swish")
    want = _per_session(lambda s: w.window_scatter_gather(
        _rows(h_win, s), _rows(cache, s), _one(metas, s), _one(edges, s),
        _one(cov, s), (1, 1), _rows(scale, s), _rows(shift, s), "swish"))
    _same(got, want, "swish")


@pytest.mark.parametrize("kind", list(WINDOWS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", [None, "map", "window", "channels"])
def test_window_slice_scatter_materialize_sessions(kind, dtype, residual):
    gen = torch.Generator().manual_seed(5)
    _, _, _, orgs, (WH, WW) = _metas(kind)
    cache = _rand(gen, S * B, H, W, C, dtype=dtype)
    win = _rand(gen, S * B, WH, WW, C)
    cov = torch.rand(S, WH, WW, generator=gen) < 0.6
    res = {None: None, "map": _rand(gen, S * B, H, W, C),
           "window": _rand(gen, S * B, WH, WW, C),
           "channels": _rand(gen, S * B, C)}[residual]
    _same(w.window_slice(cache, orgs, (WH, WW)), _per_session(
        lambda s: w.window_slice(_rows(cache, s), _one(orgs, s), (WH, WW))))
    _same(w.window_scatter(win, cache, orgs, cov, res), _per_session(
        lambda s: w.window_scatter(_rows(win, s), _rows(cache, s),
                                   _one(orgs, s), _one(cov, s),
                                   None if res is None else _rows(res, s))))
    _same(w.window_state_materialize(cache, win, orgs), _per_session(
        lambda s: w.window_state_materialize(_rows(cache, s), _rows(win, s),
                                             _one(orgs, s))))


@pytest.mark.parametrize("kind", list(WINDOWS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rel", [None, (1, 1)])
def test_window_chain_extend_sessions(kind, dtype, rel):
    gen = torch.Generator().manual_seed(6)
    metas, edges, _, orgs, (WH, WW) = _metas(kind)
    cache = _rand(gen, S * B, H, W, C, dtype=dtype)
    win = _rand(gen, S * B, WH, WW, C)
    scale, shift = _rand(gen, S * B, C), _rand(gen, S * B, C)
    got = w.window_chain_extend(win, orgs, cache, metas, edges, scale, shift,
                                "swish", rel=rel)
    want = _per_session(lambda s: w.window_chain_extend(
        _rows(win, s), _one(orgs, s), _rows(cache, s), _one(metas, s),
        _one(edges, s),
        _rows(scale, s), _rows(shift, s), "swish", rel=rel))
    _same(got, want, "swish")


@pytest.mark.parametrize("kind", list(WINDOWS))
def test_window_chain_extend_up2_and_epilogue_sessions(kind):
    gen = torch.Generator().manual_seed(7)
    metas, edges, _, _, _ = _metas(kind)
    EH, EW = edges.shape[1:]
    # the doubled carried window of the coarser resolution, at 2 * its
    # origin: it covers the in-image part of the extraction window
    org2 = torch.tensor([[max(o[0] - 2, 0) // 2 * 2, max(o[1] - 2, 0) // 2 * 2]
                         for o in WINDOWS[kind][0]])
    win2 = _rand(gen, S * B, 2 * H // 2 + 4, 2 * W // 2 + 4, C)
    scale, shift = _rand(gen, S * B, C), _rand(gen, S * B, C)
    got = w.window_chain_extend_up2(win2, org2, metas, edges, scale, shift,
                                    "swish", True)
    want = _per_session(lambda s: w.window_chain_extend_up2(
        _rows(win2, s), _one(org2, s), _one(metas, s), _one(edges, s),
        _rows(scale, s), _rows(shift, s), "swish", True))
    _same(got, want, "swish")
    z = _rand(gen, S * B, EH, EW, C)
    _same(w.window_epilogue(z, edges, scale, shift, "swish"), _per_session(
        lambda s: w.window_epilogue(_rows(z, s), _one(edges, s),
                                    _rows(scale, s), _rows(shift, s),
                                    "swish")), "swish")


@pytest.mark.parametrize("kind", list(WINDOWS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_scatter_block_residual_sessions(kind, dtype):
    gen = torch.Generator().manual_seed(8)
    _, _, _, orgs, (WH, WW) = _metas(kind)
    y0, y1 = (_rand(gen, S * B, H, W, C, dtype=dtype) for _ in range(2))
    main, short = (_rand(gen, S * B, WH, WW, C) for _ in range(2))
    cm, cs = (torch.rand(S, WH, WW, generator=gen) < p for p in (0.6, 0.4))
    got = w.window_scatter_block_residual(main, y0, short, y1, orgs, cm, cs)
    want = _per_session(lambda s: w.window_scatter_block_residual(
        _rows(main, s), _rows(y0, s), _rows(short, s), _rows(y1, s),
        _one(orgs, s), _one(cm, s), _one(cs, s)))
    _same(got, want)


# --- the tile ops ------------------------------------------------------------

TH, TW = 24, 26
MAIN = BlockGeometry.create(6, 3, 1, 1)
SHORT = BlockGeometry.create(4, 1, 1, 0)


def _record(geom, res, **reqs):
    g_ = geom
    rec = {"input_res": (np.array(res, np.int32),),
           "geom": (np.array([*g_.block_size, *g_.block_stride, *g_.offset,
                              *g_.kernel_size, *g_.conv_stride], np.int32),)}
    for key in reqs:
        rec[key] = (np.array(res, np.int32),)
    return rec


@pytest.fixture(scope="module")
def tile_plans():
    """A PlanStack (tiles, pinned shapes) over three sessions' edits — one
    at the border, one spread — for a main gather (with scatter, re-gather
    and tile-chain products) and a shortcut gather."""
    meta = {"m": _record(MAIN, (TH, TW), scatter_res=1, sg_res=1,
                         pixsrc_res=1),
            "s": _record(SHORT, (TH, TW), scatter_res=1)}
    boxes = [(2, 8, 4, 10), (0, 5, 20, 26), (4, 20, 3, 22)]
    stack = PlanStack(meta, S, bucket_min=1, layout="tiles")
    for i, (r0, r1, c0, c1) in enumerate(boxes):
        m = np.zeros((TH, TW), bool)
        m[r0:r1, c0:c1] = True
        stack.set(i, downsample_mask(dilate_mask(m, 1), min_res=6))
    stacked = stack.stacked()
    dev = {k: {n: torch.from_numpy(np.asarray(v).astype(
        np.bool_ if np.asarray(v).dtype == np.bool_ else np.int64))
        for n, v in e.items()} for k, e in stacked.items()}
    return stacked, dev


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_ops_sessions(tile_plans, dtype):
    _, dev = tile_plans
    gen = torch.Generator().manual_seed(9)
    key = f"{TH}x{TW}"
    m, s_ = dev["m"], dev["s"]
    K, Ks = m["indices"].shape[1], s_["indices"].shape[1]
    x = _rand(gen, S * B, TH, TW, C)
    scale, shift = _rand(gen, S * B, C), _rand(gen, S * B, C)
    cache, cres = (_rand(gen, S * B, TH, TW, C, dtype=dtype)
                   for _ in range(2))
    R, Q = MAIN.out_tile_size
    tiles = _rand(gen, S * B * K, R, Q, C)
    stiles = _rand(gen, S * B * Ks, *SHORT.out_tile_size, C)
    bh, bw = MAIN.block_size
    state = _rand(gen, S * B * K, bh, bw, C)
    resid = _rand(gen, S * B, TH, TW, C)

    def one(name, s, k):
        return _one(dev[name][k], s)

    def tiles_of(t, s, k):
        return t[s * B * k:(s + 1) * B * k]

    # gather_tiles
    got = g.gather_tiles(x, m["indices"], m["count"], MAIN, scale, shift,
                         "swish")
    want = torch.cat([g.gather_tiles(
        _rows(x, s), one("m", s, "indices"), one("m", s, "count"), MAIN,
        _rows(scale, s), _rows(shift, s), "swish") for s in range(S)])
    _same(got, want, "swish")
    # scatter_tiles_box, with and without a full-map residual
    for r in (None, resid):
        got = sc.scatter_tiles_box(tiles, cache, m[f"srcbox_{key}"],
                                   m[f"srcorg_{key}"], r)
        want = _per_session(lambda s: sc.scatter_tiles_box(
            tiles_of(tiles, s, K), _rows(cache, s),
            one("m", s, f"srcbox_{key}"), one("m", s, f"srcorg_{key}"),
            None if r is None else _rows(r, s)))
        _same(got, want)
    # scatter_with_block_residual_box
    got = sc.scatter_with_block_residual_box(
        tiles, cache, stiles, cres, m[f"srcbox_{key}"], m[f"srcorg_{key}"],
        s_[f"srcbox_{key}"], s_[f"srcorg_{key}"])
    want = _per_session(lambda s: sc.scatter_with_block_residual_box(
        tiles_of(tiles, s, K), _rows(cache, s), tiles_of(stiles, s, Ks),
        _rows(cres, s), one("m", s, f"srcbox_{key}"),
        one("m", s, f"srcorg_{key}"), one("s", s, f"srcbox_{key}"),
        one("s", s, f"srcorg_{key}")))
    _same(got, want)
    # scatter_gather_tiles and the tile chain's residual form
    got = sc.scatter_gather_tiles(tiles, cache, m[f"sgsrc_{key}"],
                                  m[f"sgflat_{key}"], MAIN, scale, shift,
                                  "swish")
    want = torch.cat([sc.scatter_gather_tiles(
        tiles_of(tiles, s, K), _rows(cache, s), one("m", s, f"sgsrc_{key}"),
        one("m", s, f"sgflat_{key}"), MAIN, _rows(scale, s),
        _rows(shift, s), "swish") for s in range(S)])
    _same(got, want)
    got = sc.scatter_gather_residual_tiles(
        tiles, cache, state, m[f"sgsrc_{key}"], m[f"sgflat_{key}"], MAIN,
        scale, shift, "swish")
    want = torch.cat([sc.scatter_gather_residual_tiles(
        tiles_of(tiles, s, K), _rows(cache, s), tiles_of(state, s, K),
        one("m", s, f"sgsrc_{key}"), one("m", s, f"sgflat_{key}"), MAIN,
        _rows(scale, s), _rows(shift, s), "swish") for s in range(S)])
    _same(got, want, "swish")
    # scatter_tiles_box as the tile state's materialize
    got = sc.scatter_tiles_box(state, cache, m[f"pixbox_{key}"],
                               m[f"pixorg_{key}"])
    want = _per_session(lambda s: sc.scatter_tiles_box(
        tiles_of(state, s, K), _rows(cache, s), one("m", s, f"pixbox_{key}"),
        one("m", s, f"pixorg_{key}")))
    _same(got, want)


def test_masked_attention_refuses_stacked_plans():
    """The SD models' masked stale/fresh attention never biases S sessions
    with their own windows alike: per-session origins give one key bias
    row per session, each the bias of a one-session call on that
    session's window."""
    from sige_torch.ops.attention import stale_fresh_biases

    cov = torch.ones(2, 4, 4, dtype=torch.bool)
    org = torch.tensor([[2, 3], [0, 0]])
    rows_s, rows_f = stale_fresh_biases(cov, org, (8, 8))
    assert rows_s.shape == (2, 64) and rows_f.shape == (2, 16)
    for s in range(2):
        bias_s, bias_f = stale_fresh_biases(_one(cov, s), _one(org, s),
                                            (8, 8))
        assert bias_s.shape == (1, 64) and bias_f.shape == (1, 16)
        assert torch.equal(rows_s[s], bias_s[0])
        assert torch.equal(rows_f[s], bias_f[0])
    assert not torch.equal(rows_s[0], rows_s[1])
