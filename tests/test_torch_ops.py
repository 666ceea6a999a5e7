"""sige_torch ops and planning primitives against their sige_tpu
counterparts, on random inputs and on plans from the planner.

The two packages do the same fp32 arithmetic in the same order (gathers,
selects, one multiply-add epilogue), so they agree to atol 1e-6; the
planning primitives are integer and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core import masks as jmasks
from sige_tpu.core import scatter_map as jsmap
from sige_tpu.core.geometry import BlockGeometry as JGeom
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.nn.module import SIGEConv2d as JSIGEConv2d
from sige_tpu.nn.norm import group_norm_with_affine as j_group_norm
from sige_tpu.ops import conv2d_nhwc as j_conv
from sige_tpu.ops import gather as jgather
from sige_tpu.ops import scatter as jscatter
from sige_torch.core import masks as tmasks
from sige_torch.core import scatter_map as tsmap
from sige_torch.core.geometry import BlockGeometry
from sige_torch.nn.module import SIGECtx, SIGEConv2d
from sige_torch.nn.norm import group_norm_with_affine
from sige_torch.ops import conv as tconv
from sige_torch.ops import gather as tgather
from sige_torch.ops import scatter as tscatter

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _geoms(block, kernel, stride=1, pad=1):
    return (BlockGeometry.create(block, kernel, stride, pad),
            JGeom.create(block, kernel, stride, pad))


def _plan(rng, H, W, block=6, kernel=3, stride=1, pad=1, frac=0.08,
          dead=3):
    """A random mask reduced to tile indices by the port's planner, with
    ``dead`` padded slots past the live count."""
    mask = rng.random((H, W)) < frac
    mask[0, 0] = mask[-1, -1] = True  # tiles at both corners: OOB pixels
    geom, jgeom = _geoms(block, kernel, stride, pad)
    live = tmasks.reduce_mask(mask, geom).shape[0]
    idx, count = tmasks.reduce_mask_padded(mask, geom, capacity=live + dead)
    return mask, geom, jgeom, idx, count


def test_planning_primitives_equal(rng):
    mask = rng.random((40, 36)) < 0.05
    for block, kernel, stride, pad in ((6, 3, 1, 1), (4, 1, 1, 0),
                                       (5, 3, 2, 0)):
        geom, jgeom = _geoms(block, kernel, stride, pad)
        idx, count = tmasks.reduce_mask_padded(mask, geom)
        jidx, jcount = jmasks.reduce_mask_padded(mask, jgeom)
        assert count == jcount
        np.testing.assert_array_equal(idx, jidx)
        out_hw = ((40 + 2 * pad - kernel) // stride + 1,
                  (36 + 2 * pad - kernel) // stride + 1)
        src = tsmap.build_src_map(idx, count, geom, out_hw)
        np.testing.assert_array_equal(
            src, jsmap.build_src_map(jidx, jcount, jgeom, out_hw))
        for a, b in zip(tsmap.bbox_of_map(src), jsmap.bbox_of_map(src)):
            np.testing.assert_array_equal(a, b)
        if stride == 1:
            for a, b in zip(tsmap.build_sg_sources(idx, count, geom, out_hw),
                            jsmap.build_sg_sources(jidx, jcount, jgeom,
                                                   out_hw)):
                np.testing.assert_array_equal(a, b)
    dil = tmasks.dilate_mask(mask, 3)
    np.testing.assert_array_equal(dil, jmasks.dilate_mask(mask, 3))
    tp = tmasks.downsample_mask(dil, min_res=4)
    jp = jmasks.downsample_mask(dil, min_res=4)
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k])


@pytest.mark.parametrize("activation_first", [False, True])
@pytest.mark.parametrize("activation", ["identity", "swish", "relu", "leaky",
                                        "sigmoid", "tanh"])
def test_gather_tiles(rng, activation, activation_first):
    H, W, C = 20, 22, 8
    _, geom, jgeom, idx, count = _plan(rng, H, W)
    idx[count - 1] = (-3, W - 2)  # a live tile poking out of two borders
    assert idx[:count].min() < 0 and count < idx.shape[0]  # dead slots too
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    scale = rng.standard_normal((2, C)).astype(np.float32)
    shift = rng.standard_normal((2, 1, 1, C)).astype(np.float32)
    got = tgather.gather_tiles(_t(x), _t(idx), count, geom, _t(scale),
                               _t(shift), activation, activation_first)
    want = jgather.gather_tiles(jnp.asarray(x), jnp.asarray(idx),
                                jnp.int32(count), jgeom, jnp.asarray(scale),
                                jnp.asarray(shift), activation,
                                activation_first)
    _close(got, want)


def test_gather_tiles_spatial_params(rng):
    """Spatially-varying params are gathered alongside x; OOB pixels and
    dead slots are exactly 0 with no epilogue applied."""
    H, W, C = 16, 16, 4
    _, geom, jgeom, idx, count = _plan(rng, H, W)
    x = rng.standard_normal((1, H, W, C)).astype(np.float32)
    scale = rng.standard_normal((1, H, W, C)).astype(np.float32)
    shift = np.ones((1, H, W, C), np.float32)
    got = tgather.gather_tiles(_t(x), _t(idx), count, geom, _t(scale),
                               _t(shift), "identity")
    want = jgather.gather_tiles(jnp.asarray(x), jnp.asarray(idx),
                                jnp.int32(count), jgeom, jnp.asarray(scale),
                                jnp.asarray(shift))
    _close(got, want)
    got = got.numpy().reshape(idx.shape[0], *geom.block_size, C)
    assert (got[count:] == 0).all()
    assert (got[0, 0, 0] == 0).all()  # tile at (-1, -1): its corner is OOB


def _conv_tiles(rng, K, geom, C):
    R, S = geom.out_tile_size
    return rng.standard_normal((K, R, S, C)).astype(np.float32)


@pytest.mark.parametrize("origin", [None, (-1, -2), (11, 13)])
def test_scatter_tiles_box(rng, origin):
    """``origin=None`` is the planner's bbox; the others put the box at and
    past the map's edge, where both clamp like ``lax.dynamic_slice``."""
    H, W, C = 18, 20, 6
    _, geom, jgeom, idx, count = _plan(rng, H, W)
    src = tsmap.build_src_map(idx, count, geom, (H, W))
    org, box = tsmap.bbox_of_map(src, mult=8)
    if origin is not None:
        org = np.array(origin, np.int32)
    tiles = _conv_tiles(rng, idx.shape[0], geom, C)
    cache = rng.standard_normal((1, H, W, C)).astype(np.float32)
    resid = rng.standard_normal((1, H, W, C)).astype(np.float32)
    for r in (None, resid):
        got = tscatter.scatter_tiles_box(
            _t(tiles), _t(cache), _t(box), org, geom,
            None if r is None else _t(r))
        want = jscatter.scatter_tiles_box(
            jnp.asarray(tiles), jnp.asarray(cache), jnp.asarray(box),
            jnp.asarray(org), jgeom, None if r is None else jnp.asarray(r))
        _close(got, want)


def test_scatter_tiles_and_calibrate(rng):
    H, W, C = 16, 16, 4
    _, geom, jgeom, idx, count = _plan(rng, H, W)
    src = tsmap.build_src_map(idx, count, geom, (H, W))
    tiles = _conv_tiles(rng, idx.shape[0], geom, C)
    cache = rng.standard_normal((1, H, W, C)).astype(np.float32)
    _close(tscatter.scatter_tiles(_t(tiles), _t(cache), _t(src), geom),
           jscatter.scatter_tiles(jnp.asarray(tiles), jnp.asarray(cache),
                                  jnp.asarray(src), jgeom))
    out = rng.standard_normal((1, H, W, C)).astype(np.float32)
    _close(tscatter.calibrate_residual(_t(out), _t(tiles), _t(cache),
                                       _t(src), geom),
           jscatter.calibrate_residual(jnp.asarray(out), jnp.asarray(tiles),
                                       jnp.asarray(cache), jnp.asarray(src),
                                       jgeom))


def test_scatter_gather_tiles(rng):
    H, W, C = 20, 20, 8
    _, geom, jgeom, idx, count = _plan(rng, H, W)
    sg_src, sg_flat = tsmap.build_sg_sources(idx, count, geom, (H, W))
    tiles = _conv_tiles(rng, idx.shape[0], geom, C)
    cache = rng.standard_normal((1, H, W, C)).astype(np.float32)
    scale = rng.standard_normal((1, C)).astype(np.float32)
    shift = rng.standard_normal((1, C)).astype(np.float32)
    got = tscatter.scatter_gather_tiles(
        _t(tiles), _t(cache), _t(sg_src), _t(sg_flat), geom, _t(scale),
        _t(shift), "swish")
    want = jscatter.scatter_gather_tiles(
        jnp.asarray(tiles), jnp.asarray(cache), jnp.asarray(sg_src),
        jnp.asarray(sg_flat), jgeom, jnp.asarray(scale), jnp.asarray(shift),
        "swish")
    _close(got, want)


def test_scatter_with_block_residual_box(rng):
    H, W, C = 24, 24, 8
    mask = rng.random((H, W)) < 0.06
    mask[-1, 3] = True
    gm, jgm = _geoms(6, 3, 1, 1)
    gs, jgs = _geoms(4, 1, 1, 0)
    im, cm = tmasks.reduce_mask_padded(mask, gm)
    is_, cs = tmasks.reduce_mask_padded(mask, gs)
    om, bm = tsmap.bbox_of_map(tsmap.build_src_map(im, cm, gm, (H, W)), 8)
    os_, bs = tsmap.bbox_of_map(tsmap.build_src_map(is_, cs, gs, (H, W)), 8)
    main = _conv_tiles(rng, im.shape[0], gm, C)
    short = _conv_tiles(rng, is_.shape[0], gs, C)
    y0 = rng.standard_normal((1, H, W, C)).astype(np.float32)
    y1 = rng.standard_normal((1, H, W, C)).astype(np.float32)
    got = tscatter.scatter_with_block_residual_box(
        _t(main), _t(y0), _t(short), _t(y1), _t(bm), om, gm, _t(bs), os_, gs)
    want = jscatter.scatter_with_block_residual_box(
        jnp.asarray(main), jnp.asarray(y0), jnp.asarray(short),
        jnp.asarray(y1), jnp.asarray(bm), jnp.asarray(om), jgm,
        jnp.asarray(bs), jnp.asarray(os_), jgs)
    _close(got, want)


def test_materialize_tiles(rng):
    H, W, C = 16, 16, 4
    _, geom, jgeom, idx, count = _plan(rng, H, W)
    pix_geom = BlockGeometry(geom.block_size, geom.block_stride, (0, 0),
                             (1, 1), (1, 1))
    pix = tsmap.build_src_map(idx, count, pix_geom, (H, W))
    state = rng.standard_normal(
        (idx.shape[0], *geom.block_size, C)).astype(np.float32)
    cache = rng.standard_normal((1, H, W, C)).astype(np.float32)
    _close(tscatter.materialize_tiles(_t(state), _t(cache), _t(pix), geom),
           jscatter.materialize_tiles(jnp.asarray(state), jnp.asarray(cache),
                                      jnp.asarray(pix), jgeom))


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, ((0, 1), (0, 1))),
                                            (1, "VALID")])
def test_conv2d_nhwc(rng, stride, padding):
    x = rng.standard_normal((2, 9, 10, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 5)).astype(np.float32)  # HWIO
    b = rng.standard_normal((5,)).astype(np.float32)
    got = tconv.conv2d_nhwc(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b),
                            stride=stride, padding=padding)
    want = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                  stride=stride, padding=padding)
    _close(got, want, atol=1e-5)  # two conv algorithms: sums reassociate


@pytest.mark.parametrize("groups,use_bias,mode", [
    (6, True, "full"), (6, False, "sparse"),   # depthwise (groups = C_in)
    (2, True, "sparse"), (1, False, "full")])  # grouped; bias-free
def test_sige_conv2d_groups_and_bias(rng, groups, use_bias, mode):
    """SIGEConv2d with ``groups`` (flax's feature_group_count) and without
    a bias against sige_tpu's: output (padded in full mode, VALID in
    sparse mode) and MACs, which count C_in / groups per output element."""
    x = rng.standard_normal((1, 9, 10, 6)).astype(np.float32)
    features = 6 if groups == 6 else 4
    params = {"kernel": rng.standard_normal(
        (3, 3, 6 // groups, features)).astype(np.float32)}
    if use_bias:
        params["bias"] = rng.standard_normal((features,)).astype(np.float32)
    jconv = JSIGEConv2d(features=features, kernel_size=3, padding=1,
                        use_bias=use_bias, feature_group_count=groups)
    want, mut = jconv.apply({"params": params}, jnp.asarray(x),
                            ctx=JCtx(mode=mode), mutable=["profile"])
    conv = SIGEConv2d(6, features, 3, padding=1, groups=groups,
                      use_bias=use_bias)
    sd = {"weight": _t(params["kernel"].transpose(3, 2, 0, 1))}
    if use_bias:
        sd["bias"] = _t(params["bias"])
    conv.load_state_dict(sd, strict=True)
    ctx = SIGECtx(mode=mode, macs=[])
    with torch.no_grad():
        got = conv(_t(x), ctx)
    _close(got, want, atol=1e-5)  # two conv algorithms: sums reassociate
    assert ctx.macs == [float(np.asarray(mut["profile"]["macs"][0]))]


def test_group_norm_with_affine(rng):
    x = (3 * rng.standard_normal((2, 6, 5, 16)) + 1).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    got = group_norm_with_affine(_t(x), 4, _t(w), _t(b))
    want = j_group_norm(jnp.asarray(x), 4, jnp.asarray(w), jnp.asarray(b))
    for g, wv in zip(got, want):
        _close(g, wv)
