"""The SD models under the port's stacked ``SessionServer``, and the flash
kernel's per-session key bias that their masked stale/fresh attention
needs, on the tiny configurations of ``tests/test_sd.py``.

  * sige_tpu's ``SessionServer`` (one vmapped program over the sessions,
    so each session has its own key bias there) on the tiny SD U-Net on a
    one-device CPU mesh, window layout, S = 2 with one edit at the border:
    each session's rows of the port's server, and of its committing step,
    equal it within 1e-4 * max(1, max|ref|);
  * the U-Net and the decoder, window and tile layouts, S = 2 and 3 (one
    edit at the border: the 4-form window metas): each session's rows,
    and the rows of a committing step, equal the port's single-session
    engine planned under the server's pins (``_stack._caps()``) within
    1e-4 * max(1, max|full|);
  * the bias rule: ``flash_mha_plain`` and ``flash_partials_plain`` with
    an [S, M] bias equal S separate calls with each session's [M] row,
    exactly; an [M] bias computes what it did before the rule, bit for
    bit; ``stale_fresh_biases`` under a stacked plan equals, row by row,
    a one-session call on each session's window, exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.sd import SDUNetConfig as JConfig
from sige_tpu.models.sd import SIGESDUNet as JUNet
from sige_tpu.parallel import SessionServer as JServer
from sige_tpu.parallel import make_mesh
from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                  SIGESDUNet)
from sige_torch.nn import SIGEModel
from sige_torch.ops import flash
from sige_torch.ops.attention import stale_fresh_biases
from sige_torch.parallel import SessionServer
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import (TINY_UNET, TINY_VAE, box_mask, flax_params,
                                one_torch_thread)  # noqa: F401 (autouse)

ATOL = 1e-4
H = 32  # the U-Net's latent side
L = TINY_VAE["resolution"] // 2  # the decoder's latent side
# per session: one compact edit, the second at the top-right border
UNET_BOXES = [(8, 18, 10, 22), (0, 7, 24, 32), (20, 28, 2, 12)]
DEC_BOXES = [(8, 13, 10, 16), (0, 7, 25, 32), (18, 26, 4, 12)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _edits(rng, x0, boxes, R, step):
    """Each session's edited input and mask pyramid: noise in its box (the
    latent box is the image box subsampled by ``step``)."""
    x1, masks = x0.copy(), []
    for i, box in enumerate(boxes):
        m = box_mask((R, R), box)
        lat = m[::step, ::step]
        x1[i] += (0.7 * rng.standard_normal(x0.shape[1:]).astype(np.float32)
                  * lat[None, :, :, None])
        masks.append(downsample_mask(dilate_mask(m, 1), min_res=4))
    return x1.astype(np.float32), masks


def unet_sessions(S, B=2, seed=3):
    """S sessions of the tiny U-Net at batch B: (original args, edited
    args, masks), each arg [S, B, ...] (timesteps and a 7-token context
    lead with S too)."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((S, B, H, H, 4)).astype(np.float32)
    t = np.full((S, B), 3.0, np.float32)
    c = rng.standard_normal((S, B, 7, 16)).astype(np.float32)
    x1, masks = _edits(rng, x0, UNET_BOXES[:S], H, 1)
    return (x0, t, c), (x1, t, c), masks


def decoder_sessions(S, seed=5):
    """S sessions of the tiny decoder: latents [S, 1, L, L, 4] and mask
    pyramids from the image-resolution boxes."""
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal((S, 1, L, L, 4)).astype(np.float32)
    z1, masks = _edits(rng, z0, DEC_BOXES[:S], 2 * L, 2)
    return (z0,), (z1,), masks


MODELS = {
    "unet": (lambda: SIGESDUNet(SDUNetConfig(**TINY_UNET)), unet_sessions),
    "decoder": (lambda: SIGEDecoder(SDVAEConfig(**TINY_VAE)),
                decoder_sessions),
}


def _scaled_close(got, want, msg):
    tol = ATOL * max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0, err_msg=msg)


# --- sige_tpu's server --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_server_rows(S=2):
    """sige_tpu's SessionServer on the tiny SD U-Net, window layout, one
    CPU device: (weights, step rows, commit rows)."""
    args0, args1, masks = unet_sessions(S)
    params = flax_params(JUNet(cfg=JConfig(**TINY_UNET)),
                         *(a[0] for a in args0))
    mesh = make_mesh(1, tp=1, devices=jax.devices("cpu")[:1])
    server = JServer(JUNet(cfg=JConfig(**TINY_UNET)), params, mesh=mesh,
                     bucket_min=1, layout="window")
    j = jnp.asarray
    server.prime(*map(j, args0))
    for i in range(S):
        server.set_masks(i, masks[i])
    y = np.asarray(server.step(*map(j, args1)))
    y_upd = np.asarray(server.step(*map(j, args1), sparse_update=True))
    return state_dict_from_flax(params), y, y_upd


def test_sd_unet_sessions_match_sige_tpu_server():
    """The port's stacked step on the SD U-Net equals sige_tpu's vmapped
    server, session by session, in the window layout (masked stale/fresh
    attention with a key bias row per session)."""
    sd, want, want_upd = _jax_server_rows()
    args0, args1, masks = unet_sessions(2)
    server = SessionServer(SIGESDUNet(SDUNetConfig(**TINY_UNET)), sd,
                           bucket_min=1, layout="window", device="cpu")
    server.prime(*map(_t, args0))
    for i, m in enumerate(masks):
        server.set_masks(i, m)
    y = server.step(*map(_t, args1)).numpy()
    y_upd = server.step(*map(_t, args1), sparse_update=True).numpy()
    assert server.model.active_layout == "window"
    assert not server._stack.meta_fast  # the border edit: 4-form metas
    assert y.shape == want.shape
    for i in range(2):
        _scaled_close(y[i], want[i], f"session {i}")
        _scaled_close(y_upd[i], want_upd[i], f"session {i} commit")


# --- the single-session engine under the server's pins -----------------------


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("layout", ["window", "tiles"])
@pytest.mark.parametrize("model", ["unet", "decoder"])
def test_sd_session_rows_match_single_engine_under_server_pins(
        model, layout, S, monkeypatch):
    """Each session's rows of a stacked step, and of a committing step,
    equal the single-session engine planned with the server's merged pins
    (the same leaf shapes) on that session's inputs. In the window layout
    the stacked step's masked attention takes a key bias row per
    session."""
    from sige_torch.models.sd import unet as sd_unet
    from sige_torch.models.sd import vae as sd_vae

    rows = []
    for mod in (sd_unet, sd_vae):
        def spy(cov, org, res, real=mod.stale_fresh_biases):
            out = real(cov, org, res)
            rows.append(out[0].shape[0] if out[0].ndim == 2 else None)
            return out
        monkeypatch.setattr(mod, "stale_fresh_biases", spy)
    make, sessions = MODELS[model]
    args0, args1, masks = sessions(S)
    single = SIGEModel(make(), bucket_min=1, layout=layout, device="cpu")
    single.init(0)
    server = SessionServer(make(), single.module.state_dict(), bucket_min=1,
                           layout=layout, device="cpu")
    server.prime(*map(_t, args0))
    for i, m in enumerate(masks):
        server.set_masks(i, m)
    y = server.step(*map(_t, args1))
    assert rows == ([S] * len(rows) if layout == "window" else [])
    assert rows or layout == "tiles"
    y_upd = server.step(*map(_t, args1), sparse_update=True)
    assert server.model.active_layout == layout
    if layout == "window":
        assert server._stack.win_pins and not server._stack.meta_fast
    caps = server._stack._caps()
    for i, m in enumerate(masks):
        full = single.full(*(_t(a[i]) for a in args0))
        single.set_masks(m, capacities=caps)
        tol = ATOL * max(1.0, full.abs().max().item())
        for got, upd in ((y, False), (y_upd, True)):
            want = single.sparse(*(_t(a[i]) for a in args1),
                                 sparse_update=upd)
            np.testing.assert_allclose(got[i], want, atol=tol, rtol=0,
                                       err_msg=f"session {i} commit {upd}")


# --- the bias rule ------------------------------------------------------------


def _qkv(B, N, M, Hh, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, n, Hh, D, generator=g) for n in (N, M, M))


def _session_bias(S, M, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.where(torch.rand(S, M, generator=g) < 0.3, -1e9, 0.0)


@pytest.mark.parametrize("S,B", [(1, 2), (2, 4), (3, 3), (4, 8)])
def test_session_bias_equals_separate_calls(S, B):
    """Batch row b takes bias row b // (B / S): the stacked call equals S
    calls over each session's rows with that session's [M] row, exactly
    (the plain attention and the plain split partials)."""
    N, M, Hh, D = 9, 70, 2, 8  # M: three 32-key tiles, two splits
    q, k, v = _qkv(B, N, M, Hh, D)
    bias = _session_bias(S, M)
    n = B // S
    got = flash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    parts = flash.flash_partials_plain(q, k, v, D ** -0.5, bias, 2)
    for s in range(S):
        rows = slice(s * n, (s + 1) * n)
        want = flash.flash_mha_plain(q[rows], k[rows], v[rows], D ** -0.5,
                                     bias[s])
        assert torch.equal(got[rows], want)
        want_parts = flash.flash_partials_plain(
            q[rows], k[rows], v[rows], D ** -0.5, bias[s], 2)
        for a, b in zip(parts, want_parts):
            assert torch.equal(a[:, rows], b)


def test_shared_bias_is_unchanged():
    """An [M] bias (and the same row as [1, M]) computes what the plain
    version computed before per-session rows, bit for bit."""
    B, N, M, Hh, D = 3, 7, 11, 2, 8
    q, k, v = _qkv(B, N, M, Hh, D, seed=4)
    bias = _session_bias(1, M)[0]
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * D ** -0.5 + bias
    before = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1), v)
    assert torch.equal(flash.flash_mha_plain(q, k, v, D ** -0.5, bias),
                       before)
    assert torch.equal(flash.flash_mha_plain(q, k, v, D ** -0.5, bias[None]),
                       before)


def test_bias_shape_checks():
    """The kernel's wrapper takes [M] or [R, M] fp32, contiguous, with R
    dividing B, and refuses anything else before a launch."""
    q, k, v = _qkv(4, 5, 6, 1, 4)
    for bias in (torch.zeros(6), torch.zeros(1, 6), torch.zeros(2, 6),
                 torch.zeros(4, 6)):
        assert flash._check(q, k, v, bias) == (4, 5, 1, 4, 6)
    for bad in (torch.zeros(3, 6), torch.zeros(7), torch.zeros(2, 6, 1),
                torch.zeros(2, 6, dtype=torch.float64),
                torch.zeros(6, 2).t()):
        with pytest.raises(ValueError):
            flash._check(q, k, v, bad)


@pytest.mark.parametrize("shared_cov", [False, True])
def test_stacked_stale_fresh_biases_are_per_session_rows(shared_cov):
    """``stale_fresh_biases`` with [S, 2] device origins (and [S, 4]
    window metas) gives, row by row, the biases of a one-session call on
    each session's origin and coverage; origins past the map are clamped
    as the window crop clamps them."""
    rng = np.random.default_rng(0)
    res, (WH, WW) = (12, 10), (4, 6)
    orgs = np.array([[0, 0], [3, 2], [8, 4], [10, 7]])  # the last clamps
    covs = rng.random((len(orgs), WH, WW)) < 0.6
    if shared_cov:  # one coverage in every session's row
        covs[:] = covs[0]
    cov = torch.from_numpy(covs)
    got_s, got_f = stale_fresh_biases(cov, torch.from_numpy(orgs), res)
    meta = np.concatenate([orgs + 1, np.ones_like(orgs)], axis=1)
    for form in (stale_fresh_biases(cov, torch.from_numpy(meta), res),):
        assert torch.equal(form[0], got_s) and torch.equal(form[1], got_f)
    assert got_s.shape == (len(orgs), res[0] * res[1])
    assert got_f.shape == (len(orgs), WH * WW)
    for s, (r, c) in enumerate(orgs):
        r, c = min(r, res[0] - WH), min(c, res[1] - WW)
        want_s, want_f = stale_fresh_biases(
            torch.from_numpy(covs[s:s + 1]), torch.tensor([[r, c]]), res)
        assert torch.equal(got_s[s], want_s[0])
        assert torch.equal(got_f[s], want_f[0])
