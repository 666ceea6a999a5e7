"""The port's SD VAE encoder and decoder against sige_tpu's, on the tiny
configuration of ``tests/test_sd.py`` with weights carried by
``utils/from_jax.py``.

In the window layout (the SD runner's), with ``sige_tail`` on (the
windowed stem and tail) and off: full and sparse outputs agree with
sige_tpu at atol 1e-4 (fp32 on both sides), sparse on the original input
equals full, also after a sparse call on the edited input, and MACs
equal sige_tpu's traced count. The mid block's attention runs its masked
stale-K/V form. An edit at the image border runs the stride-2
downsample with its (0,1,0,1) pad through the tile layout and through
the window layout's stride-2 chain.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.sd import SDVAEConfig as JConfig
from sige_tpu.models.sd import SIGEDecoder as JDecoder
from sige_tpu.models.sd import SIGEEncoder as JEncoder
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.utils import traced_macs
from sige_torch.models.sd import SDVAEConfig, SIGEDecoder, SIGEEncoder
from sige_torch.models.sd import vae as sd_vae
from sige_torch.nn import SIGEModel
from sige_torch.nn.module import SIGECtx, WindowState
from sige_torch.nn.planner import plan_rows
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import (ATOL, TINY_VAE, box_mask, flax_params,
                                gather_plans, one_torch_thread)

R = TINY_VAE["resolution"]
L = R // 2
EDIT = (8, 13, 10, 16)
BORDER = (0, 7, 25, 32)  # the top-right corner
MODELS = {"encoder": (JEncoder, SIGEEncoder), "decoder": (JDecoder,
                                                          SIGEDecoder)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(kind, box, seed):
    """(original, edited, mask pyramid): an image for the encoder, a latent
    for the decoder (its edit is the image edit halved); the pyramid comes
    from the image-resolution mask in both cases."""
    rng = np.random.default_rng(seed)
    mask = box_mask((R, R), box)
    if kind == "encoder":
        x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
        m = mask
    else:
        x0 = rng.standard_normal((1, L, L, 4)).astype(np.float32)
        m = mask[::2, ::2]
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    x1 = (x0 + 0.7 * noise * m[None, :, :, None]).astype(np.float32)
    return x0, x1, downsample_mask(dilate_mask(mask, 1), min_res=4)


@functools.lru_cache(maxsize=None)
def _params(kind):
    """The weights: one tree per model (``sige_tail`` adds none)."""
    x0 = _inputs(kind, EDIT, seed=len(kind))[0]
    return flax_params(MODELS[kind][0](cfg=JConfig(**TINY_VAE)), x0)


@functools.lru_cache(maxsize=None)
def _reference_full(kind, tail):
    """sige_tpu's model and its full pass on the original input, which
    every edit and layout shares (the original input does not depend on
    the edit, nor the full pass on the layout)."""
    x0 = _inputs(kind, EDIT, seed=len(kind))[0]
    jm = JModel(MODELS[kind][0](cfg=JConfig(**TINY_VAE, sige_tail=tail)),
                _params(kind), layout="window")
    return jm, np.asarray(jm.full(jnp.asarray(x0)))


class Pair:
    """sige_tpu's model and the port's with the same weights."""

    def __init__(self, kind, tail, box=EDIT, layout="window"):
        jcls, self.tcls = MODELS[kind]
        self.cfg = dict(TINY_VAE, sige_tail=tail)
        self.layout = layout
        self.x0, self.x1, self.masks = _inputs(kind, box, seed=len(kind))
        self.sd = state_dict_from_flax(_params(kind))
        base, self.j_full = _reference_full(kind, tail)
        jm = JModel(jcls(cfg=JConfig(**self.cfg)), base.params,
                    layout=layout)
        jm.cache, jm.meta = base.cache, base.meta
        jm.set_masks(self.masks)
        self.j_sparse = np.asarray(jm.sparse(jnp.asarray(self.x1)))
        self.jm = jm

    def primed(self):
        tm = SIGEModel(self.tcls(SDVAEConfig(**self.cfg)), layout=self.layout,
                       device="cpu")
        tm.module.load_state_dict(self.sd, strict=True)
        full = tm.full(_t(self.x0)).numpy()
        tm.set_masks(self.masks)
        return tm, full


@functools.lru_cache(maxsize=None)
def _pair(kind, tail=True, box=EDIT, layout="window"):
    return Pair(kind, tail, box, layout)


@pytest.fixture(scope="module", params=[(k, t) for k in MODELS
                                        for t in (True, False)],
                ids=lambda p: f"{p[0]}-tail{int(p[1])}")
def pair(request):
    return _pair(*request.param)


def test_flax_tree_loads_strictly(pair):
    module = pair.tcls(SDVAEConfig(**pair.cfg))
    assert set(module.state_dict()) == set(pair.sd)
    module.load_state_dict(pair.sd, strict=True)


def test_forwards_match_sige_tpu(pair):
    tm, full = pair.primed()
    np.testing.assert_allclose(full, pair.j_full, atol=ATOL, rtol=0)
    sparse = tm.sparse(_t(pair.x1)).numpy()
    np.testing.assert_allclose(sparse, pair.j_sparse, atol=ATOL, rtol=0)


def test_sparse_on_original_equals_full_also_after_an_edit(pair):
    tm, full = pair.primed()
    np.testing.assert_allclose(tm.sparse(_t(pair.x0)).numpy(), full,
                               atol=ATOL, rtol=0)
    edited = tm.sparse(_t(pair.x1)).numpy()
    assert np.abs(edited - full).max() > 1e-2
    np.testing.assert_allclose(tm.sparse(_t(pair.x0)).numpy(), full,
                               atol=ATOL, rtol=0)


def test_mid_attention_runs_masked_stale_kv(pair, monkeypatch):
    outs = []
    orig = sd_vae.SIGEVAEAttnBlock._chain_window

    def spy(self, x, ctx):
        out = orig(self, x, ctx)
        outs.append(out)
        return out

    monkeypatch.setattr(sd_vae.SIGEVAEAttnBlock, "_chain_window", spy)
    tm, _ = pair.primed()
    tm.sparse(_t(pair.x1))
    assert len(outs) == 1 and isinstance(outs[0], WindowState)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_macs_match_sige_tpu(kind):
    p = _pair(kind)
    tm, _ = p.primed()
    ctx = SIGECtx(mode="sparse", macs=[])
    with torch.inference_mode():
        tm.module(_t(p.x1), ctx=ctx)
    want = traced_macs(p.jm.module, {"params": p.jm.params,
                                     "cache": p.jm.cache, "sige": p.jm.plan},
                       jnp.asarray(p.x1), ctx=JCtx(mode="sparse"))
    assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_border_edit_through_the_stride2_downsample(layout):
    """An edit at the image border: 4-form window metas, the stride-2
    chain across the (0,1,0,1)-padded downsample (window), or its tile
    gather with padding 0 (tiles)."""
    p = _pair("encoder", True, BORDER, layout)
    tm, full = p.primed()
    down = tm.module.downsamples[0].g.plan
    plan = plan_rows(tm.plan_host, 0)
    if layout == "window":
        assert "wdn_ok" in down
        assert any(len(g["win_in"]) == 4 for g in gather_plans(plan))
    else:
        assert not any("win_in" in g for g in gather_plans(plan))
    np.testing.assert_allclose(full, p.j_full, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.sparse(_t(p.x1)).numpy(), p.j_sparse,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.sparse(_t(p.x0)).numpy(), full,
                               atol=ATOL, rtol=0)
