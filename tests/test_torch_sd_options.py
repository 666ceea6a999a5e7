"""The SD models' last two options in the port against sige_tpu, on the
tiny configurations of ``tests/test_sd.py`` with weights carried by
``utils/from_jax.py``:

  * the U-Net's K/V-cached transformers (``kv_cache_min_tokens``): 1 puts
    every sparse attention level on the K/V caches, 512 only the 32 px
    level (1024 tokens; the 16 px level has 256), in the tile and the
    window layout, at batch 2;
  * the VAE's tile-resident chain (``tile_chain``, tile layout), on the
    encoder and the decoder, with ``sige_tail`` on and off.

Full and sparse outputs agree with sige_tpu at atol 1e-4 (fp32 on both
sides), sparse on the original input equals full (also after a sparse
pass on the edit), the plans' ``pixbox_*`` / ``pixorg_*`` records equal
sige_tpu's key by key, and the tile chain's output equals the unchained
port's on the same plan.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.sd import SDUNetConfig as JUNetConfig
from sige_tpu.models.sd import SDVAEConfig as JVAEConfig
from sige_tpu.models.sd import SIGEDecoder as JDecoder
from sige_tpu.models.sd import SIGEEncoder as JEncoder
from sige_tpu.models.sd import SIGESDUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.utils import traced_macs
from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                  SIGEEncoder, SIGESDUNet)
from sige_torch.models.sd import unet as sd_unet
from sige_torch.models.sd import vae as sd_vae
from sige_torch.nn import SIGEModel
from sige_torch.nn.module import SIGECtx, TileState
from sige_torch.nn.planner import plan_rows
from sige_torch.utils.from_jax import state_dict_from_flax, torch_path
from test_torch_sd_unet import (ATOL, TINY_UNET, TINY_VAE, box_mask,
                                flax_params,
                                one_torch_thread)  # noqa: F401 (autouse)

H = 32                      # U-Net latent size
UNET_EDIT = (8, 18, 10, 22)
KV = [1, 512]
LAYOUTS = ["tiles", "window"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(args):
    return [jnp.asarray(a) for a in args]


def _flat(plan, torch_names):
    """{path: leaf} of a plan tree, paths in the port's module names."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            p = path + (torch_path((k,)) if torch_names else (k,))
            if hasattr(v, "items"):
                walk(v, p)
            else:
                out["/".join(p)] = np.asarray(v)

    walk(plan, ())
    return out


# --- the U-Net's K/V-cached transformers ---------------------------------

class UNetInputs:
    """Batch-2 inputs, the edit's mask pyramid and the seeded weights."""

    def __init__(self):
        rng = np.random.default_rng(7)
        self.x0 = rng.standard_normal((2, H, H, 4)).astype(np.float32)
        self.t = np.full((2,), 3.0, np.float32)
        self.c = rng.standard_normal((2, 7, 16)).astype(np.float32)
        mask = box_mask((H, H), UNET_EDIT)
        noise = rng.standard_normal(self.x0.shape).astype(np.float32)
        self.x1 = (self.x0 + noise * mask[None, :, :, None]).astype(
            np.float32)
        self.masks = downsample_mask(dilate_mask(mask, 1), min_res=4)
        self.args0 = (self.x0, self.t, self.c)
        self.args1 = (self.x1, self.t, self.c)
        self.params = flax_params(JUNet(cfg=JUNetConfig(**TINY_UNET)),
                                  *self.args0, seed=3)
        self.sd = state_dict_from_flax(self.params)


@functools.lru_cache(maxsize=None)
def _unet_inputs():
    return UNetInputs()


@functools.lru_cache(maxsize=None)
def _unet_reference(kv, layout):
    """sige_tpu's full and sparse outputs and its model."""
    p = _unet_inputs()
    jm = JModel(JUNet(cfg=JUNetConfig(**TINY_UNET, kv_cache_min_tokens=kv)),
                p.params, layout=layout)
    full = np.asarray(jm.full(*_j(p.args0)))
    jm.set_masks(p.masks)
    return full, np.asarray(jm.sparse(*_j(p.args1))), jm


def _unet_port(kv, layout):
    p = _unet_inputs()
    tm = SIGEModel(SIGESDUNet(SDUNetConfig(**TINY_UNET,
                                           kv_cache_min_tokens=kv)),
                   layout=layout, device="cpu")
    tm.module.load_state_dict(p.sd, strict=True)
    full = tm.full(*map(_t, p.args0)).numpy()
    tm.set_masks(p.masks)
    return tm, full


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kv", KV)
def test_kv_cache_forwards_match_sige_tpu(kv, layout):
    p = _unet_inputs()
    j_full, j_sparse, _ = _unet_reference(kv, layout)
    tm, full = _unet_port(kv, layout)
    assert tm.active_layout == layout
    np.testing.assert_allclose(full, j_full, atol=ATOL, rtol=0)
    sparse = tm.sparse(*map(_t, p.args1)).numpy()
    np.testing.assert_allclose(sparse, j_sparse, atol=ATOL, rtol=0)
    assert np.abs(sparse - full).max() > 1e-2
    # sparse on the original equals full, also after the edit's sparse
    # pass (a K/V scatter that wrote into its cache would show there)
    np.testing.assert_allclose(tm.sparse(*map(_t, p.args0)).numpy(), full,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv", KV)
def test_kv_cached_levels_leave_the_window_chain(kv, monkeypatch):
    """A K/V-cached level writes its K/V maps through the scatter pairs
    and no ``k1_*``, so in the window layout its sparse pass takes the
    non-chain path; the other sparse levels still chain."""
    chained = []
    orig = sd_unet.SIGESpatialTransformer._chain_window

    def spy(self, *a):
        chained.append(self)
        return orig(self, *a)

    monkeypatch.setattr(sd_unet.SIGESpatialTransformer, "_chain_window", spy)
    tm, _ = _unet_port(kv, "window")
    tm.sparse(*map(_t, _unet_inputs().args1))
    mods = [m for m in tm.module.modules()
            if isinstance(m, sd_unet.SIGESpatialTransformer) and m.sparse_ok]
    cached = [m for m in mods if "original" in m.kv_scatters[0][0].cache]
    assert all("k1_0" not in m.cache for m in cached)
    want = {id(m) for m in mods} - {id(m) for m in cached}
    assert {id(m) for m in chained} == want
    # kv=1: every sparse level is cached; 512: the 32 px levels only
    assert len(cached) == (len(mods) if kv == 1 else 3)


def test_kv_cache_macs_match_sige_tpu():
    p = _unet_inputs()
    _, _, jm = _unet_reference(512, "window")
    tm, _ = _unet_port(512, "window")
    for mode in ("full", "sparse"):
        ctx = SIGECtx(mode=mode, macs=[])
        with torch.inference_mode():
            tm.module(*map(_t, p.args1), ctx=ctx)
        want = traced_macs(jm.module, {"params": jm.params, "cache": jm.cache,
                                       "sige": jm.plan},
                           *_j(p.args1), ctx=JCtx(mode=mode))
        assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


# --- the VAE's tile-resident chain -----------------------------------------

R = TINY_VAE["resolution"]
VAE_EDIT = (8, 13, 10, 16)
MODELS = {"encoder": (JEncoder, SIGEEncoder),
          "decoder": (JDecoder, SIGEDecoder)}


@functools.lru_cache(maxsize=None)
def _vae_inputs(kind):
    """(original, edited, mask pyramid, flax params): an image for the
    encoder, a latent for the decoder (its edit the image edit halved)."""
    rng = np.random.default_rng(11 + len(kind))
    mask = box_mask((R, R), VAE_EDIT)
    if kind == "encoder":
        x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
        m = mask
    else:
        x0 = rng.standard_normal((1, R // 2, R // 2, 4)).astype(np.float32)
        m = mask[::2, ::2]
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    x1 = (x0 + 0.7 * noise * m[None, :, :, None]).astype(np.float32)
    params = flax_params(MODELS[kind][0](cfg=JVAEConfig(**TINY_VAE)), x0,
                         seed=5)
    return x0, x1, downsample_mask(dilate_mask(mask, 1), min_res=4), params


@functools.lru_cache(maxsize=None)
def _vae_reference(kind, tail):
    x0, x1, masks, params = _vae_inputs(kind)
    jm = JModel(MODELS[kind][0](cfg=JVAEConfig(**TINY_VAE, sige_tail=tail,
                                                tile_chain=True)),
                params, layout="tiles")
    full = np.asarray(jm.full(jnp.asarray(x0)))
    jm.set_masks(masks)
    return full, np.asarray(jm.sparse(jnp.asarray(x1))), jm


def _vae_port(kind, tail, chain=True):
    x0, _, masks, params = _vae_inputs(kind)
    tm = SIGEModel(MODELS[kind][1](SDVAEConfig(**TINY_VAE, sige_tail=tail,
                                               tile_chain=chain)),
                   layout="tiles", device="cpu")
    tm.module.load_state_dict(state_dict_from_flax(params), strict=True)
    full = tm.full(_t(x0)).numpy()
    tm.set_masks(masks)
    return tm, full


@pytest.mark.parametrize("tail", [True, False], ids=["tail1", "tail0"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_tile_chain_matches_sige_tpu(kind, tail, monkeypatch):
    x0, x1, _, _ = _vae_inputs(kind)
    j_full, j_sparse, _ = _vae_reference(kind, tail)
    states = []
    orig = sd_vae.SIGEVAEResnetBlock._chain_sparse

    def spy(self, *a):
        out = orig(self, *a)
        states.append(out)
        return out

    monkeypatch.setattr(sd_vae.SIGEVAEResnetBlock, "_chain_sparse", spy)
    tm, full = _vae_port(kind, tail)
    np.testing.assert_allclose(full, j_full, atol=ATOL, rtol=0)
    sparse = tm.sparse(_t(x1)).numpy()
    np.testing.assert_allclose(sparse, j_sparse, atol=ATOL, rtol=0)
    chainable = [m for m in tm.module.modules()
                 if isinstance(m, sd_vae.SIGEVAEResnetBlock) and m._chainable]
    assert len(states) == len(chainable) > 0
    assert all(isinstance(s, TileState) for s in states)
    # chained = unchained on the same edit and plan
    un, _ = _vae_port(kind, tail, chain=False)
    np.testing.assert_allclose(sparse, un.sparse(_t(x1)).numpy(), atol=ATOL,
                               rtol=0)
    assert np.abs(sparse - full).max() > 1e-2
    # sparse on the original equals full, after the edit's sparse pass
    np.testing.assert_allclose(tm.sparse(_t(x0)).numpy(), full, atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_tile_chain_plan_records_match_sige_tpu(kind):
    """Every plan record of the tile layout with ``tile_chain`` equals
    sige_tpu's, the chainable blocks' ``pixbox_*`` / ``pixorg_*`` among
    them."""
    _, _, jm = _vae_reference(kind, True)
    tm, _ = _vae_port(kind, True)
    got = _flat(plan_rows(tm.plan_host, 0), False)
    want = _flat(jm._plan_host, True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k
    pix = {k.rsplit("/", 1)[0] for k in got if "/pixbox_" in k}
    chainable = {n.replace(".", "/") for n, m in tm.module.named_modules()
                 if isinstance(m, sd_vae.SIGEVAEResnetBlock)
                 and m._chainable}
    assert pix == {f"{n}/main_gather" for n in chainable}
