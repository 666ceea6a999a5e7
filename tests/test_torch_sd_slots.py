"""Cache slots and ``sparse_update`` on the SD U-Net and the SD VAE, the
port against sige_tpu, through the sequence of
``tests/test_torch_slots.py`` (a full pass per slot, an edit committed
into the last slot, a second edit over it, slot 0 replayed under that
plan; outputs and committed caches within atol 1e-4).

  * the U-Net (window layout, the SD runner's) with its default
    transformers and with ``kv_cache_min_tokens`` at the 32 px level's
    token count (the K/V caches are scatters, so the commit writes them;
    the chain's ``k1_*`` caches keep the full pass's projections, as in
    sige_tpu), and the window chain's masked stale-K/V transformers
    running over the committed caches for the second edit;
  * the encoder and the decoder in the window layout, the tile layout,
    and the tile layout with ``tile_chain`` (the tile-resident chain
    steps aside for the commit, as the window chains do).
"""

import functools

import numpy as np
import pytest

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.sd import SDUNetConfig as JUNetConfig
from sige_tpu.models.sd import SDVAEConfig as JVAEConfig
from sige_tpu.models.sd import SIGEDecoder as JDecoder
from sige_tpu.models.sd import SIGEEncoder as JEncoder
from sige_tpu.models.sd import SIGESDUNet as JUNet
from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                  SIGEEncoder, SIGESDUNet)
from test_torch_sd_unet import (TINY_UNET, TINY_VAE, box_mask,  # noqa: F401
                                flax_params, one_torch_thread)
from test_torch_slots import SLOTS, Sequence

H = 32  # the U-Net's latent and the VAE's image size
BOX1, BOX2 = (8, 18, 10, 22), (20, 28, 2, 10)


def _edit(x, mask, seed, scale=0.7):
    noise = np.random.default_rng(seed).standard_normal(x.shape)
    return (x + scale * noise * mask[None, :, :, None]).astype(np.float32)


def _pyramid(mask):
    return downsample_mask(dilate_mask(mask, 1), min_res=4)


@functools.lru_cache(maxsize=None)
def unet_sequence(kv_tokens):
    rng = np.random.default_rng(31)
    xs = rng.standard_normal((SLOTS, 1, H, H, 4)).astype(np.float32)
    c = rng.standard_normal((1, 7, 16)).astype(np.float32)
    ts = [np.array([v], np.float32) for v in (3.0, 41.0)]
    args = [(xs[k], ts[k], c) for k in range(SLOTS)]
    m1, m2 = box_mask((H, H), BOX1), box_mask((H, H), BOX2)
    x1 = _edit(xs[-1], m1, 1)
    x2 = _edit(x1, m2, 2)
    cfg = dict(TINY_UNET, cache_slots=SLOTS)
    if kv_tokens:
        cfg["kv_cache_min_tokens"] = kv_tokens
    params = flax_params(JUNet(cfg=JUNetConfig(**cfg)), *args[0])
    return Sequence(JUNet(cfg=JUNetConfig(**cfg)), params,
                    SIGESDUNet(SDUNetConfig(**cfg)), "window", args,
                    (_pyramid(m1), (x1, ts[-1], c)),
                    (_pyramid(m2), (x2, ts[-1], c)), bucket_min=2)


@pytest.mark.parametrize("kv_tokens", [None, H * H],
                         ids=["default", "kv_cached"])
def test_unet_slots_and_sparse_update_match_sige_tpu(kv_tokens):
    unet_sequence(kv_tokens).check()


def test_unet_chain_steps_aside_for_the_commit(monkeypatch):
    """The masked stale-K/V transformers are off under sparse_update and
    on for the second edit over the committed slot."""
    from sige_torch.models.sd import unet

    seq = unet_sequence(None)
    calls = []
    orig = unet.SIGESpatialTransformer._chain_window

    def spy(self, x, ctx, context):
        calls.append(ctx.sparse_update)
        return orig(self, x, ctx, context)

    monkeypatch.setattr(unet.SIGESpatialTransformer, "_chain_window", spy)
    seq.check()
    assert calls and not any(calls)


MODELS = {"encoder": (JEncoder, SIGEEncoder), "decoder": (JDecoder,
                                                          SIGEDecoder)}


@functools.lru_cache(maxsize=None)
def vae_sequence(kind, layout, tile_chain):
    """The encoder takes images, the decoder latents of half the size (its
    edits are the image edits halved); the mask pyramids come from the
    image-size masks."""
    rng = np.random.default_rng(41 + len(kind))
    shape = (1, H, H, 3) if kind == "encoder" else (1, H // 2, H // 2, 4)
    xs = rng.standard_normal((SLOTS,) + shape).astype(np.float32)
    m1, m2 = box_mask((H, H), BOX1), box_mask((H, H), BOX2)
    step = 1 if kind == "encoder" else 2
    x1 = _edit(xs[-1], m1[::step, ::step], 1)
    x2 = _edit(x1, m2[::step, ::step], 2)
    cfg = dict(TINY_VAE, cache_slots=SLOTS, tile_chain=tile_chain)
    jcls, tcls = MODELS[kind]
    args = [(xs[k],) for k in range(SLOTS)]
    params = flax_params(jcls(cfg=JVAEConfig(**cfg)), *args[0])
    return Sequence(jcls(cfg=JVAEConfig(**cfg)), params,
                    tcls(SDVAEConfig(**cfg)), layout, args,
                    (_pyramid(m1), (x1,)), (_pyramid(m2), (x2,)),
                    bucket_min=2)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("layout,tile_chain", [("window", False),
                                               ("tiles", False),
                                               ("tiles", True)],
                         ids=["window", "tiles", "tile_chain"])
def test_vae_slots_and_sparse_update_match_sige_tpu(kind, layout,
                                                    tile_chain):
    vae_sequence(kind, layout, tile_chain).check()
