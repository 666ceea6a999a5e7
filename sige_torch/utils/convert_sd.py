"""Stable Diffusion checkpoint conversion (sd-v1-4 style LDM state dict ->
the port's state dicts for SIGESDUNet / SIGEEncoder / SIGEDecoder) — the
port of ``sige_tpu.utils.convert_sd``.

The reference loads a lightning checkpoint with ``model.diffusion_model.``
(UNet), ``first_stage_model.`` (VAE), and ``cond_stage_model.`` (CLIP)
prefixes (reference: stable-diffusion/utils.py:22-39
``load_model_from_config``; key layouts per
ldm/modules/diffusionmodules/openaimodel.py:198-265 ResBlock,
ldm/modules/attention.py:39-160 SpatialTransformer, and
ldm/modules/diffusionmodules/model.py Encoder/Decoder).

The AutoencoderKL's ``quant_conv`` (reference:
ldm/models/autoencoder.py:27-28,74-79) is *folded* into
``encoder.conv_out`` at conversion time — two chained linear maps compose
exactly, so the runner needs no extra op; ``post_quant_conv`` becomes the
runner's pointwise latent map (``SDRunner``'s ``post_quant``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from .convert import StateDict, _Renamer, _f32


def strip_prefix(sd: Mapping, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# UNet


def _sd_resblock(b: _Renamer, src: str, dst: str):
    """openaimodel ResBlock (reference: openaimodel.py:198-265)."""
    b.norm(f"{src}.in_layers.0", f"{dst}/norm1")
    b.conv(f"{src}.in_layers.2", f"{dst}/conv1")
    b.linear(f"{src}.emb_layers.1", f"{dst}/emb_proj")
    b.norm(f"{src}.out_layers.0", f"{dst}/norm2")
    b.conv(f"{src}.out_layers.3", f"{dst}/conv2")
    if b.has(f"{src}.skip_connection.weight"):
        b.conv(f"{src}.skip_connection", f"{dst}/skip")


def _sd_transformer(b: _Renamer, src: str, dst: str, depth: int):
    """SpatialTransformer (reference: attention.py:39-160)."""
    b.norm(f"{src}.norm", f"{dst}/norm")
    b.conv(f"{src}.proj_in", f"{dst}/proj_in")
    for d in range(depth):
        t, o = f"{src}.transformer_blocks.{d}", f"{dst}/blocks_{d}"
        for attn in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                b.linear(f"{t}.{attn}.{p}", f"{o}/{attn}/{p}")
            b.linear(f"{t}.{attn}.to_out.0", f"{o}/{attn}/to_out")
        b.linear(f"{t}.ff.net.0.proj", f"{o}/ff/proj")
        b.linear(f"{t}.ff.net.2", f"{o}/ff/out")
        for i in (1, 2, 3):
            b.norm(f"{t}.norm{i}", f"{o}/norm{i}")
    b.conv(f"{src}.proj_out", f"{dst}/proj_out")


def convert_sd_unet(
    sd: Mapping,
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    attention_resolutions: Tuple[int, ...] = (4, 2, 1),
    transformer_depth: int = 1,
) -> StateDict:
    """``model.diffusion_model.``-stripped state dict -> the state dict of
    :class:`~sige_torch.models.sd.SIGESDUNet`. Traversal mirrors
    openaimodel.UNetModel.__init__ (input_blocks index = the port's
    ``in_blocks`` index + 1)."""
    b = _Renamer(sd)
    b.linear("time_embed.0", "time_dense0")
    b.linear("time_embed.2", "time_dense1")
    b.conv("input_blocks.0.0", "conv_in")

    ds, i = 1, 0
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            src = f"input_blocks.{i + 1}"
            _sd_resblock(b, f"{src}.0", f"in_blocks_{i}_0")
            if ds in attention_resolutions:
                _sd_transformer(b, f"{src}.1", f"in_blocks_{i}_1",
                                transformer_depth)
            i += 1
        if level != len(channel_mult) - 1:
            b.conv(f"input_blocks.{i + 1}.0.op", f"in_blocks_{i}_0/op")
            i += 1
            ds *= 2

    _sd_resblock(b, "middle_block.0", "mid_block1")
    _sd_transformer(b, "middle_block.1", "mid_attn", transformer_depth)
    _sd_resblock(b, "middle_block.2", "mid_block2")

    n = 0
    for level in range(len(channel_mult))[::-1]:
        for blk in range(num_res_blocks + 1):
            src = f"output_blocks.{n}"
            _sd_resblock(b, f"{src}.0", f"out_blocks_{n}_0")
            j = 1
            if ds in attention_resolutions:
                _sd_transformer(b, f"{src}.{j}", f"out_blocks_{n}_{j}",
                                transformer_depth)
                j += 1
            if level and blk == num_res_blocks:
                b.conv(f"{src}.{j}.conv", f"out_blocks_{n}_{j}/conv")
                ds //= 2
            n += 1

    b.put("", "out_norm_scale", b.get("out.0.weight"))
    b.put("", "out_norm_bias", b.get("out.0.bias"))
    b.conv("out.2", "conv_out")
    return b.out


# ---------------------------------------------------------------------------
# VAE


def _vae_resblock(b: _Renamer, src: str, dst: str):
    for p in ("norm1", "conv1", "norm2", "conv2"):
        b.conv(f"{src}.{p}", f"{dst}/{p}")
    if b.has(f"{src}.nin_shortcut.weight"):
        b.conv(f"{src}.nin_shortcut", f"{dst}/nin_shortcut")


def _vae_attn(b: _Renamer, src: str, dst: str):
    for p in ("norm", "q", "k", "v", "proj_out"):
        b.conv(f"{src}.{p}", f"{dst}/{p}")


def _fold_after(kernel_oihw, bias, w_1x1, b_1x1):
    """Fold a following 1x1 conv: y = W(conv(x)) + b."""
    w = w_1x1.reshape(w_1x1.shape[0], w_1x1.shape[1])  # [O2, O1]
    k = torch.einsum("po,oihw->pihw", w, kernel_oihw)
    return k, w @ bias + b_1x1


def convert_sd_encoder(
    sd: Mapping,
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    attn_resolutions: Tuple[int, ...] = (),
    resolution: int = 512,
    quant_conv=None,
) -> StateDict:
    """``first_stage_model.encoder.``-stripped state dict -> the state dict
    of :class:`SIGEEncoder`; ``quant_conv=(weight, bias)`` is folded into
    ``conv_out`` (in float64, rounded once to float32)."""
    b = _Renamer(sd)
    b.conv("conv_in", "conv_in")
    curr_res = resolution
    for i in range(len(ch_mult)):
        for blk in range(num_res_blocks):
            _vae_resblock(b, f"down.{i}.block.{blk}", f"down_blocks_{i}_{blk}")
            if curr_res in attn_resolutions:
                _vae_attn(b, f"down.{i}.attn.{blk}", f"down_attns_{i}_{blk}")
        if i != len(ch_mult) - 1:
            b.conv(f"down.{i}.downsample.conv", f"downsamples_{i}/conv")
            curr_res //= 2
    _vae_resblock(b, "mid.block_1", "mid_block1")
    _vae_attn(b, "mid.attn_1", "mid_attn")
    _vae_resblock(b, "mid.block_2", "mid_block2")
    b.put("", "norm_out_scale", b.get("norm_out.weight"))
    b.put("", "norm_out_bias", b.get("norm_out.bias"))
    k, bias = b.get("conv_out.weight"), b.get("conv_out.bias")
    if quant_conv is not None:
        k, bias = _fold_after(k.double(), bias.double(),
                              *(_f32(a).double() for a in quant_conv))
    b.put("conv_out", "weight", k.float())
    b.put("conv_out", "bias", bias.float())
    return b.out


def convert_sd_decoder(
    sd: Mapping,
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    attn_resolutions: Tuple[int, ...] = (),
    resolution: int = 512,
) -> StateDict:
    """``first_stage_model.decoder.``-stripped state dict -> the state dict
    of :class:`SIGEDecoder`. ``post_quant_conv`` cannot be folded into the
    zero-padded ``conv_in`` (the pad would have to carry its bias); the
    runner applies it as a pointwise map on the latent instead."""
    b = _Renamer(sd)
    b.conv("conv_in", "conv_in")
    _vae_resblock(b, "mid.block_1", "mid_block1")
    _vae_attn(b, "mid.attn_1", "mid_attn")
    _vae_resblock(b, "mid.block_2", "mid_block2")
    curr_res = resolution // (2 ** (len(ch_mult) - 1))
    for i in reversed(range(len(ch_mult))):
        for blk in range(num_res_blocks + 1):
            _vae_resblock(b, f"up.{i}.block.{blk}", f"up_blocks_{i}_{blk}")
            if curr_res in attn_resolutions:
                _vae_attn(b, f"up.{i}.attn.{blk}", f"up_attns_{i}_{blk}")
        if i != 0:
            b.conv(f"up.{i}.upsample.conv", f"upsamples_{i - 1}/conv")
            curr_res *= 2
    b.put("", "norm_out_scale", b.get("norm_out.weight"))
    b.put("", "norm_out_bias", b.get("norm_out.bias"))
    b.conv("conv_out", "conv_out")
    return b.out


def convert_sd(
    sd: Mapping,
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    attention_resolutions: Tuple[int, ...] = (4, 2, 1),
    transformer_depth: int = 1,
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
    vae_num_res_blocks: int = 2,
    vae_attn_resolutions: Tuple[int, ...] = (),
    resolution: int = 512,
) -> Dict:
    """Full sd-v1-4 state dict -> ``{"unet", "encoder", "decoder"}`` state
    dicts and ``"post_quant"`` (weight [z, z], bias [z]), what
    :class:`~sige_torch.runners.SDRunner` takes as ``params``."""
    unet_sd = strip_prefix(sd, "model.diffusion_model.")
    enc_sd = strip_prefix(sd, "first_stage_model.encoder.")
    dec_sd = strip_prefix(sd, "first_stage_model.decoder.")
    quant = (sd["first_stage_model.quant_conv.weight"],
             sd["first_stage_model.quant_conv.bias"])
    pq_w = _f32(sd["first_stage_model.post_quant_conv.weight"])
    pq_b = _f32(sd["first_stage_model.post_quant_conv.bias"])
    return {
        "unet": convert_sd_unet(
            unet_sd, channel_mult, num_res_blocks, attention_resolutions,
            transformer_depth),
        "encoder": convert_sd_encoder(
            enc_sd, vae_ch_mult, vae_num_res_blocks, vae_attn_resolutions,
            resolution, quant_conv=quant),
        "decoder": convert_sd_decoder(
            dec_sd, vae_ch_mult, vae_num_res_blocks, vae_attn_resolutions,
            resolution),
        # pointwise latent map applied by the runner before the decoder
        "post_quant": (pq_w.reshape(pq_w.shape[0], pq_w.shape[1]), pq_b),
    }
