"""Checkpoint conversion: reference torch state dicts -> the port's state
dicts — the port of ``sige_tpu.utils.convert``.

The reference ships torch checkpoints (``church256-ddpm-fused_unet.pth``
etc.; reference: diffusion/download_helper.py:8-20) with the FusedUNet
naming scheme (reference: diffusion/models/ddpm_arch/fused_unet.py). The
port's modules keep the reference's layouts (OIHW conv weights, [out, in]
linear weights, norm ``weight`` / ``bias``) under ``sige_tpu``'s module
names, so a conversion renames keys and performs the reference's weight
surgeries (the fused temb projection, q/k/v -> qkv, SPADE's mlp
concatenations, the sub-mobile running-statistic truncation); it never
transposes. Destinations are written as ``sige_tpu``'s flax paths
(``down_blocks_0_1/conv1``) and named through
:func:`sige_torch.utils.from_jax.torch_path`, the one place that holds
how a flax module path becomes the port's.

Each converter returns ``{key: float32 tensor}`` that the port's module
loads with ``load_state_dict(strict=True)``; :func:`assert_params_match`
names what a state dict lacks or has too much against a module's.

Also provides md5-verified checkpoint loading (the reference re-downloads
on checksum mismatch; reference: diffusion/download_helper.py:28-47 —
this only verifies, with no network).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from .from_jax import torch_path

StateDict = Dict[str, torch.Tensor]


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_torch_state_dict(path: str, md5: str | None = None,
                          prefer_ema: bool = True) -> StateDict:
    """Read a reference .pth into {name: CPU tensor}.

    Handles the reference's container formats: lightning ``state_dict``
    wrappers, and diffusion training states ``{"model": ..., "ema": ...}``
    (reference: diffusion/runner.py:74-86) — with ``prefer_ema`` the EMA
    shadow params overlay the live ones, matching ``config.model.ema``
    inference — and strips DataParallel's ``module.`` prefix. A lightning
    checkpoint pickles more than tensors, so the file is unpickled in full
    (``weights_only=False``), as the reference does: read only
    checkpoints you trust.
    """
    if md5 is not None:
        got = md5_file(path)
        if got != md5:
            raise ValueError(f"checkpoint md5 mismatch: {got} != {md5}")
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if (isinstance(sd, dict) and isinstance(sd.get("model"), dict)
            and not isinstance(sd["model"], torch.Tensor)):
        base = dict(sd["model"])
        if prefer_ema and isinstance(sd.get("ema"), dict):
            base.update(sd["ema"])
        sd = base
    return {k.removeprefix("module."): v.detach()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _f32(v) -> torch.Tensor:
    """A reference value (tensor or numpy array) as a float32 CPU tensor."""
    t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                        else v)
    return t.detach().to("cpu", torch.float32)


class _Renamer:
    """Reads reference keys and writes the port's: ``put("down_blocks_0_1/
    conv1", "weight", w)`` stores ``down_blocks.0.1.conv1.weight``."""

    def __init__(self, sd: Mapping):
        self.sd = sd
        self.out: StateDict = {}

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str) -> torch.Tensor:
        return _f32(self.sd[key])

    def put(self, dst: str, leaf: str, value: torch.Tensor) -> None:
        path = torch_path(dst.split("/")) if dst else ()
        self.out[".".join(path + (leaf,))] = value.contiguous()

    def conv(self, src: str, dst: str) -> None:
        """A conv or linear layer: the same layout on both sides."""
        self.put(dst, "weight", self.get(f"{src}.weight"))
        if self.has(f"{src}.bias"):
            self.put(dst, "bias", self.get(f"{src}.bias"))

    linear = conv
    norm = conv

    def cat(self, srcs: Iterable[str], dst: str) -> None:
        """Layers stacked along their outputs (the reference's fusing
        surgeries): one conv or linear whose weight and bias are the
        sources' in order."""
        srcs = list(srcs)
        for leaf in ("weight", "bias"):
            self.put(dst, leaf, torch.cat(
                [self.get(f"{s}.{leaf}") for s in srcs], dim=0))

    def stats(self, src: str, dst: str, n: int | None = None) -> None:
        """BatchNorm running statistics (the first ``n`` channels)."""
        for leaf in ("running_mean", "running_var"):
            self.put(dst, leaf, self.get(f"{src}.param_free_norm.{leaf}")[:n])


def _ddpm_walk(b: _Renamer, resblock, attnblock, resample,
               ch_mult, num_res_blocks, attn_resolutions, resolution):
    """The DDPM / PD U-Net traversal shared by their checkpoints: down
    levels, the middle, up levels (reference: fused_unet.py:262-295)."""
    nres = len(ch_mult)
    curr_res = resolution
    for i in range(nres):
        for blk in range(num_res_blocks):
            resblock(f"down.{i}.block.{blk}", f"down_blocks_{i}_{blk}")
            if curr_res in attn_resolutions:
                attnblock(f"down.{i}.attn.{blk}", f"down_attns_{i}_{blk}")
        if i != nres - 1:
            resample(f"down.{i}.downsample", f"downsamples_{i}")
            curr_res //= 2
    resblock("mid.block_1", "mid_block1")
    attnblock("mid.attn_1", "mid_attn")
    resblock("mid.block_2", "mid_block2")
    for i in reversed(range(nres)):
        for blk in range(num_res_blocks + 1):
            resblock(f"up.{i}.block.{blk}", f"up_blocks_{i}_{blk}")
            if curr_res in attn_resolutions:
                attnblock(f"up.{i}.attn.{blk}", f"up_attns_{i}_{blk}")
        if i != 0:
            resample(f"up.{i}.upsample", f"upsamples_{i - 1}")
            curr_res *= 2


def _shortcuts(b: _Renamer, src: str, dst: str) -> None:
    for name in ("nin_shortcut", "conv_shortcut"):
        if b.has(f"{src}.{name}.weight"):
            b.conv(f"{src}.{name}", f"{dst}/{name}")


def convert_ddpm_fused_unet(
    sd: Mapping,
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4),
    num_res_blocks: int = 2,
    attn_resolutions: Tuple[int, ...] = (16,),
    resolution: int = 256,
) -> StateDict:
    """A reference FusedUNet / SIGEFusedUNet state dict -> the state dict
    of :class:`sige_torch.models.ddpm.SIGEFusedUNet`. The reference's
    fused temb projection (``temb.dense.2``) is the port's ``temb_proj``;
    their slice orders (down, mid, up traversal) match (reference:
    fused_unet.py:262-295)."""
    b = _Renamer(sd)

    def resblock(src, dst):
        for p in ("norm1", "conv1", "norm2", "conv2"):
            b.conv(f"{src}.{p}", f"{dst}/{p}")
        _shortcuts(b, src, dst)

    def attnblock(src, dst):
        for p in ("norm", "qkv", "proj_out"):
            b.conv(f"{src}.{p}", f"{dst}/{p}")

    b.linear("temb.dense.0", "temb_dense0")
    b.linear("temb.dense.1", "temb_dense1")
    b.linear("temb.dense.2", "temb_proj")
    b.conv("conv_in", "conv_in")
    _ddpm_walk(b, resblock, attnblock,
               lambda src, dst: b.conv(f"{src}.conv", f"{dst}/conv"),
               ch_mult, num_res_blocks, attn_resolutions, resolution)
    b.put("", "norm_out_scale", b.get("norm_out.weight"))
    b.put("", "norm_out_bias", b.get("norm_out.bias"))
    b.conv("conv_out", "conv_out")
    return b.out


def convert_ddpm_vanilla_unet(
    sd: Mapping,
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4),
    num_res_blocks: int = 2,
    attn_resolutions: Tuple[int, ...] = (16,),
    resolution: int = 256,
    fuse: bool = False,
) -> StateDict:
    """A *vanilla* UNet state dict (``church256-ddpm-unet.pth``;
    reference: diffusion/models/ddpm_arch/unet.py:140-238 — per-resblock
    ``temb_proj`` linears, separate q/k/v attention convs) -> the state
    dict of

      * ``fuse=False``: :class:`sige_torch.models.ddpm.VanillaDDPMUNet`, or
      * ``fuse=True``: :class:`sige_torch.models.ddpm.SIGEFusedUNet`, the
        per-block temb projections concatenated into one ``temb_proj``
        (traversal order down -> mid -> up) and q/k/v into ``qkv`` — the
        reference's ``FusedUNet.from_unet`` weight surgery (reference:
        fused_unet.py:306-355,125-138).
    """
    b = _Renamer(sd)
    temb_srcs = []  # per-resblock temb projections, fused in this order

    def resblock(src, dst):
        b.conv(f"{src}.norm1", f"{dst}/norm1")
        b.conv(f"{src}.conv1", f"{dst}/conv1")
        if fuse:
            temb_srcs.append(f"{src}.temb_proj")
        else:
            b.linear(f"{src}.temb_proj", f"{dst}/temb_proj")
        b.conv(f"{src}.norm2", f"{dst}/norm2")
        b.conv(f"{src}.conv2", f"{dst}/conv2")
        _shortcuts(b, src, dst)

    def attnblock(src, dst):
        b.conv(f"{src}.norm", f"{dst}/norm")
        if fuse:
            b.cat([f"{src}.{p}" for p in ("q", "k", "v")], f"{dst}/qkv")
        else:
            for p in ("q", "k", "v"):
                b.conv(f"{src}.{p}", f"{dst}/{p}")
        b.conv(f"{src}.proj_out", f"{dst}/proj_out")

    b.linear("temb.dense.0", "temb_dense0")
    b.linear("temb.dense.1", "temb_dense1")
    b.conv("conv_in", "conv_in")
    _ddpm_walk(b, resblock, attnblock,
               lambda src, dst: b.conv(f"{src}.conv", f"{dst}/conv"),
               ch_mult, num_res_blocks, attn_resolutions, resolution)
    if fuse:
        b.cat(temb_srcs, "temb_proj")
        b.put("", "norm_out_scale", b.get("norm_out.weight"))
        b.put("", "norm_out_bias", b.get("norm_out.bias"))
    else:
        b.norm("norm_out", "norm_out")
    b.conv("conv_out", "conv_out")
    return b.out


def convert_ddpm_unet_to_fused(sd, **kw) -> StateDict:
    """Vanilla UNet state dict -> :class:`SIGEFusedUNet`'s state dict
    (reference ``FusedUNet.from_unet``; fused_unet.py:306-355)."""
    return convert_ddpm_vanilla_unet(sd, fuse=True, **kw)


def assert_params_match(converted: Mapping[str, torch.Tensor],
                        target: Union[nn.Module, Mapping]) -> None:
    """Raise ``ValueError`` unless ``converted`` has exactly the keys and
    shapes of ``target`` (a module's state dict, or a state dict), naming
    the missing and extra keys and the shape mismatches."""
    if isinstance(target, nn.Module):
        target = target.state_dict()
    missing = sorted(set(target) - set(converted))
    extra = sorted(set(converted) - set(target))
    shapes = [f"{k}: {tuple(converted[k].shape)} vs {tuple(target[k].shape)}"
              for k in target if k in converted
              and tuple(converted[k].shape) != tuple(target[k].shape)]
    if missing or extra or shapes:
        raise ValueError(f"state dict mismatch: missing={missing[:8]} "
                         f"({len(missing)}) extra={extra[:8]} ({len(extra)}) "
                         f"shapes={shapes[:8]} ({len(shapes)})")


def load_converted(module: nn.Module, state: Mapping) -> nn.Module:
    """``module.load_state_dict(state, strict=True)`` after
    :func:`assert_params_match` (whose error names every kind of
    mismatch at once)."""
    assert_params_match(state, module)
    module.load_state_dict(state, strict=True)
    return module


def _spade_block_names(num_upsampling_layers: str):
    names = ["head_0", "G_middle_0", "G_middle_1",
             "up_0", "up_1", "up_2", "up_3"]
    shortcut = [False, False, False, True, True, True, True]
    if num_upsampling_layers == "most":
        names.append("up_4")
        shortcut.append(True)
    return names, shortcut


def is_unfused_spade(sd: Mapping) -> bool:
    """Whether a SPADE or sub-mobile SPADE checkpoint keeps per-norm
    ``mlp_shared`` convs (the unfused ``spade.pth`` /
    ``sub_mobile_spade-*.pth`` layout) rather than one per block."""
    return "head_0.norm_0.mlp_shared.0.weight" in sd


def convert_gaugan_fused_spade(
    sd: Mapping,
    num_upsampling_layers: str = "more",
) -> StateDict:
    """A reference FusedSPADE / SIGEFusedSPADE generator state dict
    (``fused_spade.pth``) -> the state dict of
    :class:`sige_torch.models.gaugan.SIGEFusedSPADEGenerator` (reference:
    gaugan/models/spade_generators/fused_spade_generator.py — the SIGE
    checkpoint format)."""
    b = _Renamer(sd)

    def norm(src, dst):
        b.stats(src, dst)
        b.conv(f"{src}.mlp_gamma_beta", f"{dst}/mlp_gamma_beta")

    b.conv("fc", "fc")
    for name, sc in zip(*_spade_block_names(num_upsampling_layers)):
        b.conv(f"{name}.mlp_shared.0", f"{name}/mlp_shared")
        b.conv(f"{name}.conv_0", f"{name}/conv_0")
        b.conv(f"{name}.conv_1", f"{name}/conv_1")
        norm(f"{name}.norm_0", f"{name}/norm_0")
        norm(f"{name}.norm_1", f"{name}/norm_1")
        if sc:
            b.conv(f"{name}.conv_s", f"{name}/conv_s")
            norm(f"{name}.norm_s", f"{name}/norm_s")
    b.conv("conv_img", "conv_img")
    return b.out


def convert_gaugan_spade(
    sd: Mapping,
    num_upsampling_layers: str = "more",
    fuse: bool = False,
) -> StateDict:
    """A *vanilla* SPADE generator state dict (``spade.pth``; reference:
    gaugan/models/spade_generators/spade_generator.py:66,
    normalization.py:92-131 — per-norm mlp_shared/mlp_gamma/mlp_beta) ->
    the state dict of

      * ``fuse=False``: :class:`VanillaSPADEGenerator`, or
      * ``fuse=True``: :class:`SIGEFusedSPADEGenerator`, the per-norm
        ``mlp_shared`` convs concatenated across branches and γ/β into
        ``mlp_gamma_beta`` — the reference's
        ``FusedSPADEResnetBlock.from_SPADEResnetBlock`` weight surgery
        (reference: fused_spade_generator.py:72-160).
    """
    b = _Renamer(sd)

    def norm(src, dst):
        b.stats(src, dst)
        if fuse:
            b.cat([f"{src}.mlp_gamma", f"{src}.mlp_beta"],
                  f"{dst}/mlp_gamma_beta")
        else:
            b.conv(f"{src}.mlp_shared.0", f"{dst}/mlp_shared")
            b.conv(f"{src}.mlp_gamma", f"{dst}/mlp_gamma")
            b.conv(f"{src}.mlp_beta", f"{dst}/mlp_beta")

    b.conv("fc", "fc")
    for name, sc in zip(*_spade_block_names(num_upsampling_layers)):
        branches = ["norm_0", "norm_1"] + (["norm_s"] if sc else [])
        if fuse:
            b.cat([f"{name}.{br}.mlp_shared.0" for br in branches],
                  f"{name}/mlp_shared")
        b.conv(f"{name}.conv_0", f"{name}/conv_0")
        b.conv(f"{name}.conv_1", f"{name}/conv_1")
        norm(f"{name}.norm_0", f"{name}/norm_0")
        norm(f"{name}.norm_1", f"{name}/norm_1")
        if sc:
            b.conv(f"{name}.conv_s", f"{name}/conv_s")
            norm(f"{name}.norm_s", f"{name}/norm_s")
    b.conv("conv_img", "conv_img")
    return b.out


def sub_mobile_block_dims(channels, ngf: int = 64):
    """Per-block (ic, channel, hidden, learned_shortcut) for a decoded
    sub-mobile ``config_str`` (reference:
    sub_mobile_spade_generator.py:64-120 channel threading)."""
    ch = list(channels)
    return {
        "head_0": (ch[0] * 16, ch[1] * 16, ch[1] * 2, False),
        "G_middle_0": (ch[0] * 16, ch[2] * 16, ch[2] * 2, False),
        "G_middle_1": (ch[0] * 16, ch[3] * 16, ch[3] * 2, False),
        "up_0": (ch[0] * 16, ch[4] * 8, ch[4] * 2, True),
        "up_1": (ch[4] * 8, ch[5] * 4, ch[5] * 2, True),
        "up_2": (ch[5] * 4, ch[6] * 2, ch[6] * 2, True),
        "up_3": (ch[6] * 2, ch[7], ch[7] * 2, True),
    }


def convert_gaugan_sub_mobile_spade(
    sd: Mapping,
    channels=(32, 32, 32, 48, 32, 24, 24, 32),
    ngf: int = 64,
    fused_ckpt: bool = True,
) -> StateDict:
    """A GAN-Compression sub-mobile SPADE state dict -> the state dict of
    :class:`SIGESubMobileSPADEGenerator`.

    ``fused_ckpt=True`` reads ``fused_sub_mobile_spade-*.pth`` (per-block
    ``mlp_shared``; reference: fused_sub_mobile_spade_generator.py:37);
    ``fused_ckpt=False`` reads the unfused ``sub_mobile_spade-*.pth`` and
    performs the mlp_shared concatenation surgery (reference:
    fused_sub_mobile_spade_generator.py:77-133).

    The checkpoints store ``param_free_norm`` running stats at the
    *nominal* (uncompressed) width; they are truncated to the compressed
    channel count exactly like the reference's ``load_network``
    (reference: gaugan/utils.py:20-33).
    """
    b = _Renamer(sd)

    def norm(src, dst, oc):
        b.stats(src, dst, oc)
        # SeparableConv2d = Sequential(dw conv, InstanceNorm(no params), pw)
        # (reference: gaugan/models/mobile_modules.py:28-63)
        for p in ("mlp_gamma", "mlp_beta"):
            b.conv(f"{src}.{p}.conv.0", f"{dst}/{p}/dw")
            b.conv(f"{src}.{p}.conv.2", f"{dst}/{p}/pw")

    b.conv("fc", "fc")
    for name, (ic, channel, _hidden, sc) in sub_mobile_block_dims(
            channels, ngf).items():
        branches = ["norm_0", "norm_1"] + (["norm_s"] if sc else [])
        if fused_ckpt:
            b.conv(f"{name}.mlp_shared.0", f"{name}/mlp_shared")
        else:
            b.cat([f"{name}.{br}.mlp_shared.0" for br in branches],
                  f"{name}/mlp_shared")
        b.conv(f"{name}.conv_0", f"{name}/conv_0")
        b.conv(f"{name}.conv_1", f"{name}/conv_1")
        norm(f"{name}.norm_0", f"{name}/norm_0", ic)
        norm(f"{name}.norm_1", f"{name}/norm_1", channel)
        if sc:
            b.conv(f"{name}.conv_s", f"{name}/conv_s")
            norm(f"{name}.norm_s", f"{name}/norm_s", ic)
    b.conv("conv_img", "conv_img")
    return b.out


def convert_pd_unet(
    sd: Mapping,
    ch_mult: Tuple[int, ...] = (1, 1, 2, 4, 6, 8),
    num_res_blocks: int = 3,
    attn_resolutions: Tuple[int, ...] = (8, 16, 32),
    resolution: int = 256,
) -> StateDict:
    """A reference PD UNet state dict (``church128-pd-unet.pth`` style;
    reference: diffusion/models/pd_arch/unet.py) -> the state dict of
    :class:`sige_torch.models.pd.SIGEPDUNet`; its resamples are
    resblocks."""
    b = _Renamer(sd)

    def resblock(src, dst):
        for p in ("norm1", "conv1", "temb_proj", "norm2", "conv2"):
            b.conv(f"{src}.{p}", f"{dst}/{p}")
        if b.has(f"{src}.nin_shortcut.weight"):
            b.conv(f"{src}.nin_shortcut", f"{dst}/nin_shortcut")

    def attnblock(src, dst):
        for p in ("norm", "qkv", "proj_out"):
            b.conv(f"{src}.{p}", f"{dst}/{p}")

    b.linear("temb.dense.0", "temb_dense0")
    b.linear("temb.dense.1", "temb_dense1")
    b.conv("conv_in", "conv_in")
    _ddpm_walk(b, resblock, attnblock, resblock,
               ch_mult, num_res_blocks, attn_resolutions, resolution)
    b.put("", "norm_out_scale", b.get("norm_out.weight"))
    b.put("", "norm_out_bias", b.get("norm_out.bias"))
    b.conv("conv_out", "conv_out")
    return b.out
