"""Stable Diffusion safety checker (CLIP-based NSFW screen) — the port of
``sige_tpu.models.sd.safety``.

The reference filters every saved sample through diffusers'
``StableDiffusionSafetyChecker`` and ``AutoFeatureExtractor`` loaded from
``CompVis/stable-diffusion-safety-checker`` (reference:
stable-diffusion/utils.py:16-19,94-100), and blacks out or replaces
flagged images before watermarking (reference:
stable-diffusion/runners/base_runner.py:87-93).

  * ``safety_head`` — the checker's decision: cosine similarity of the
    projected CLIP image embeddings against the "concept" and "special
    care" embeddings, per-concept thresholds, scores rounded to 3
    decimals, and the 0.01 special-care adjustment;
  * ``preprocess_images`` — the CLIP feature extractor's transform
    (shortest edge to 224 by bicubic, centre crop, CLIP mean/std);
  * :class:`CLIPVisionModel` — the CLIP vision trunk (patch conv without
    bias, class token, ``pre_layrnorm``, pre-LN blocks, ``post_layernorm``
    on the class token as ``pooler_output``), with the torch checkpoints'
    parameter names;
  * :class:`SafetyChecker` — the whole screen, from a local snapshot's
    ``pytorch_model.bin`` and ``config.json`` (nothing is downloaded).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.engine import fp32_scope, resolve_device
from .clip import (CLIPEncoder, CLIPOutput, _built, config_from_dict,
                   load_weights)

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """``transformers.CLIPVisionConfig``'s fields and defaults that the
    architecture reads."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: Mapping):
        return config_from_dict(cls, d, "vision_config")


#: the safety checker's trunk (CLIP ViT-L/14 at 224)
VIT_L14 = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                           num_hidden_layers=24, num_attention_heads=16,
                           patch_size=14)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d,
                                         cfg.patch_size, cfg.patch_size,
                                         bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d)

    def forward(self, pixel_values):
        """NCHW pixels -> [B, 1 + patches, hidden]: the class token, then
        the patches in row-major order, plus position embeddings."""
        p = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(p.shape[0], 1, -1)
        return torch.cat([cls, p], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps)   # (sic, as upstream)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(d, eps=eps)

    def forward(self, pixel_values) -> CLIPOutput:
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return CLIPOutput(x, self.post_layernorm(x[:, 0]))


class CLIPVisionModel(nn.Module):
    """NCHW ``pixel_values`` -> :class:`CLIPOutput` (``pooler_output``
    [B, hidden]); state-dict keys ``vision_model.*`` as in torch
    checkpoints."""

    def __init__(self, cfg: CLIPVisionConfig = VIT_L14):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)

    def forward(self, pixel_values) -> CLIPOutput:
        return self.vision_model(pixel_values)


def cosine_similarity(image_embeds: torch.Tensor,
                      concept_embeds: torch.Tensor) -> torch.Tensor:
    """[B, D] x [C, D] -> [B, C] cosine similarity (diffusers calls this
    ``cosine_distance`` but computes similarity)."""
    a = image_embeds / torch.linalg.norm(image_embeds, dim=-1, keepdim=True)
    b = concept_embeds / torch.linalg.norm(concept_embeds, dim=-1,
                                           keepdim=True)
    return a @ b.T


def safety_head(image_embeds: torch.Tensor, concept_embeds: torch.Tensor,
                concept_thresholds: torch.Tensor,
                special_embeds: torch.Tensor,
                special_thresholds: torch.Tensor) -> np.ndarray:
    """A [B] bool array: True where the image trips any concept.

    The torch checker's forward: special-care scores are thresholded
    first; where any special concept fires for an image, every concept
    threshold of that image is lowered by 0.01 (its ``adjustment``).
    Scores are rounded to 3 decimals before the comparison, as upstream
    does."""
    special_scores = torch.round(
        cosine_similarity(image_embeds, special_embeds)
        - special_thresholds[None, :], decimals=3)
    special_care = (special_scores > 0).any(dim=1)
    adjustment = torch.where(special_care, 0.01, 0.0)[:, None].to(
        image_embeds.dtype)
    concept_scores = torch.round(
        cosine_similarity(image_embeds, concept_embeds)
        - concept_thresholds[None, :] + adjustment, decimals=3)
    return (concept_scores > 0).any(dim=1).cpu().numpy()


def preprocess_images(images, size: int = 224, device=None) -> torch.Tensor:
    """[B, H, W, 3] floats in [0, 1] -> CLIP pixel values [B, size, size,
    3] on ``device`` (default: the GPU).

    Shortest edge to ``size`` by bicubic interpolation (Keys' cubic, a =
    -0.5, antialiased when it shrinks, in float32: ``sige_tpu``'s
    ``jax.image.resize(..., "bicubic")``), centre crop, CLIP normalise,
    as the CLIP feature extractor the reference's checker runs (a direct
    aspect-distorting resize would flip decisions for non-square
    outputs, e.g. ``--H 512 --W 768``)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(images, np.float32), device=device)
    B, H, W, _ = x.shape
    if H != size or W != size:
        if H <= W:
            nh, nw = size, max(int(round(W * size / H)), size)
        else:
            nh, nw = max(int(round(H * size / W)), size), size
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw),
                          mode="bicubic", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
        r0, c0 = (nh - size) // 2, (nw - size) // 2
        x = x[:, r0:r0 + size, c0:c0 + size, :]
    mean, std = (torch.as_tensor(a, device=device)
                 for a in (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD))
    return (x - mean) / std


def convert_safety_head(torch_state_dict) -> dict:
    """The head of a torch ``StableDiffusionSafetyChecker`` state dict as
    numpy: the ``concept_embeds`` / ``special_care_embeds`` buffers, their
    ``*_weights`` thresholds, and ``visual_projection`` (no bias)
    transposed to [D, P]."""
    def get(k):
        v = torch_state_dict[k]
        return np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v, np.float32)

    return {
        "concept_embeds": get("concept_embeds"),
        "concept_thresholds": get("concept_embeds_weights"),
        "special_embeds": get("special_care_embeds"),
        "special_thresholds": get("special_care_embeds_weights"),
        "visual_projection": get("visual_projection.weight").T,  # [D, P]
    }


def load_vision_model(model_path: str, dtype=torch.float32
                      ) -> CLIPVisionModel:
    """The CLIP vision trunk of a local safety-checker snapshot: its
    ``config.json``'s ``vision_config`` and the ``vision_model.*`` weights
    of its ``pytorch_model.bin`` (the checker nests a ``CLIPVisionModel``,
    so they are ``vision_model.vision_model.*`` there; a bare
    ``CLIPVisionModel`` file's ``vision_model.*`` load as well)."""
    with open(os.path.join(model_path, "config.json"),
              encoding="utf-8") as f:
        cfg = CLIPVisionConfig.from_dict(json.load(f))
    sd = load_weights(model_path, "vision_model.")
    nested = "vision_model.vision_model."
    if any(k.startswith(nested) for k in sd):
        sd = {k[len("vision_model."):]: v for k, v in sd.items()
              if k.startswith(nested)}
    return _built(CLIPVisionModel(cfg), sd, dtype)


class SafetyChecker:
    """The whole screen. ``vision_fn`` maps preprocessed pixel values
    [B, 224, 224, 3] -> pooled CLIP features [B, D]; injectable for tests,
    else the CLIP vision trunk of the snapshot at ``model_path`` on
    ``device`` (default: the GPU), run in fp32 with TF32 off."""

    def __init__(self, head_params: Mapping, vision_fn=None,
                 model_path: Optional[str] = None, device=None,
                 dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.head = {k: torch.as_tensor(np.asarray(v), device=self.device,
                                        dtype=dtype)
                     for k, v in head_params.items()}
        if vision_fn is None:
            if model_path is None:
                raise FileNotFoundError(
                    "safety checker weights required: pass a local "
                    "CompVis/stable-diffusion-safety-checker snapshot path "
                    "(nothing is downloaded)")
            self.vision = load_vision_model(model_path, dtype).to(
                self.device)
            vision_fn = self._pooled
        self.vision_fn = vision_fn

    def _pooled(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = pixel_values.permute(0, 3, 1, 2).to(self.dtype)
        return self.vision(x).pooler_output

    @classmethod
    def from_pretrained(cls, model_path: str, device=None,
                        dtype=torch.float32) -> "SafetyChecker":
        """From a local ``CompVis/stable-diffusion-safety-checker``
        snapshot (``pytorch_model.bin`` + ``config.json``)."""
        sd = torch.load(os.path.join(model_path, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
        return cls(convert_safety_head(sd), model_path=model_path,
                   device=device, dtype=dtype)

    def image_embeds(self, images) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> the projected embeddings [B, P]."""
        with torch.inference_mode(), fp32_scope():
            pixel_values = preprocess_images(images, device=self.device)
            pooled = torch.as_tensor(self.vision_fn(pixel_values),
                                     device=self.device, dtype=self.dtype)
            return pooled @ self.head["visual_projection"]

    def __call__(self, images) -> Tuple[np.ndarray, List[bool]]:
        """images: [B, H, W, 3] floats in [0, 1]. Returns (checked,
        has_nsfw): flagged images are zeroed (the reference substitutes a
        replacement asset when it has one, else keeps the image with a
        warning; this blacks out, the diffusers default)."""
        nsfw = safety_head(
            self.image_embeds(images), self.head["concept_embeds"],
            self.head["concept_thresholds"], self.head["special_embeds"],
            self.head["special_thresholds"])
        checked = np.asarray(images).copy()
        checked[nsfw] = 0.0
        return checked, [bool(b) for b in nsfw]
