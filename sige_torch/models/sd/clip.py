"""Frozen CLIP text encoder for Stable Diffusion conditioning — the port of
``sige_tpu.models.sd.clip``.

The reference wraps ``transformers``' torch ``CLIPTextModel``
(reference: stable-diffusion/ldm/modules/encoders/modules.py
FrozenCLIPEmbedder); ``sige_tpu`` runs its Flax twin. The port has a
module of its own with ``FlaxCLIPTextModel``'s architecture and the
torch checkpoints' parameter names (``text_model.*``), and its own
tokenizer (:mod:`.tokenizer`): the machine with the card has no
``transformers``.

  * token and position embeddings; pre-LN blocks (LayerNorm eps 1e-5),
    causal self-attention, ``quick_gelu`` MLP; ``final_layer_norm`` ->
    ``last_hidden_state``;
  * the attention is a matmul and a softmax: the flash kernel takes a
    per-key bias only, not the causal mask, and ``sige_tpu`` runs no
    kernel of its own here either.

Weight sources (nothing is downloaded):
  * a local ``openai/clip-vit-large-patch14`` snapshot (``model_path``: a
    directory, or a hub id looked up in the local hub cache as
    ``from_pretrained(local_files_only=True)`` does), its
    ``pytorch_model.bin`` (``text_model.*``) and ``config.json``;
  * the ``cond_stage_model.transformer.*`` weights inside an sd-v1
    checkpoint (``sd_state_dict``) — then only the tokenizer files need a
    snapshot.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ...nn.engine import fp32_scope, resolve_device
from .tokenizer import CLIPTokenizer

DEFAULT_MODEL = "openai/clip-vit-large-patch14"


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """``transformers.CLIPTextConfig``'s fields and defaults that the
    architecture reads."""

    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: Mapping):
        return config_from_dict(cls, d, "text_config")


def config_from_dict(cls, d: Mapping, sub: str):
    """A config dataclass from a ``config.json``: a ``CLIPConfig``'s
    ``sub`` part (``text_config`` or ``vision_config``) or the model's own
    config; unknown keys ignored, missing ones at their defaults."""
    d = d.get(sub) or d.get(f"{sub}_dict") or d
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


#: the text encoder of SD v1 (clip-vit-large-patch14's text tower)
SD_V1_TEXT = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                            num_hidden_layers=12, num_attention_heads=12)



@dataclasses.dataclass
class CLIPOutput:
    """What the CLIP models return, by ``transformers``' names."""

    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None


class CLIPAttention(nn.Module):
    """Multi-head self-attention, ``transformers``' eager form: the
    queries scaled by ``head_dim ** -0.5``, an additive mask of the dtype's
    lowest value, a softmax."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, hidden // heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(hidden, hidden))

    def forward(self, x, causal: bool):
        B, N, D = x.shape

        def split(t):
            return t.reshape(B, N, self.heads, self.head_dim).transpose(1, 2)

        q = split(self.q_proj(x) * self.head_dim ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        scores = q @ k.transpose(-1, -2)
        if causal:
            future = torch.ones(N, N, dtype=torch.bool,
                                device=x.device).triu(1)
            scores = scores.masked_fill(future, torch.finfo(x.dtype).min)
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


class CLIPMLP(nn.Module):
    """fc1 -> ``quick_gelu`` (x * sigmoid(1.702 x)) -> fc2, the activation
    of the CLIP towers SD v1 and its safety checker use."""

    def __init__(self, hidden: int, intermediate: int, act: str):
        super().__init__()
        if act != "quick_gelu":
            raise ValueError(f"hidden_act {act!r}: only quick_gelu is "
                             f"supported")
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = CLIPAttention(d, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(d, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, causal: bool = False):
        for layer in self.layers:
            x = layer(x, causal)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, input_ids):
        n = input_ids.shape[1]
        return self.token_embedding(input_ids) + \
            self.position_embedding.weight[:n]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        x = self.encoder(self.embeddings(input_ids), causal=True)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """``input_ids`` [B, N] -> :class:`CLIPOutput` with
    ``last_hidden_state`` [B, N, hidden]. The state dict's keys are the
    torch checkpoints' (``text_model.embeddings.token_embedding.weight``,
    ...)."""

    def __init__(self, cfg: CLIPTextConfig = SD_V1_TEXT):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids) -> CLIPOutput:
        return CLIPOutput(self.text_model(input_ids))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32
                        ) -> "CLIPTextModel":
        """From a snapshot directory's ``config.json`` and
        ``pytorch_model.bin`` (its ``text_model.*`` keys)."""
        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            cfg = CLIPTextConfig.from_dict(json.load(f))
        sd = load_weights(path, "text_model.")
        return _built(cls(cfg), sd, dtype)


def load_weights(path: str, prefix: str) -> dict:
    """The ``prefix``-ed tensors of a snapshot's ``pytorch_model.bin``
    (read with ``weights_only``), ``position_ids`` buffers dropped."""
    sd = torch.load(os.path.join(path, "pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("position_ids")}


def _built(model: nn.Module, state_dict: Mapping, dtype) -> nn.Module:
    model.load_state_dict(state_dict, strict=True)
    return model.to(dtype).eval().requires_grad_(False)


def _hub_roots() -> List[str]:
    """The hub caches to search, in ``huggingface_hub``'s order of
    precedence: ``HF_HUB_CACHE``, ``$HF_HOME/hub``, then the default."""
    roots = []
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        roots.append(os.path.join(os.environ["HF_HOME"], "hub"))
    roots.append(os.path.join(os.path.expanduser("~"), ".cache",
                              "huggingface", "hub"))
    return roots


def resolve_snapshot(model_path: str) -> str:
    """The directory of a local snapshot, as
    ``from_pretrained(local_files_only=True)`` finds it: ``model_path``
    itself when it is a directory, else the hub id's snapshot in the
    first hub cache that holds one (the one ``refs/main`` names, else the
    newest). Raises ``FileNotFoundError`` when there is none: nothing is
    downloaded."""
    if os.path.isdir(model_path):
        return model_path
    repo = "models--" + model_path.replace("/", "--")
    for root in _hub_roots():
        base = os.path.join(root, repo)
        ref = os.path.join(base, "refs", "main")
        if os.path.isfile(ref):
            with open(ref, encoding="utf-8") as f:
                snap = os.path.join(base, "snapshots", f.read().strip())
            if os.path.isdir(snap):
                return snap
        snaps = [d for d in glob.glob(os.path.join(base, "snapshots", "*"))
                 if os.path.isdir(d)]
        if snaps:
            return max(snaps, key=os.path.getmtime)
    raise FileNotFoundError(
        f"no local snapshot of {model_path!r}: pass a snapshot directory or "
        f"put it in a hub cache ({', '.join(_hub_roots())}); nothing is "
        f"downloaded")


def _model_from_sd_state_dict(sd_state_dict: Mapping, dtype=torch.float32,
                              cfg: CLIPTextConfig = SD_V1_TEXT
                              ) -> CLIPTextModel:
    """The CLIP text encoder embedded in an LDM checkpoint (keys
    ``cond_stage_model.transformer.text_model.*``, or the older
    ``cond_stage_model.transformer.*`` without ``text_model.``; reference:
    stable-diffusion/utils.py:22-39), at SD v1's text widths unless
    ``cfg`` says otherwise."""
    prefix = "cond_stage_model.transformer."
    sd = {}
    for k, v in sd_state_dict.items():
        if not k.startswith(prefix) or k.endswith("position_ids"):
            continue
        k = k[len(prefix):]
        if not k.startswith("text_model."):
            k = "text_model." + k
        sd[k] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
    if not sd:
        raise ValueError("no cond_stage_model.transformer.* keys found")
    return _built(CLIPTextModel(cfg), sd, dtype)


class FrozenCLIPEmbedder:
    """text -> [B, 77, hidden] embeddings on ``device`` (reference
    semantics: padded to max_length 77, ``last_hidden_state``).

    ``tokenizer`` / ``model`` are injectable (``transformers``' call
    conventions: ``tokenizer(text, truncation=True, max_length=...,
    padding="max_length", return_tensors="np")["input_ids"]`` and
    ``model(input_ids=...).last_hidden_state``); by default they load
    from ``model_path`` (and ``sd_state_dict`` for the model).
    ``device=None`` means the GPU; the forward runs in fp32 (or
    ``dtype``) with TF32 off."""

    def __init__(self, model_path: str = DEFAULT_MODEL, max_length: int = 77,
                 sd_state_dict=None, tokenizer=None, model=None,
                 dtype=torch.float32, device=None):
        self.max_length = max_length
        self.device = resolve_device(device)
        self.tokenizer, self.model = tokenizer, model
        if tokenizer is None or (model is None and sd_state_dict is None):
            path = resolve_snapshot(model_path)
        if self.tokenizer is None:
            self.tokenizer = CLIPTokenizer.from_pretrained(path)
        if self.model is None:
            self.model = (_model_from_sd_state_dict(sd_state_dict, dtype)
                          if sd_state_dict is not None
                          else CLIPTextModel.from_pretrained(path, dtype))
        if isinstance(self.model, nn.Module):
            self.model = self.model.to(self.device)

    def __call__(self, text: Union[str, List[str]]) -> torch.Tensor:
        if isinstance(text, str):
            text = [text]
        batch = self.tokenizer(text, truncation=True,
                               max_length=self.max_length,
                               padding="max_length", return_tensors="np")
        ids = np.asarray(batch["input_ids"])
        if ids.shape[1] != self.max_length:  # stub tokenizers may underpad
            ids = np.pad(ids, ((0, 0), (0, self.max_length - ids.shape[1])))
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        with torch.inference_mode(), fp32_scope():
            out = self.model(input_ids=ids).last_hidden_state
        return torch.as_tensor(out, device=self.device)


def encode_prompts(prompts: List[str], model_path: str = DEFAULT_MODEL,
                   sd_state_dict=None,
                   embedder: Optional[FrozenCLIPEmbedder] = None,
                   device=None) -> torch.Tensor:
    """Encode a list of prompts; returns [len(prompts), 77, hidden]. The
    CLI uses ``encode_prompts(["", prompt])`` for the (uc, c) guidance
    pair (reference: stable-diffusion/run.py prompt handling)."""
    if embedder is None:
        embedder = FrozenCLIPEmbedder(model_path=model_path,
                                      sd_state_dict=sd_state_dict,
                                      device=device)
    return embedder(prompts)
