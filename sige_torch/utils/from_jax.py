"""Weight bridge: ``sige_tpu``'s flax parameter tree -> the port's
``state_dict``.

It takes the tree as nested dicts of **numpy arrays** (the caller does the
``jax.device_get``) and imports nothing of JAX. Names map segment by
segment: flax's list-module names ``down_blocks_0_1`` become torch's
``down_blocks.0.1`` (and GauGAN's ``head_0`` / ``conv_0`` become
``head.0`` / ``conv.0``); leaves map as

  * conv ``kernel`` HWIO -> ``weight`` OIHW (``F.conv2d``'s layout); a
    depthwise kernel (HWIO with I = 1) becomes ``[C, 1, kh, kw]``, the
    weight of a conv with ``groups = C``;
  * ``Dense`` ``kernel`` [in, out] -> ``Linear`` ``weight`` [out, in];
  * ``Embed`` ``embedding`` [num, dim] -> ``nn.Embedding`` ``weight``
    (the CLIP towers' token and position embeddings);
  * norm ``scale`` (GroupNorm and the SD transformers' LayerNorm) ->
    ``weight``; ``bias`` -> ``bias``; a conv or ``Dense`` without bias
    (the SD attention projections, GauGAN's shortcut convs) has no
    ``bias`` on either side;
  * BatchNorm ``running_mean`` / ``running_var``, which the flax GauGAN
    modules keep in ``params``, keep their names (buffers on the torch
    side, loaded by the same ``load_state_dict``);
  * top-level parameters (``norm_out_scale`` / ``out_norm_scale`` and
    their biases) keep their names.

It serves every model of the port: the DDPM U-Net, the PD U-Net (whose
per-block ``temb_proj`` and top-level ``temb_dense0/1`` are Dense
layers), the SD U-Net, encoder and decoder, the GauGAN generators
(fused, sub-mobile and vanilla), and ``transformers``' Flax CLIP text and
vision models (``FlaxCLIPTextModel`` / ``FlaxCLIPVisionModel`` trees:
``text_model.*`` / ``vision_model.*``, the layer lists keyed ``"0"``,
``"1"``, ..., the vision ``class_embedding`` a bare leaf), whose names
are the port's CLIP modules' and the torch checkpoints'.

The metric backbones keep their reference checkpoints' names in the port
(torchvision's ``features.<i>`` and ``<block>.conv`` / ``<block>.bn``,
the DRN's ``base.<i>`` children), which segment-wise renaming cannot
reach: :func:`alexnet_state_from_flax`, :func:`inception_state_from_flax`
and :func:`drn_state_from_flax` map those trees, and
:func:`lpips_state_from_lins` writes LPIPS's per-layer channel weights in
the lpips ``alex.pth`` layout.

A full pass's state carries over too: :func:`caches_from_flax` takes
``sige_tpu``'s ``"cache"`` collection (leaves ``[slots, ...]``) to the
port's caches (``EngineState.caches``: by module path, one dict per
slot), and :func:`meta_from_flax` its ``"meta"`` collection to the port's
planning metadata (by Gather path), the two that
``SIGEModel.adopt_full`` installs.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

_LIST_NAME = re.compile(r"^(.*?)((?:_\d+)+)$")


def torch_path(flax_path: Sequence[str]) -> Tuple[str, ...]:
    """Module path segments of the port for a flax module path:
    ``("down_blocks_0_1", "main_gather")`` -> ``("down_blocks", "0", "1",
    "main_gather")``."""
    out = []
    for seg in flax_path:
        m = _LIST_NAME.match(seg)
        if m:
            out.append(m.group(1))
            out.extend(m.group(2)[1:].split("_"))
        else:
            out.append(seg)
    return tuple(out)


def _leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:    # HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:    # [in, out] -> [out, in]
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    return name, value


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for a ``sige_tpu`` parameter tree of numpy
    arrays (nested dicts keyed like flax's ``params`` collection)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: Tuple[str, ...]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.asarray(v)
            if path:
                name, a = _leaf(k, a)
            else:
                name = k
            key = ".".join(torch_path(path) + (name,))
            out[key] = torch.from_numpy(np.array(a, np.float32))

    walk(params, ())
    return out


def _flat(params: Mapping, path: Tuple[str, ...] = ()):
    for k, v in params.items():
        if isinstance(v, Mapping):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _renamed(params: Mapping, module_key) -> Dict[str, torch.Tensor]:
    """{``module_key(flax module path, leaf)`` + torch leaf: tensor}."""
    out = {}
    for path, a in _flat(params):
        name, a = _leaf(path[-1], a)
        prefix, name = module_key(path[:-1], name)
        out[f"{prefix}.{name}"] = torch.from_numpy(np.array(a, np.float32))
    return out


def alexnet_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``sige_tpu``'s ``AlexNetFeatures`` tree (``conv0`` .. ``conv4``) ->
    the port's state dict (torchvision's ``features.{0,3,6,8,10}``)."""
    idx = (0, 3, 6, 8, 10)
    return _renamed(params, lambda mod, name: (
        f"features.{idx[int(mod[0][4:])]}", name))


def inception_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``sige_tpu``'s ``InceptionV3Features`` tree -> the port's state
    dict: a BasicConv2d's ``conv/kernel`` stays ``conv.weight``, its
    BatchNorm leaves (``scale``, ``bias``, ``running_*``) go under
    ``bn``."""
    def key(mod, name):
        if mod[-1] == "conv":
            return ".".join(mod), name
        return ".".join(mod) + ".bn", name
    return _renamed(params, key)


def drn_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``sige_tpu``'s ``DRNSeg`` tree -> the port's state dict: ``seg``
    stays; in ``base``, ``layer0_conv`` / ``layer0_bn`` are children 0 / 1
    of ``base.0``, the plain layers ``layer{1,2,7,8}_<i>``'s ``conv`` /
    ``bn`` children ``3i`` / ``3i + 1`` of ``base.<l>``, and the
    bottlenecks ``layer{3..6}_<i>`` are ``base.<l>.<i>``, their
    ``downsample_conv`` / ``downsample_bn`` ``downsample.0`` / ``.1``."""
    def key(mod, name):
        if mod[0] == "seg":
            return "seg", name
        layer, rest = mod[1], mod[2:]
        if layer in ("layer0_conv", "layer0_bn"):
            return f"base.0.{0 if layer.endswith('conv') else 1}", name
        l, i = (int(n) for n in layer[len("layer"):].split("_"))
        if l in (1, 2, 7, 8):
            return f"base.{l}.{3 * i + (rest[0] == 'bn')}", name
        sub = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(rest[0], rest[0])
        return f"base.{l}.{i}.{sub}", name
    return _renamed(params, key)


def lpips_state_from_lins(lins: Sequence[np.ndarray]) -> Dict[str, torch.Tensor]:
    """Per-layer LPIPS channel weights [C] (``sige_tpu``'s
    ``LPIPSAlex.lins``) -> the lpips ``alex.pth`` layout
    (``lin<i>.model.1.weight``, [1, C, 1, 1])."""
    return {f"lin{i}.model.1.weight": torch.from_numpy(
                np.array(w, np.float32).reshape(1, -1, 1, 1))
            for i, w in enumerate(lins)}


def _walk_flax(tree: Mapping, path: Tuple[str, ...] = ()):
    """(module path, {leaf name: value}) of every module of a flax
    collection that holds leaves."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk_flax(v, path + (k,))


def caches_from_flax(cache: Mapping) -> Dict[str, list]:
    """The port's caches for a ``sige_tpu`` ``"cache"`` collection (nested
    dicts of numpy arrays, each ``[slots, ...]``): ``{module path: [one
    dict per slot of {name: tensor}]}``, as ``EngineState.caches`` holds
    them and ``SIGEModel.adopt_full`` takes them."""
    out: Dict[str, list] = {}
    for path, leaves in _walk_flax(cache):
        arrays = {k: np.asarray(v) for k, v in leaves.items()}
        slots = {a.shape[0] for a in arrays.values()}
        if len(slots) != 1:
            raise ValueError(f"{'/'.join(path)}: cache leaves with slot "
                             f"counts {sorted(slots)}")
        out[".".join(torch_path(path))] = [
            {k: torch.from_numpy(np.array(a[s])) for k, a in arrays.items()}
            for s in range(slots.pop())]
    return out


def meta_from_flax(meta: Mapping) -> Dict:
    """The port's planning metadata for a ``sige_tpu`` ``"meta"``
    collection (each Gather's sown tuples of int arrays): the same entries
    nested under the port's module path segments, as ``SIGEModel.meta``
    holds them."""
    out: Dict = {}
    for path, leaves in _walk_flax(meta):
        node = out
        for seg in torch_path(path):
            node = node.setdefault(seg, {})
        node.update({k: tuple(np.asarray(a) for a in v)
                     for k, v in leaves.items()})
    return out
