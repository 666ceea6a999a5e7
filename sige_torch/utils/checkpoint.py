"""Native checkpoints of converted weights — the port of
``sige_tpu.utils.checkpoint``.

The reference only ever ``torch.load``s .pth files (SURVEY section 5:
checkpoint/resume is load-only). The converters (:mod:`.convert`,
:mod:`.convert_sd`) run once, and ``--save_converted`` stores their
result in the port's native format: a directory holding one
``torch.save``d file per entry (``model.pt`` for a single state dict;
``unet.pt``, ``encoder.pt``, ... for a mapping of them) and an
``index.json`` that names them. It is read with ``weights_only=True``
(tensors, dicts and tuples only) straight onto the caller's device.

``sige_tpu``'s native format is an orbax directory of JAX arrays, which
this package cannot read: :func:`load_params` refuses it with an error
that says so (convert the reference ``.pth`` instead).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Mapping, Optional

import torch

from .convert import load_torch_state_dict

INDEX = "index.json"
FORMAT = "sige_torch.params/1"
#: files orbax writes into a checkpoint directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                  "_sharding", "checkpoint")


def _is_state_dict(params: Mapping) -> bool:
    return all(isinstance(v, torch.Tensor) for v in params.values())


def save_params(path: str, params: Mapping) -> str:
    """Write ``params`` (a state dict, or a mapping of named entries such
    as ``SDRunner``'s ``{"unet", "encoder", "decoder", "post_quant"}``)
    to the directory ``path``; returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    entries = ({"model": params} if _is_state_dict(params)
               else {k: v for k, v in params.items() if v is not None})
    files = {}
    for name, value in entries.items():
        files[name] = f"{name}.pt"
        torch.save(value, os.path.join(path, files[name]))
    with open(os.path.join(path, INDEX), "w") as f:
        json.dump({"format": FORMAT, "files": files,
                   "single": _is_state_dict(params)}, f)
    return path


def load_params(path: str, device=None) -> Any:
    """Read what :func:`save_params` wrote, onto ``device`` (default: the
    CPU)."""
    path = os.path.abspath(path)
    index = os.path.join(path, INDEX)
    if not os.path.exists(index):
        found = [m for m in _ORBAX_MARKERS
                 if os.path.exists(os.path.join(path, m))]
        if found:
            raise ValueError(
                f"{path} is a sige_tpu (orbax) checkpoint ({', '.join(found)}"
                "), not a sige_torch one: convert the reference .pth with "
                "--restore_from and write a native copy with "
                "--save_converted")
        raise ValueError(f"{path} holds no {INDEX}: not a sige_torch "
                         "checkpoint directory")
    with open(index) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{index}: format {meta.get('format')!r}, this "
                         f"package reads {FORMAT!r}")
    location = torch.device("cpu" if device is None else device)
    out = {name: torch.load(os.path.join(path, fname),
                            map_location=location, weights_only=True)
           for name, fname in meta["files"].items()}
    return out["model"] if meta["single"] else out


def maybe_load_native(path: Optional[str], device=None) -> Any:
    """Load ``path`` if it is a checkpoint directory, else None."""
    if path and os.path.isdir(path):
        return load_params(path, device)
    return None


def restore(path: str, convert: Callable[[Mapping], Any], device=None) -> Any:
    """The weights a command line's ``--restore_from`` names: a directory
    written by ``--save_converted`` as it is (onto ``device``), else
    ``convert`` of the reference .pth (read on the CPU by
    :func:`~sige_torch.utils.convert.load_torch_state_dict`)."""
    params = maybe_load_native(path, device)
    if params is None:
        params = convert(load_torch_state_dict(path))
    return params
