"""Pretrained-checkpoint registry: names, md5 checksums, and mirrors —
the port of ``sige_tpu.utils.registry``.

Metadata matches the reference's download helpers
(reference: diffusion/download_helper.py:8-20,
gaugan/download_helper.py:8-22, stable-diffusion README sd-v1-4), and
each spec names the port's converter. :func:`fetch` resolves and verifies
local files; it downloads only where ``SIGE_TPU_ALLOW_DOWNLOAD=1`` (the
setting ``sige_tpu`` reads too).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from .convert import md5_file


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    name: str
    md5: Optional[str]  # None: upstream publishes no checksum (skip verify)
    url: str
    converter: str  # dotted path of the port's state-dict converter


_BASE_DIFFUSION = "https://www.cs.cmu.edu/~sige/resources/models/diffusion"
_BASE_GAUGAN = "https://www.cs.cmu.edu/~sige/resources/models/gaugan"

REGISTRY: Dict[str, CheckpointSpec] = {
    spec.name: spec
    for spec in [
        CheckpointSpec(
            "church256-ddpm-fused_unet.pth",
            "fb3e26e5e6be812d6bed5c48e5265506",
            f"{_BASE_DIFFUSION}/church256-ddpm-fused_unet.pth",
            "sige_torch.utils.convert.convert_ddpm_fused_unet",
        ),
        CheckpointSpec(
            "church256-ddpm-unet.pth",
            "8fbd43a27e98e64b56453faca9be619e",
            f"{_BASE_DIFFUSION}/church256-ddpm-unet.pth",
            "sige_torch.utils.convert.convert_ddpm_vanilla_unet",
        ),
        CheckpointSpec(
            "church128-pd-unet.pth",
            "8a2690eb25d1e2b5367e9574d7b73822",
            f"{_BASE_DIFFUSION}/church128-pd-unet.pth",
            "sige_torch.utils.convert.convert_pd_unet",
        ),
        CheckpointSpec(
            "spade.pth",
            "21b8b5b29295b7208ba5cb48d818a367",
            f"{_BASE_GAUGAN}/spade.pth",
            "sige_torch.utils.convert.convert_gaugan_spade",
        ),
        CheckpointSpec(
            "fused_spade.pth",
            "216677f8fe9e0c6564e3f17cbe55c695",
            f"{_BASE_GAUGAN}/fused_spade.pth",
            "sige_torch.utils.convert.convert_gaugan_fused_spade",
        ),
        CheckpointSpec(
            "sub_mobile_spade-32_32_32_48_32_24_24_32.pth",
            "2f8373ff0433badbea664da90709ca3c",
            f"{_BASE_GAUGAN}/sub_mobile_spade-32_32_32_48_32_24_24_32.pth",
            "sige_torch.utils.convert.convert_gaugan_sub_mobile_spade",
        ),
        CheckpointSpec(
            "fused_sub_mobile_spade-32_32_32_48_32_24_24_32.pth",
            "530ff557d614df1378d0613f7a0865dc",
            f"{_BASE_GAUGAN}/fused_sub_mobile_spade-32_32_32_48_32_24_24_32.pth",
            "sige_torch.utils.convert.convert_gaugan_sub_mobile_spade",
        ),
        CheckpointSpec(
            # the reference points at HuggingFace and publishes no md5
            # (reference: stable-diffusion/README.md:25-29)
            "sd-v1-4.ckpt",
            None,
            "https://huggingface.co/CompVis/stable-diffusion-v-1-4-original"
            "/resolve/main/sd-v1-4.ckpt",
            "sige_torch.utils.convert_sd.convert_sd",
        ),
    ]
}


def _download_url(url: str, path: str, resume: bool = True,
                  chunk: int = 1 << 20) -> None:
    """Stream ``url`` to ``path`` with byte-range resume.

    A partial file is kept at ``path + ".part"`` and continued with an
    HTTP Range request when ``resume`` (http/https only; other schemes —
    e.g. the file:// mirrors the tests use — restart from zero).
    """
    import urllib.error
    import urllib.request

    part = path + ".part"
    start = 0
    req_headers = {}
    if resume and os.path.exists(part) and url.startswith(("http://",
                                                           "https://")):
        start = os.path.getsize(part)
        req_headers["Range"] = f"bytes={start}-"
    req = urllib.request.Request(url, headers=req_headers)
    try:
        resp = urllib.request.urlopen(req)
    except urllib.error.HTTPError as e:  # pragma: no cover - server-dependent
        if e.code == 416 and start > 0:  # range past EOF: restart clean
            os.remove(part)
            return _download_url(url, path, resume=False, chunk=chunk)
        raise
    mode = "ab" if start and resp.status == 206 else "wb"
    with resp, open(part, mode) as f:
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            f.write(buf)
    os.replace(part, path)


def download(name: str, root: str = "pretrained", tries: int = 3,
             url: str | None = None) -> str:
    """Download a registered checkpoint with md5-verified retry
    (reference: diffusion/download_helper.py:28-47 — download, check md5,
    delete and re-download on mismatch up to ``tries`` times).

    Gated behind ``SIGE_TPU_ALLOW_DOWNLOAD=1``; ``url`` overrides the
    registry mirror (the tests point it at a local ``file://`` mirror).
    """
    if os.environ.get("SIGE_TPU_ALLOW_DOWNLOAD") != "1":
        raise RuntimeError(
            "network downloads are disabled; set SIGE_TPU_ALLOW_DOWNLOAD=1 "
            "or place the checkpoint locally")
    spec = REGISTRY[name]
    src = url or spec.url
    path = os.path.join(root, name)
    os.makedirs(root, exist_ok=True)
    last = None
    for _ in range(tries):
        _download_url(src, path)
        if spec.md5 is None:
            # upstream publishes no checksum (e.g. sd-v1-4.ckpt lives on
            # HuggingFace, not the SIGE site) — surface the skip loudly
            print(f"WARNING: no registered md5 for {name}; download from "
                  f"{src} was NOT integrity-checked")
            return path
        got = md5_file(path)
        if got == spec.md5:
            return path
        last = got
        os.remove(path)
    raise ValueError(
        f"md5 mismatch for {name} after {tries} downloads from {src}: "
        f"{last} != {spec.md5}")


def fetch(name: str, root: str = "pretrained",
          url: str | None = None) -> str:
    """Resolve a registered checkpoint to a local path, verifying its md5
    (where the registry has one).

    On a missing file or checksum mismatch, re-download when
    ``SIGE_TPU_ALLOW_DOWNLOAD=1`` (the reference re-downloads
    unconditionally) — otherwise raise with the URL. ``url`` overrides
    the registry mirror."""
    spec = REGISTRY[name]
    path = os.path.join(root, name)
    may_fetch = os.environ.get("SIGE_TPU_ALLOW_DOWNLOAD") == "1"
    if not os.path.exists(path):
        if may_fetch:
            return download(name, root, url=url)
        raise FileNotFoundError(
            f"checkpoint {name} not found at {path}; download it from "
            f"{spec.url} (or set SIGE_TPU_ALLOW_DOWNLOAD=1)")
    if spec.md5 is not None:
        got = md5_file(path)
        if got != spec.md5:
            if may_fetch:
                os.remove(path)
                return download(name, root, url=url)
            raise ValueError(
                f"md5 mismatch for {path}: {got} != {spec.md5}; re-download "
                f"from {spec.url}")
    return path
