"""Tiny cells for the CPU tests: the benchmark's configurations cut to a
few channels and a 32 px image (64 px for SD), with mixes scaled to
them. The harness runs them on the CPU through the port's plain
versions of its kernels."""

import copy
import json
from pathlib import Path

from sigebench.harness import Cell

ROOT = Path(__file__).resolve().parents[2]

DDPM_UNET = dict(ch=16, ch_mult=[1, 2, 2], num_res_blocks=1,
                 attn_resolutions=[8], resolution=32, num_groups=8,
                 sparse_resolution_threshold=16)
SD_UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[1, 2],
               channel_mult=[1, 2], num_heads=4, context_dim=16, num_groups=8)
SD_DECODER = dict(ch=16, ch_mult=[1, 2], num_res_blocks=1, resolution=64,
                  num_groups=8)


def _json(path):
    return json.loads((ROOT / path).read_text())


def cell(config: str, traffic: str, **mix) -> Cell:
    """``config`` x ``traffic`` from the repo's files with the model cut
    to the tiny sizes above and the mix's fields overridden by ``mix``."""
    manifest = _json("BENCHMARK.json")
    conf = copy.deepcopy(_json(f"sigebench/configs/{config}.json"))
    if conf["family"] == "ddpm":
        conf["model"]["unet"].update(DDPM_UNET)
        conf["image"] = 32
        conf["mask"] = {"dilate": 2, "min_res": 4}
    else:
        conf["model"]["unet"].update(SD_UNET)
        conf["model"]["decoder"].update(SD_DECODER)
        conf["image"], conf["latent"], conf["context"] = 256, 32, [7, 16]
        conf["mask"].update(dilate=2, decoder_dilate=4, min_res=4)
    m = dict(_json(f"sigebench/traffic/{traffic}.json"))
    m.update(sessions=3, pool=3, trace_steps=3, compared_steps=3)
    m.update(mix)
    return Cell(f"{config}.{traffic}", {"chips": 1}, manifest, conf, m)
