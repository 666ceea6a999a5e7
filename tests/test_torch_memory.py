"""The memory breakdown of the runners' profiles
(``sige_torch/runners/common.py``, the counterpart of sige_tpu's
``_hbm_entry``): ``cli.common.profile`` on the CPU reports ``params_mb``,
``cache_mb`` and ``plan_mb`` equal to the bytes that the module's state
dict, every cache slot and the plan on the device hold resident (each
storage once: the plan's leaves are views of one buffer), in MB of 2**20
bytes, for the DDPM, PD and GauGAN runners at tiny sizes; dense mode
reports the parameters alone."""

import numpy as np
import pytest
import torch

from sige_torch.cli.common import profile
from sige_torch.models.ddpm import DDPMUNetConfig
from sige_torch.models.gaugan import SPADEGenConfig
from sige_torch.models.pd import PDUNetConfig
from sige_torch.runners import (DiffusionRunConfig, DiffusionRunner,
                                GauGANRunConfig, GauGANRunner, PDRunConfig,
                                PDRunner)

R = 32


def _ddpm():
    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=R,
                         sparse_resolution_threshold=32)
    return DiffusionRunner(cfg, DiffusionRunConfig(sample_steps=2),
                           bucket_min=1, device="cpu")


def _pd():
    cfg = PDUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                       attn_resolutions=(8,), resolution=R, temb_ch=64,
                       head_dim=16, sparse_resolution_threshold=16)
    return PDRunner(cfg, PDRunConfig(), bucket_min=1, device="cpu")


def _gaugan():
    cfg = SPADEGenConfig(ngf=8, semantic_nc=6, crop_size=64,
                         aspect_ratio=2.0, num_upsampling_layers="normal",
                         num_sparse_layers=5)
    return GauGANRunner(cfg, GauGANRunConfig(input_nc=5), bucket_min=1,
                        device="cpu")


def _images(runner):
    if isinstance(runner, GauGANRunner):
        rng = np.random.default_rng(1)
        l0 = rng.integers(0, 4, (32, 64))
        l1 = l0.copy()
        l1[10:17, 20:31] = 3
        return runner.preprocess_input(l0), runner.preprocess_input(l1)
    rng = np.random.default_rng(0)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    edited[8:16, 10:20] = rng.random((8, 10, 3))
    return original, edited


def _mb(tensors):
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
    return sum(storages.values()) / 2**20


def _plan_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _plan_leaves(v)
        else:
            yield v


@pytest.mark.parametrize("mode", ["sparse", "full", "dense"])
@pytest.mark.parametrize("family", ["ddpm", "pd", "gaugan"])
def test_profile_reports_params_caches_and_plan(family, mode):
    torch.manual_seed(0)
    runner = {"ddpm": _ddpm, "pd": _pd, "gaugan": _gaugan}[family]()
    stats = profile(runner, *_images(runner), warmup=0, iters=1, mode=mode)
    model = runner.model
    params = _mb(model.module.state_dict().values())
    assert params > 0
    assert stats["params_mb"] == pytest.approx(params, rel=1e-12)
    if mode == "dense":
        assert "cache_mb" not in stats and "plan_mb" not in stats
        return
    caches = [t for slots in model.state.caches.values() for d in slots
              for t in d.values()]
    plan = list(_plan_leaves(model.plan))
    assert caches and plan
    assert stats["cache_mb"] == pytest.approx(_mb(caches), rel=1e-12)
    assert stats["plan_mb"] == pytest.approx(_mb(plan), rel=1e-12)
    # what the plan holds: one byte buffer (the upload's one copy) of every
    # host element, int leaves as int64 and bool leaves at one byte an
    # element, each leaf at an 8-byte offset
    host = list(_plan_leaves(model.plan_host))
    elements = sum(np.asarray(a).size for a in host)
    assert elements == sum(t.numel() for t in plan)
    assert {t.dtype for t in plan} <= {torch.int64, torch.bool}
    assert stats["plan_mb"] * 2**20 == sum(-(-t.nbytes // 8) * 8 for t in plan)
