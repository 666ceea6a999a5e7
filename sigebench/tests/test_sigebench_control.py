"""The control on the card, at the tiny cells' sizes: the reference
computed in TF32 (the precision below the configurations' fp32 with TF32
off) in the program's place misses the limit that the program meets.
The full-size readings come from ``python3 -m sigebench.control``."""

import time

import pytest
import torch

from sigebench import harness
from tiny import cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("config,traffic", [
    ("ddpm_church256", "window_s8"), ("sd_v1_512", "unet_window_s4")])
def test_tf32_control_misses_the_limit_the_program_meets(cuda, config,
                                                         traffic):
    c = cell(config, traffic)
    out = harness.run_cell(c, 2**31 + 9, 1.0, False, cuda,
                           time.perf_counter(), control=True, cache_dir=None)
    limit = float(c.config["limit"]["max_rel_err"])
    assert harness.verdict(out["compared"]["errs"], limit) == (True, 0)
    assert not harness.verdict(out["compared"]["control"], limit)[0]
