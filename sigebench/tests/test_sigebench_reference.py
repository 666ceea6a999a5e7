"""The harness end to end on the CPU at tiny sizes: the plain reference
agrees with the program's stacked sessions (the port's plain versions of
its kernels) in every cell's layout and model; and planted faults of the
timed path turn ``correct`` false."""

import time

import pytest
import torch

from sigebench import harness
from tiny import cell

CELLS = [("ddpm_church256", "window_s8", {}),
         ("ddpm_church256", "tiles_s8", {"area": [0.01, 0.03]}),
         ("sd_v1_512", "unet_window_s4", {}),
         ("sd_v1_512", "decoder_window_s2", {"sessions": 2})]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(c, seed, hook=None):
    out = harness.run_cell(c, seed, 0.3, False, "cpu", time.perf_counter(),
                           server_hook=hook, cache_dir=None)
    limit = float(c.config["limit"]["max_rel_err"])
    return out, harness.verdict(out["compared"]["errs"], limit)


@pytest.mark.parametrize("config,traffic,mix", CELLS,
                         ids=[f"{a}.{b}" for a, b, _ in CELLS])
def test_reference_agrees_with_the_program(config, traffic, mix):
    c = cell(config, traffic, **mix)
    out, (correct, failed) = _run(c, 2**31 + 3)
    assert correct and failed == 0, out["compared"]["errs"]
    assert max(out["compared"]["errs"]) < 1e-5
    assert out["record"].steps >= 1


def _stale(server):
    """A step that returns the previous step's outputs."""
    step, last = server.step, []

    def stale(*a, **k):
        y = step(*a, **k)
        out = last[0] if last else y
        last[:] = [y]
        return out
    server.step = stale
    return server


def _half(server):
    """Half of the sessions left out: their rows repeat the others'."""
    step = server.step

    def half(*a, **k):
        y = step(*a, **k).clone()
        S = y.shape[0]
        y[S // 2:] = y[:S - S // 2].clone()
        return y
    server.step = half
    return server


def _altered(server):
    """One value of one session's output altered where it is produced."""
    step = server.step

    def altered(*a, **k):
        y = step(*a, **k).clone()
        y.view(-1)[y.numel() // 3] += 1e-2 * y.abs().max()
        return y
    server.step = altered
    return server


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_batch", "altered"])
def test_planted_faults_are_not_correct(fault):
    c = cell("ddpm_church256", "window_s8", period=2, stagger=1)
    _, (correct, failed) = _run(c, 2**31 + 4, fault)
    assert not correct and failed >= 1
