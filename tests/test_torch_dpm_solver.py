"""The port's DPM-Solver sampler against sige_tpu's.

The noise schedule and every host-computed coefficient are float64 numpy
on both sides, so they are compared for equality; one solver update per
order, algorithm and solver type agrees at 1e-6 (the same fp32 tensor
arithmetic). A 3-step SDEdit twin trajectory (full pass on the original
row, sparse pass on the edited row, update, blend) runs in both packages
from the same xt, noise and mask with the same weights, for orders 1-3
and both algorithm types, and agrees at 1e-4, the per-forward contract
(each step feeds the previous output back through the U-Net). sige_tpu's
trajectories run eagerly (``jax.disable_jit``): the same functions
without compiling six unrolled programs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.samplers import DiffusionSchedule as JSchedule
from sige_tpu.samplers import DPMSolverSampler as JDPM
from sige_tpu.samplers import get_sampling_sequence
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.runners import DiffusionRunConfig, DiffusionRunner
from sige_torch.samplers import DiffusionSchedule, DPMSolverSampler
from sige_torch.utils.from_jax import state_dict_from_flax

ATOL = 1e-4
R = 16
TINY = dict(ch=32, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(),
            resolution=R, sparse_resolution_threshold=8)


def _pair(**kw):
    j = JDPM(schedule=JSchedule.create("linear", 1e-4, 2e-2, 1000), **kw)
    t = DPMSolverSampler(DiffusionSchedule.create("linear", 1e-4, 2e-2, 1000),
                         **kw)
    return j, t


def test_noise_schedule_and_coefficients_equal():
    j, t = _pair()
    np.testing.assert_array_equal(t._ns.log_alpha_array,
                                  j._ns.log_alpha_array)
    np.testing.assert_array_equal(t._ns.t_array, j._ns.t_array)
    assert t._ns.total_N == j._ns.total_N
    for ti in (-1, 0, 99, 399, 499, 998):
        tc = t._t_cont(ti)
        assert tc == j._t_cont(ti)
        for f in ("log_alpha", "sigma", "lam"):
            assert getattr(t._ns, f)(tc) == getattr(j._ns, f)(tc), (ti, f)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("algorithm_type", ["dpmsolver", "dpmsolver++"])
@pytest.mark.parametrize("solver_type", ["dpmsolver", "taylor"])
def test_update_matches(rng, order, algorithm_type, solver_type):
    j, t = _pair(algorithm_type=algorithm_type, order=order,
                 solver_type=solver_type)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    ms = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
          for _ in range(order)]
    t_prevs = [t._t_cont(s) for s in (299, 199, 99)[-order:]]
    tc = t._t_cont(-1)
    got = t._update(torch.from_numpy(x), [torch.from_numpy(m) for m in ms],
                    t_prevs, tc, order)
    want = j._update(jnp.asarray(x), [jnp.asarray(m) for m in ms], t_prevs,
                     tc, order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _models():
    """sige_tpu's U-Net and the port's with the same weights, caches
    filled on x0 and masks set, plus the twin-trajectory inputs."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    mask = np.zeros((R, R), bool)
    mask[4:9, 5:11] = True
    x1 = np.where(mask[None, :, :, None], x0 + 0.5, x0).astype(np.float32)
    e = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    masks = downsample_mask(dilate_mask(mask, 1), min_res=4)
    t0 = np.zeros((1,), np.float32)

    jm = JModel(JUNet(cfg=JConfig(**TINY)), layout="auto")
    jm.init(jax.random.key(0), jnp.asarray(x0), jnp.asarray(t0))
    jm.full(jnp.asarray(x0), jnp.asarray(t0))
    jm.set_masks(masks)
    tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), layout="auto",
                   device="cpu")
    tm.module.load_state_dict(state_dict_from_flax(jax.device_get(jm.params)))
    tm.full(torch.from_numpy(x0), torch.from_numpy(t0))
    tm.set_masks(masks)
    assert tm.active_layout == jm.active_layout == "window"
    return jm, tm, x0, x1, e, mask


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("algorithm_type", ["dpmsolver", "dpmsolver++"])
def test_twin_trajectory_matches(order, algorithm_type):
    jm, tm, x0, x1, e, mask = _models()
    j, t = _pair(algorithm_type=algorithm_type, order=order)
    seq = get_sampling_sequence(3, 300)
    xt = np.asarray(j.q_sample(jnp.asarray(np.concatenate([x0, x1])),
                               int(seq[-1]),
                               jnp.asarray(np.concatenate([e, e]))))
    with jax.disable_jit():
        want, _ = j.sample_sige(jm.module, jm.params, jm.plan, jm.cache,
                                jnp.asarray(xt), tuple(int(s) for s in seq),
                                jnp.asarray(mask), jnp.asarray(x0),
                                jnp.asarray(e))
    got = t.sample_sige(tm, torch.from_numpy(xt.copy()), seq,
                        torch.from_numpy(mask), torch.from_numpy(x0),
                        torch.from_numpy(e))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= ATOL, err


def test_runner_builds_the_solver_from_its_config():
    rc = DiffusionRunConfig(sampler_type="dpm_solver", order=3,
                            algorithm_type="dpmsolver",
                            solver_type="taylor", lower_order_final=False,
                            sample_steps=2, noise_level=100)
    runner = DiffusionRunner(DDPMUNetConfig(**TINY), rc, device="cpu")
    s = runner.sampler
    assert isinstance(s, DPMSolverSampler)
    assert (s.order, s.algorithm_type, s.solver_type,
            s.lower_order_final) == (3, "dpmsolver", "taylor", False)
    rng = np.random.default_rng(1)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    edited[4:8, 5:9] = rng.random((4, 4, 3))
    out = runner.generate(original, edited, seed=0)
    assert out.shape == original.shape and np.isfinite(out).all()
    assert runner.active_layout == "window"
