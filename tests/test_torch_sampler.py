"""The port's schedules, samplers and runner against sige_tpu's.

The trajectory test runs a 3-step DDIM (eta 0) SDEdit twin trajectory —
full pass on the original row, sparse pass on the edited row, update,
blend — in both packages from the same xt, noise and mask, with the same
weights. Each step feeds the previous step's output back through the
U-Net, so per-forward differences could compound; the tolerance is the
per-forward contract, 1e-4, which the 3-step trajectory meets with room
(measured max abs error 1.5e-6 for this test's inputs on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.runners import DiffusionRunConfig as JRunConfig
from sige_tpu.runners import DiffusionRunner as JRunner
from sige_tpu.samplers import DDIMSampler as JDDIM
from sige_tpu.samplers import DDPMSampler as JDDPM
from sige_tpu.samplers import DiffusionSchedule as JSchedule
from sige_tpu.samplers import diffusion as jdiff
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.planner import plan_rows
from sige_torch.ops import flash
from sige_torch.runners import DiffusionRunConfig, DiffusionRunner
from sige_torch.samplers import DDIMSampler, DDPMSampler, DiffusionSchedule
from sige_torch.samplers import diffusion as tdiff
from sige_torch.utils.from_jax import state_dict_from_flax, torch_path
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

TRAJ_ATOL = 1e-4
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=32, sparse_resolution_threshold=32)


@pytest.mark.parametrize("kind", ["quad", "linear", "const", "jsd", "sigmoid"])
def test_beta_schedules_equal(kind):
    np.testing.assert_array_equal(
        tdiff.get_beta_schedule(kind, 1e-4, 2e-2, 1000),
        jdiff.get_beta_schedule(kind, 1e-4, 2e-2, 1000))
    t = DiffusionSchedule.create(kind, 1e-4, 2e-2, 1000)
    j = JSchedule.create(kind, 1e-4, 2e-2, 1000)
    np.testing.assert_array_equal(t.alphas_cumprod.numpy(),
                                  np.asarray(j.alphas_cumprod))
    for s in (-1, 0, 499, 999):
        assert float(t.alpha(s)) == float(j.alpha(s))


@pytest.mark.parametrize("steps,level,skip", [(5, 500, "uniform"),
                                              (500, 500, "uniform"),
                                              (7, 300, "quad")])
def test_sampling_sequences_equal(steps, level, skip):
    np.testing.assert_array_equal(
        tdiff.get_sampling_sequence(steps, level, skip),
        jdiff.get_sampling_sequence(steps, level, skip))


@pytest.mark.parametrize("t,t_next", [(400, 300), (100, 0), (0, -1)])
def test_updates_match_with_shared_noise(rng, t, t_next):
    x, et, noise = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
                    for _ in range(3))
    ts = DiffusionSchedule.create("linear", 1e-4, 2e-2, 1000)
    js = JSchedule.create("linear", 1e-4, 2e-2, 1000)
    for tcls, jcls, kw in ((DDPMSampler, JDDPM, {}),
                           (DDIMSampler, JDDIM, {"eta": 0.5})):
        got = tcls(ts, **kw).update(
            *(torch.from_numpy(a) for a in (x, et)), ts.alpha(t),
            ts.alpha(t_next), t, torch.from_numpy(noise))
        want = jcls(schedule=js, **kw).update(
            jnp.asarray(x), jnp.asarray(et), js.alpha(t), js.alpha(t_next), t,
            jnp.asarray(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


def _images(R):
    rng = np.random.default_rng(0)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    edited[R // 4:R // 4 + 6, R // 4:R // 4 + 5] = rng.random((6, 5, 3))
    return original, edited


@pytest.fixture(scope="module")
def trajectory_setup():
    """A sige_tpu model and the port's with the same weights, caches filled
    on x0 and masks set, plus the twin-trajectory inputs."""
    rng = np.random.default_rng(0)
    R = TINY["resolution"]
    x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    mask = np.zeros((R, R), bool)
    mask[6:14, 9:20] = True
    x1 = np.where(mask[None, :, :, None], x0 + 0.5, x0).astype(np.float32)
    e = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    masks = downsample_mask(dilate_mask(mask, 2), min_res=4)
    t0 = np.zeros((1,), np.float32)

    jm = JModel(JUNet(cfg=JConfig(**TINY)))
    jm.init(jax.random.key(0), jnp.asarray(x0), jnp.asarray(t0))
    jm.full(jnp.asarray(x0), jnp.asarray(t0))
    jm.set_masks(masks)
    tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), device="cpu")
    tm.module.load_state_dict(state_dict_from_flax(jax.device_get(jm.params)))
    tm.full(torch.from_numpy(x0), torch.from_numpy(t0))
    tm.set_masks(masks)
    return jm, tm, x0, x1, e, mask


def _ddim_pair():
    return (JDDIM(schedule=JSchedule.create("linear", 1e-4, 2e-2, 1000)),
            DDIMSampler(DiffusionSchedule.create("linear", 1e-4, 2e-2, 1000)))


def test_ddim_twin_trajectory_matches(trajectory_setup):
    jm, tm, x0, x1, e, mask = trajectory_setup
    R = x0.shape[1]
    seq = jdiff.get_sampling_sequence(3, 300)
    js, ts = _ddim_pair()
    jxt = js.q_sample(jnp.asarray(np.concatenate([x0, x1])), int(seq[-1]),
                      jnp.asarray(np.concatenate([e, e])))
    want, _ = js.sample_sige(jm.module, jm.params, jm.plan, jm.cache, jxt,
                             jnp.asarray(seq), jnp.asarray(mask),
                             jnp.asarray(x0), jnp.asarray(e),
                             jax.random.key(1))
    got = ts.sample_sige(tm, torch.from_numpy(np.array(jxt)), seq,
                         torch.from_numpy(mask), torch.from_numpy(x0),
                         torch.from_numpy(e),
                         noise=np.zeros((len(seq), 2, R, R, 3), np.float32))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= TRAJ_ATOL, err


def test_ddim_dense_trajectory_matches(trajectory_setup):
    jm, tm, x0, x1, e, mask = trajectory_setup
    seq = jdiff.get_sampling_sequence(2, 200)
    js, ts = _ddim_pair()
    jxt = js.q_sample(jnp.asarray(x1), int(seq[-1]), jnp.asarray(e))
    want = js.sample_dense(jm.module, jm.params, jxt, jnp.asarray(seq),
                           jnp.asarray(mask), jnp.asarray(x0),
                           jnp.asarray(e), jax.random.key(1))
    got = ts.sample_dense(tm, torch.from_numpy(np.array(jxt)), seq,
                          torch.from_numpy(mask), torch.from_numpy(x0),
                          torch.from_numpy(e), generator=torch.Generator())
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= TRAJ_ATOL, err


@pytest.fixture(scope="module")
def runners():
    cfg = JConfig(**TINY)
    jr = JRunner(cfg, JRunConfig(sampler_type="ddim", sample_steps=2,
                                 noise_level=100), seed=0, layout="tiles")
    tr = DiffusionRunner(
        DDPMUNetConfig(**TINY),
        DiffusionRunConfig(sampler_type="ddim", sample_steps=2,
                           noise_level=100),
        params=state_dict_from_flax(jax.device_get(jr.model.params)),
        layout="tiles", device="cpu")
    return jr, tr


def test_runner_preprocess_matches(runners):
    jr, tr = runners
    original, edited = _images(TINY["resolution"])
    jx0, jx1, jmask = jr.preprocess(original, edited)
    tx0, tx1, tmask = tr.preprocess(original, edited)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(tx1.numpy(), np.asarray(jx1))
    jplan, tplan = {}, {}

    def flat(tree, out, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, out, path + (k,))
            else:
                out[torch_path(path) + (k,)] = np.asarray(v)

    flat(jax.device_get(jr.model.plan), jplan)
    flat(plan_rows(tr.model.plan_host, 0), tplan)
    assert jplan.keys() == tplan.keys()
    for k in jplan:
        np.testing.assert_array_equal(tplan[k], jplan[k])
    assert tr.last_edit_ratio == jr.last_edit_ratio


def test_runner_generate_on_cpu(runners):
    _, tr = runners
    original, edited = _images(TINY["resolution"])
    before = flash.flash_mha.launches
    out = tr.generate(original, edited, seed=0)
    assert out.shape == original.shape and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert flash.flash_mha.launches == before  # CPU tensors: plain twin
    with pytest.raises(RuntimeError):
        tr.profile(original, edited)
