"""The port's SD DDIM sampler and ``SDRunner`` against sige_tpu's, on the
tiny configurations of ``tests/test_sd.py`` with weights carried by
``utils/from_jax.py`` (and a post_quant pair).

sige_tpu's noise is passed in: a 3-step twin trajectory through
``img2img_decode_sige`` (classifier-free guidance 2.0), the dense
decode, and ``sdedit`` and ``inpaint`` end to end agree at atol 1e-4;
the schedules are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.models.sd import SDUNetConfig as JUNetConfig
from sige_tpu.models.sd import SDVAEConfig as JVAEConfig
from sige_tpu.models.sd import SIGEDecoder as JDecoder
from sige_tpu.models.sd import SIGEEncoder as JEncoder
from sige_tpu.models.sd import SIGESDUNet as JUNet
from sige_tpu.runners.sd_runner import SDRunConfig as JRunConfig
from sige_tpu.runners.sd_runner import SDRunner as JRunner
from sige_tpu.samplers.sd_ddim import SDDDIMSampler as JSampler
from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
from sige_torch.runners import SDRunConfig, SDRunner
from sige_torch.samplers import SDDDIMSampler
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import (ATOL, TINY_UNET, TINY_VAE, box_mask,
                                flax_params, one_torch_thread)

R = TINY_VAE["resolution"]
L = R // 2
RUN = dict(ddim_steps=4, guidance_scale=2.0, strength=0.75,
           mask_dilate_radius=2, decoder_dilate_radius=4)
STEPS = 3  # int(strength * ddim_steps): the twin trajectory's length


def _t(a):
    return torch.from_numpy(np.array(a))


class Runners:
    """sige_tpu's SDRunner and the port's with the same weights."""

    def __init__(self):
        rng = np.random.default_rng(4)
        img = np.zeros((1, R, R, 3), np.float32)
        z = np.zeros((1, L, L, 4), np.float32)
        params = {
            "unet": flax_params(JUNet(cfg=JUNetConfig(**TINY_UNET)),
                                np.zeros((2, L, L, 4), np.float32),
                                np.zeros((2,), np.float32),
                                np.zeros((2, 5, 16), np.float32), seed=1),
            "encoder": flax_params(JEncoder(cfg=JVAEConfig(**TINY_VAE)), img,
                                   seed=2),
            "decoder": flax_params(JDecoder(cfg=JVAEConfig(**TINY_VAE)), z,
                                   seed=3),
            "post_quant": (
                (np.eye(4) + 0.1 * rng.standard_normal((4, 4))).astype(
                    np.float32),
                (0.05 * rng.standard_normal(4)).astype(np.float32)),
        }
        # the encoder's latents at the scale the random U-Net's inpainting
        # leaves in the edited region (DDIM from x_T with an eps head that
        # does not predict the noise: ~12), so the decoder's folded norms,
        # frozen on the init latent, do not amplify that region (and with
        # it fp32 rounding) by the ratio of the two scales
        enc = params["encoder"]["conv_out"]
        enc["kernel"] = enc["kernel"] * np.float32(20.0)
        self.jr = JRunner(JUNetConfig(**TINY_UNET), JVAEConfig(**TINY_VAE),
                          JRunConfig(**RUN), params=params)
        sd = {k: state_dict_from_flax(v) for k, v in params.items()
              if k != "post_quant"}
        self.tr = SDRunner(SDUNetConfig(**TINY_UNET), SDVAEConfig(**TINY_VAE),
                           SDRunConfig(**RUN),
                           params=dict(sd, post_quant=params["post_quant"]),
                           device="cpu")
        # tiny plans need tiny buckets (as tests/test_sd.py)
        for r in (self.jr, self.tr):
            for m in (r.unet, r.encoder, r.decoder):
                m.bucket_min = 1
        self.init = rng.uniform(-1, 1, (R, R, 3)).astype(np.float32)
        self.edited = self.init.copy()
        self.edited[8:16, 10:20] = rng.uniform(-1, 1, (8, 10, 3))
        self.mask = box_mask((R, R), (8, 13, 10, 16))
        self.c = rng.standard_normal((1, 5, 16)).astype(np.float32)
        self.uc = np.zeros_like(self.c)


@functools.lru_cache(maxsize=None)
def _runners():
    return Runners()


@pytest.fixture(scope="module")
def runners():
    return _runners()


def test_schedule_matches_sige_tpu():
    for kw in (dict(num_steps=4), dict(num_steps=50, eta=0.5)):
        j, t = JSampler(**kw), SDDDIMSampler(**kw)
        np.testing.assert_array_equal(t.timesteps, j.timesteps)
        for name in ("alphas_cumprod", "ddim_alphas", "ddim_alphas_prev",
                     "ddim_sigmas"):
            np.testing.assert_array_equal(getattr(t, name),
                                          np.asarray(getattr(j, name)))


def test_sdedit_matches_sige_tpu(runners):
    r = runners
    want = r.jr.sdedit(r.init, r.edited, uc=jnp.asarray(r.uc),
                       c=jnp.asarray(r.c), seed=2)
    # sige_tpu's stochastic-encode noise (sd_runner.py:186-187)
    noise = np.asarray(jax.random.normal(jax.random.key(2), (1, L, L, 4)))
    got = r.tr.sdedit(r.init, r.edited, uc=r.uc, c=r.c, noise=noise)
    assert got.shape == want.shape == (R, R, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_img2img_twin_trajectory_matches_sige_tpu(runners):
    """The sampler alone, over the U-Net state (caches and plan) the
    sdedit left: stochastic encode with sige_tpu's noise, then 3 twin
    steps."""
    r = runners
    if r.jr.unet.plan is None or not r.tr.unet.plan:
        r.jr.sdedit(r.init, r.edited, uc=jnp.asarray(r.uc),
                    c=jnp.asarray(r.c), seed=2)
        r.tr.sdedit(r.init, r.edited, uc=r.uc, c=r.c, seed=2)
    rng = np.random.default_rng(9)
    z0 = rng.standard_normal((1, L, L, 4)).astype(np.float32)
    z1 = z0.copy()
    z1[:, 4:7, 5:8] += 0.5
    noise = np.asarray(jax.random.normal(jax.random.key(5), z0.shape))
    js, ts = r.jr.sampler, r.tr.sampler
    jz = [js.stochastic_encode(jnp.asarray(z), STEPS - 1, jnp.asarray(noise))
          for z in (z0, z1)]
    tz = [ts.stochastic_encode(_t(z), STEPS - 1, _t(noise)) for z in (z0, z1)]
    for a, b in zip(tz, jz):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    u = r.jr.unet
    j_init, j_edit, _ = js.img2img_decode_sige(
        u.module, u.params, u.plan, u.cache, *jz, jnp.asarray(r.uc),
        jnp.asarray(r.c), t_start=STEPS)
    t_init, t_edit = ts.img2img_decode_sige(r.tr.unet, *tz, _t(r.uc),
                                            _t(r.c), STEPS)
    np.testing.assert_allclose(t_init.numpy(), np.asarray(j_init), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(t_edit.numpy(), np.asarray(j_edit), atol=ATOL,
                               rtol=0)
    want = js.decode_dense(u.module, u.params, jz[1], jnp.asarray(r.uc),
                           jnp.asarray(r.c), t_start=STEPS)
    got = ts.decode_dense(r.tr.unet, tz[1], _t(r.uc), _t(r.c), STEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_inpaint_matches_sige_tpu(runners):
    r = runners
    want = r.jr.inpaint(r.init, r.mask, uc=jnp.asarray(r.uc),
                        c=jnp.asarray(r.c), seed=1)
    # sige_tpu's noise: x_T, then one q_sample draw per step
    # (sd_runner.py:143-145, sd_ddim.py:132-133)
    key, kx = jax.random.split(jax.random.key(1))
    shape = (1, L, L, 4)
    noise = [jax.random.normal(kx, shape)]
    for _ in range(RUN["ddim_steps"]):
        key, sub = jax.random.split(key)
        noise.append(jax.random.normal(sub, shape))
    got = r.tr.inpaint(r.init, r.mask, uc=r.uc, c=r.c,
                       noise=[np.asarray(n) for n in noise])
    assert got.shape == want.shape == (R, R, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_seeded_noise_runs_and_defaults_contexts(runners):
    """Without explicit noise the runner draws from its generator; without
    contexts it uses zero text embeddings (as sige_tpu's)."""
    r = runners
    out = r.tr.sdedit(r.init, r.edited, seed=3)
    assert out.shape == (R, R, 3) and np.isfinite(out).all()
    again = r.tr.sdedit(r.init, r.edited, seed=3)
    np.testing.assert_array_equal(out, again)


def test_runner_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SDRunner(SDUNetConfig(**TINY_UNET), SDVAEConfig(**TINY_VAE))
