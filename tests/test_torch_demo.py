"""The port's cache slots, ``sparse_update`` and demo runner against
sige_tpu's, at ``tests/test_demo.py``'s TINY (32 px, 4 steps from noise
level 40 of 100, dilation 2, ``bucket_min`` 1).

Weights are bridged with ``utils/from_jax.py`` and sige_tpu's noise
(``base_e``, drawn from ``jax.random.key``) is handed to the port; fp32
on both sides, atol 1e-4.

  * ``SIGEModel`` with three cache slots: ``full(cache_id=k)`` for each
    k, then ``sparse(cache_id=1)``, in the tile layout and in the window
    layout with chains; ``sparse_update`` replaces slot 1's entries only
    (the other slots keep the same tensor objects) and commits the edit
    (a second edit over it equals sige_tpu's);
  * ``DemoRunner`` with DDIM and with DPM-Solver++: reset, generate, the
    empty edit, apply, the no-op re-generate after apply and a second
    edit over the applied caches, each against sige_tpu's runner;
  * the options that came with a later slice run: slots and
    ``sparse_update`` on the PD, SD and GauGAN models, and bf16 caches
    with the demo's slots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.demo import DemoRunner as JDemoRunner
from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_torch.demo import DemoRunner
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
R = 32
# tests/test_demo.py:10-12 and its runner arguments
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=R, sparse_resolution_threshold=32)
KW = dict(sample_steps=4, noise_level=40, total_steps=100,
          mask_dilate_radius=2, bucket_min=1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _params(jm):
    return state_dict_from_flax(jax.device_get(jm.params))


# --- SIGEModel with cache slots ----------------------------------------------

SLOTS = 3
# tests/test_window_chain.py:225-228: a chain across the level
SLOT_CFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(8,), resolution=R,
                sparse_resolution_threshold=16, cache_slots=SLOTS)
TIMES = (0.0, 100.0, 300.0)


def _box_mask(box):
    m = np.zeros((R, R), bool)
    m[box[0]:box[1], box[2]:box[3]] = True
    return m


class SlotPair:
    """sige_tpu's U-Net and the port's with three cache slots: slot k
    holds the full pass at ``TIMES[k]`` on its own input; slot 1 then
    runs an edit, commits it, and runs a second edit over it."""

    def __init__(self, layout):
        rng = np.random.default_rng(13)
        self.layout = layout
        self.xs = rng.standard_normal((SLOTS, 1, R, R, 3)).astype(np.float32)
        self.ts = [np.array([t], np.float32) for t in TIMES]
        m1, m2 = _box_mask((8, 16, 10, 20)), _box_mask((18, 24, 4, 12))
        self.x1 = self.xs[1] + (0.5 * rng.standard_normal((1, R, R, 3))
                                * m1[None, :, :, None]).astype(np.float32)
        self.x2 = self.x1 + (0.5 * rng.standard_normal((1, R, R, 3))
                             * m2[None, :, :, None]).astype(np.float32)
        self.masks1 = downsample_mask(dilate_mask(m1, 2), min_res=8)
        self.masks2 = downsample_mask(dilate_mask(m2, 2), min_res=8)
        j = jnp.asarray
        jm = JModel(JUNet(cfg=JConfig(**SLOT_CFG)), layout=layout,
                    bucket_min=1)
        jm.init(jax.random.key(0), j(self.xs[0]), j(self.ts[0]))
        self.j_full = [np.asarray(jm.full(j(self.xs[k]), j(self.ts[k]),
                                          cache_id=k))
                       for k in range(SLOTS)]
        jm.set_masks(self.masks1)
        self.j_sparse1 = np.asarray(jm.sparse(j(self.x1), j(self.ts[1]),
                                              cache_id=1))
        self.j_update = np.asarray(jm.sparse(j(self.x1), j(self.ts[1]),
                                             cache_id=1, sparse_update=True))
        jm.set_masks(self.masks2)
        self.j_second = np.asarray(jm.sparse(j(self.x2), j(self.ts[1]),
                                             cache_id=1))
        self.sd = _params(jm)

    def torch_model(self):
        tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**SLOT_CFG)),
                       layout=self.layout, bucket_min=1, device="cpu")
        tm.module.load_state_dict(self.sd)
        return tm


@functools.lru_cache(maxsize=None)
def _slot_pair(layout):
    return SlotPair(layout)


@pytest.fixture(scope="module", params=["tiles", "window"])
def slot_pair(request):
    return _slot_pair(request.param)


def test_slots_full_and_sparse_match_sige_tpu(slot_pair):
    p = slot_pair
    tm = p.torch_model()
    for k in range(SLOTS):
        got = tm.full(_t(p.xs[k]), _t(p.ts[k]), cache_id=k).numpy()
        np.testing.assert_allclose(got, p.j_full[k], atol=ATOL, rtol=0)
    tm.set_masks(p.masks1)
    assert tm.active_layout == p.layout
    for k in range(SLOTS):  # each slot replays its own full pass
        got = tm.sparse(_t(p.xs[k]), _t(p.ts[k]), cache_id=k).numpy()
        np.testing.assert_allclose(got, p.j_full[k], atol=ATOL, rtol=0)
    got = tm.sparse(_t(p.x1), _t(p.ts[1]), cache_id=1).numpy()
    np.testing.assert_allclose(got, p.j_sparse1, atol=ATOL, rtol=0)
    assert np.abs(got - p.j_full[1]).max() > 1e-3


def test_sparse_update_commits_one_slot(slot_pair):
    p = slot_pair
    tm = p.torch_model()
    for k in range(SLOTS):
        tm.full(_t(p.xs[k]), _t(p.ts[k]), cache_id=k)
    tm.set_masks(p.masks1)
    before = {k: [id(t) for t in tm.state.tensors(k)] for k in range(SLOTS)}
    got = tm.sparse(_t(p.x1), _t(p.ts[1]), cache_id=1,
                    sparse_update=True).numpy()
    np.testing.assert_allclose(got, p.j_update, atol=ATOL, rtol=0)
    after = {k: [id(t) for t in tm.state.tensors(k)] for k in range(SLOTS)}
    for k in (0, 2):
        assert after[k] == before[k], f"slot {k} changed"
    assert after[1] != before[1]
    # the committed edit is slot 1's baseline: sparse on it equals it ...
    got = tm.sparse(_t(p.x1), _t(p.ts[1]), cache_id=1).numpy()
    np.testing.assert_allclose(got, p.j_update, atol=ATOL, rtol=0)
    # ... the other slots still replay their full passes ...
    for k in (0, 2):
        got = tm.sparse(_t(p.xs[k]), _t(p.ts[k]), cache_id=k).numpy()
        np.testing.assert_allclose(got, p.j_full[k], atol=ATOL, rtol=0)
    # ... and a second edit runs over it as in sige_tpu
    tm.set_masks(p.masks2)
    got = tm.sparse(_t(p.x2), _t(p.ts[1]), cache_id=1).numpy()
    np.testing.assert_allclose(got, p.j_second, atol=ATOL, rtol=0)


def test_window_chains_run_with_slots_and_step_aside_for_updates(
        monkeypatch):
    """With slots the window chains stay on (tests/test_window_chain.py:
    222 holds sige_tpu to that); under sparse_update they are off: a
    chain never forms the scattered maps the caches take."""
    from sige_torch.models import blocks

    p = _slot_pair("window")
    tm = p.torch_model()
    for k in range(SLOTS):
        tm.full(_t(p.xs[k]), _t(p.ts[k]), cache_id=k)
    tm.set_masks(p.masks1)
    calls = []
    orig = blocks.ResBlock._chain_window

    def spy(self, x, ctx):
        calls.append(ctx.cache_id)
        return orig(self, x, ctx)

    monkeypatch.setattr(blocks.ResBlock, "_chain_window", spy)
    tm.sparse(_t(p.x1), _t(p.ts[2]), cache_id=2)
    assert calls and set(calls) == {2}
    calls.clear()
    tm.sparse(_t(p.x1), _t(p.ts[1]), cache_id=1, sparse_update=True)
    assert not calls


def test_cache_id_outside_the_slots_raises():
    tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**SLOT_CFG)), device="cpu")
    x, t = torch.zeros(1, R, R, 3), torch.zeros(1)
    with pytest.raises(IndexError):
        tm.full(x, t, cache_id=SLOTS)
    with pytest.raises(IndexError):
        tm.full(x, t, cache_id=-1)


# --- DemoRunner ---------------------------------------------------------------


def _images():
    """Base image, two edits (the second over the first) at TINY."""
    rng = np.random.default_rng(0)
    base = rng.random((R, R, 3)).astype(np.float32)
    e1 = base.copy()
    e1[10:18, 12:20] = 0.9
    e2 = e1.copy()
    e2[20:26, 4:12] = 0.1
    return base, e1, e2


class DemoPair:
    """sige_tpu's demo runner through reset -> generate(e1) -> the empty
    edit -> apply(e1) -> generate(e1) (a no-op edit now) -> generate(e2)
    over the applied caches."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.base, self.e1, self.e2 = _images()
        jr = JDemoRunner(JConfig(**TINY), sampler_type=sampler, **KW)
        self.j = {"reset": jr.reset_base_image(self.base)}
        self.noise = np.array(jr.base_e)
        self.sd = _params(jr.model)
        self.j["edit"] = jr.generate(self.e1)
        self.j["empty"] = jr.generate(self.base)
        self.j["apply"] = jr.generate(self.e1, sparse_update=True)
        self.j["noop"] = jr.generate(self.e1)
        self.j["second"] = jr.generate(self.e2)

    def torch_runner(self):
        return DemoRunner(DDPMUNetConfig(**TINY), sampler_type=self.sampler,
                          params=self.sd, device="cpu", **KW)


@functools.lru_cache(maxsize=None)
def _demo_pair(sampler):
    return DemoPair(sampler)


@pytest.fixture(scope="module", params=["ddim", "dpm_solver"])
def demo_pair(request):
    return _demo_pair(request.param)


def test_demo_runner_matches_sige_tpu(demo_pair):
    p = demo_pair
    tr = p.torch_runner()
    assert tr.model.cache_slots == 4 and tr.model.layout == "tiles"
    got = {"reset": tr.reset_base_image(p.base, noise=p.noise)}
    got["edit"] = tr.generate(p.e1)
    assert tr.model.active_layout == "tiles"
    got["empty"] = tr.generate(p.base)
    got["apply"] = tr.generate(p.e1, sparse_update=True)
    got["noop"] = tr.generate(p.e1)
    got["second"] = tr.generate(p.e2)
    for k, want in p.j.items():
        assert got[k].shape == (R, R, 3), k
        np.testing.assert_allclose(got[k], want, atol=ATOL, rtol=0,
                                   err_msg=k)
    # the empty edit returns the base image; after apply the edit is the
    # base image
    np.testing.assert_allclose(got["empty"], p.base, atol=1e-6)
    np.testing.assert_allclose(got["noop"], p.e1, atol=1e-6)
    assert np.abs(got["edit"] - got["reset"]).max() > 1e-3


def test_reset_fills_one_slot_per_step(demo_pair):
    p = demo_pair
    tr = p.torch_runner()
    tr.reset_base_image(p.base, noise=p.noise)
    state = tr.model.state
    per_slot = [state.tensors(k) for k in range(4)]
    assert all(per_slot) and len({len(s) for s in per_slot}) == 1
    # different steps, different caches (each slot its own tensors)
    assert not {id(t) for t in per_slot[0]} & {id(t) for t in per_slot[1]}
    name = next(n for n, slots in state.caches.items()
                if "original" in slots[0])
    a, b = (state.caches[name][k]["original"] for k in (0, 1))
    assert not torch.allclose(a, b)


def test_sparse_only_trajectory_of_the_base_reproduces_the_reset(demo_pair):
    """Under an edit's plan, the sparse-only trajectory of the unedited
    base reads each step's slot and gives back the reset's output (a
    wrong slot read would show here)."""
    p = demo_pair
    tr = p.torch_runner()
    out = tr.reset_base_image(p.base, noise=p.noise)
    tr.generate(p.e1)  # plans the edit
    with torch.inference_mode():
        xt = tr.sampler.q_sample(tr.base_x0, tr.seq[-1], tr.base_e)
        mask = torch.ones((R, R), dtype=torch.bool)
        if p.sampler == "dpm_solver":
            x = tr._dpm_trajectory(xt, "sparse", mask)
        else:
            x = tr._sparse_trajectory(xt, mask, False)
    np.testing.assert_allclose(tr._out(x), out, atol=ATOL, rtol=0)


def test_generate_needs_a_reset():
    tr = DemoRunner(DDPMUNetConfig(**TINY), device="cpu", **KW)
    with pytest.raises(RuntimeError, match="reset_base_image"):
        tr.generate(np.zeros((R, R, 3), np.float32))
    with pytest.raises(ValueError, match="sampler_type"):
        DemoRunner(DDPMUNetConfig(**TINY), device="cpu",
                   sampler_type="ddpm", **KW)


# --- the options that came with a later slice -------------------------------


def _later_models():
    """Per model whose slots and ``sparse_update`` came with a later
    slice: a constructor taking config overrides, its inputs for a seed (an
    edit of ``base`` in a box when ``box`` is given), and the mask
    pyramid of a box."""
    from sige_torch.models.gaugan import SIGEFusedSPADEGenerator, SPADEGenConfig
    from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
    from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                      SIGESDUNet)
    from test_torch_gaugan import TINY as GAUGAN_TINY
    from test_torch_pd import CONFIGS as PD_CONFIGS
    from test_torch_sd_unet import TINY_UNET, TINY_VAE

    def noise(shape, seed, box=None, base=None):
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32))
        if box is None:
            return x
        m = torch.zeros(shape[1:3], dtype=torch.bool)
        m[box[0] // (R // shape[1]):box[1] // (R // shape[1]),
          box[2] // (R // shape[1]):box[3] // (R // shape[1])] = True
        return torch.where(m[None, :, :, None], base + 0.5 * x, base)

    def seg(seed, box=None, base=None):
        """One-hot labels [1, R, 2R, 6] (the edge channel empty)."""
        if box is None:
            labels = torch.from_numpy(np.random.default_rng(seed).integers(
                0, 4, (R, 2 * R)))
        else:
            labels = base[0].argmax(-1).clone()
            labels[box[0]:box[1], box[2]:box[3]] = 4
        return torch.nn.functional.one_hot(labels, 6).float()[None]

    def pyramid(box, shape=(R, R), min_res=4):
        m = np.zeros(shape, bool)
        m[box[0]:box[1], box[2]:box[3]] = True
        return downsample_mask(dilate_mask(m, 1), min_res=min_res,
                               dilation=1)

    return {
        "pd": (lambda **kw: SIGEPDUNet(PDUNetConfig(**PD_CONFIGS["tiny"],
                                                    **kw)),
               lambda k, box=None, base=None: (
                   noise((1, R, R, 3), k, box, base and base[0]),
                   torch.full((1,), 0.5 + k)), pyramid),
        "sd_unet": (lambda **kw: SIGESDUNet(SDUNetConfig(**TINY_UNET, **kw)),
                    lambda k, box=None, base=None: (
                        noise((1, R, R, 4), k, box, base and base[0]),
                        torch.full((1,), 3.0 + k),
                        noise((1, 7, 16), 100)), pyramid),
        "sd_decoder": (lambda **kw: SIGEDecoder(SDVAEConfig(**TINY_VAE,
                                                            **kw)),
                       lambda k, box=None, base=None: (
                           noise((1, R // 2, R // 2, 4), k, box,
                                 base and base[0]),), pyramid),
        "gaugan": (lambda **kw: SIGEFusedSPADEGenerator(
            SPADEGenConfig(**GAUGAN_TINY, **kw)),
                   lambda k, box=None, base=None: (
                       seg(k, box, base and base[0]),),
                   lambda box: pyramid(box, (R, 2 * R), (1, 2))),
    }


@pytest.mark.parametrize("name", ["pd", "sd_unet", "sd_decoder", "gaugan"])
def test_slots_and_updates_on_other_models_raise(name):
    """Cache slots and sparse_update, once left for a later slice, run on
    the PD, SD and GauGAN models (tests/test_torch_slots.py and
    tests/test_torch_sd_slots.py hold them to sige_tpu): two slots (one
    for GauGAN, whose config has none), a commit into the last that
    touches no tensor of another, the committed edit replaying as the
    slot's new baseline, and slot 0 replaying its full pass."""
    build, inputs, masks = _later_models()[name]
    kw = {} if name == "gaugan" else {"cache_slots": 2}
    model = SIGEModel(build(**kw), layout="window", device="cpu")
    model.init(seed=0)
    last = model.cache_slots - 1
    args = [inputs(k) for k in range(last + 1)]
    full = [model.full(*a, cache_id=k) for k, a in enumerate(args)]
    box = (8, 16, 8, 20)
    model.set_masks(masks(box))
    edited = inputs(last + 7, box, args[last])
    before = [[id(t) for t in model.state.tensors(k)] for k in range(2)]
    upd = model.sparse(*edited, cache_id=last, sparse_update=True)
    assert (upd - full[last]).abs().max() > 1e-3
    assert [id(t) for t in model.state.tensors(last)] != before[last]
    torch.testing.assert_close(model.sparse(*edited, cache_id=last), upd,
                               atol=ATOL, rtol=0)
    if last:
        assert [id(t) for t in model.state.tensors(0)] == before[0]
        torch.testing.assert_close(model.sparse(*args[0], cache_id=0),
                                   full[0], atol=ATOL, rtol=0)


def test_cache_dtype_raises():
    """``cache_dtype``, once left for a later slice, runs with the demo's
    cache slots: bf16 scatter caches in every slot, a commit that keeps
    them bf16, and outputs within sige_tpu's own bf16 tolerance (0.05,
    tests/test_cache_dtype.py) of sige_tpu's fp32 ones (the contract of
    narrow storage is tests/test_torch_engine_options.py's)."""
    p = _slot_pair("window")
    tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**SLOT_CFG)), layout="window",
                   bucket_min=1, cache_dtype=torch.bfloat16, device="cpu")
    tm.module.load_state_dict(p.sd)
    for k in range(SLOTS):
        got = tm.full(_t(p.xs[k]), _t(p.ts[k]), cache_id=k).numpy()
        np.testing.assert_allclose(got, p.j_full[k], atol=ATOL, rtol=0)
    tm.set_masks(p.masks1)
    got = tm.sparse(_t(p.x1), _t(p.ts[1]), cache_id=1,
                    sparse_update=True).numpy()
    np.testing.assert_allclose(got, p.j_update, atol=0.05, rtol=0)
    for k in range(SLOTS):
        assert {t.dtype for t in tm.state.tensors(k) if t.ndim == 4} == \
            {torch.bfloat16}
    tm.set_masks(p.masks2)
    got = tm.sparse(_t(p.x2), _t(p.ts[1]), cache_id=1).numpy()
    np.testing.assert_allclose(got, p.j_second, atol=0.05, rtol=0)
