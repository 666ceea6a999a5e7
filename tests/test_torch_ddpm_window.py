"""The port's DDPM U-Net in the window layout against sige_tpu's.

Two tiny configurations, each with ``window_chain`` on and off:
  * ``tiny`` — ``tests/test_window.py``'s ``DDPM_TINY`` (two resblocks a
    level, a sparse 16 px attention, a channel change on the up path);
  * ``chain`` — ``tests/test_window_chain.py``'s ``_ddpm`` config (three
    levels, so chains cross two resamples; a stride-2 downsample chain).

Weights are bridged with ``utils/from_jax.py``. Dense, full and sparse
outputs agree with sige_tpu at atol 1e-4 (fp32 on both sides; sums
reassociate); sparse on the original input equals full, also after a
sparse call on the edited input (a join that wrote into its cache would
show there); MACs equal sige_tpu's traced count at rel 1e-6;
``layout="auto"`` picks what sige_tpu picks; and a 3-step DDIM twin
trajectory through ``DiffusionRunner(layout="auto")`` agrees at 1e-4.
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
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.runners import DiffusionRunConfig as JRunConfig
from sige_tpu.runners import DiffusionRunner as JRunner
from sige_tpu.samplers import get_sampling_sequence
from sige_tpu.utils import traced_macs
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.module import SIGECtx, WindowState
from sige_torch.runners import DiffusionRunConfig, DiffusionRunner
from sige_torch.utils.from_jax import state_dict_from_flax

ATOL = 1e-4
R = 32
CONFIGS = {
    "tiny": (dict(ch=16, ch_mult=(1, 2), num_res_blocks=2,
                  attn_resolutions=(16,), resolution=R, num_groups=8,
                  sparse_resolution_threshold=16), (8, 16, 10, 20)),
    "chain": (dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                   attn_resolutions=(8,), resolution=R,
                   sparse_resolution_threshold=16), (10, 18, 12, 22)),
}
BORDER = (0, 7, 26, 32)  # tests/test_window.py::test_window_edit_at_image_border


def _edit(rng, x0, box):
    mask = np.zeros((R, R), bool)
    mask[box[0]:box[1], box[2]:box[3]] = True
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    x1 = (x0 + 0.5 * noise * mask[None, :, :, None]).astype(np.float32)
    return x1, downsample_mask(dilate_mask(mask, 2), min_res=4)


class Pair:
    """sige_tpu's U-Net and the port's with the same weights, window
    layout, ``window_chain`` on and off, on the same inputs."""

    def __init__(self, name):
        kw, box = CONFIGS[name]
        self.kw = kw
        rng = np.random.default_rng(0)
        self.x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
        self.x1, self.masks = _edit(rng, self.x0, box)
        self.t = np.array([3.0], np.float32)
        j = jnp.asarray

        jm = JModel(JUNet(cfg=JConfig(**kw)), layout="window")
        jm.init(jax.random.key(0), j(self.x0), j(self.t))
        self.j_full = np.asarray(jm.full(j(self.x0), j(self.t)))
        self.j_dense = np.asarray(jm.module.apply(
            {"params": jm.params}, j(self.x0), j(self.t),
            ctx=JCtx(mode="dense")))
        self.jm, self.sd = jm, state_dict_from_flax(jax.device_get(jm.params))
        self.j_sparse, self.j_models = {}, {}
        for chain in (True, False):
            # the full pass does not depend on window_chain: share it
            m = JModel(JUNet(cfg=JConfig(**kw, window_chain=chain)),
                       jm.params, layout="window")
            m.cache, m.meta = jm.cache, jm.meta
            m.set_masks(self.masks)
            self.j_sparse[chain] = np.asarray(m.sparse(j(self.x1), j(self.t)))
            self.j_models[chain] = m

    def torch_model(self, chain, layout="window"):
        tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**self.kw,
                                                    window_chain=chain)),
                       layout=layout, device="cpu")
        tm.module.load_state_dict(self.sd)
        return tm


@functools.lru_cache(maxsize=None)
def _pair(name):
    return Pair(name)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _pair(request.param)


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("chain", [True, False])
def test_forwards_match_sige_tpu(pair, chain):
    tm = pair.torch_model(chain)
    np.testing.assert_allclose(tm.dense(_t(pair.x0), _t(pair.t)).numpy(),
                               pair.j_dense, atol=ATOL, rtol=0)
    full = tm.full(_t(pair.x0), _t(pair.t)).numpy()
    np.testing.assert_allclose(full, pair.j_full, atol=ATOL, rtol=0)
    tm.set_masks(pair.masks)
    assert tm.active_layout == "window"
    sparse = tm.sparse(_t(pair.x1), _t(pair.t)).numpy()
    np.testing.assert_allclose(sparse, pair.j_sparse[chain], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("chain", [True, False])
def test_sparse_on_original_equals_full_also_after_an_edit(pair, chain):
    tm = pair.torch_model(chain)
    full = tm.full(_t(pair.x0), _t(pair.t)).numpy()
    tm.set_masks(pair.masks)
    before = tm.sparse(_t(pair.x0), _t(pair.t)).numpy()
    np.testing.assert_allclose(before, full, atol=ATOL, rtol=0)
    edited = tm.sparse(_t(pair.x1), _t(pair.t)).numpy()
    assert np.abs(edited - full).max() > 1e-3
    after = tm.sparse(_t(pair.x0), _t(pair.t)).numpy()
    np.testing.assert_allclose(after, full, atol=ATOL, rtol=0)


def test_chain_threads_window_states(pair, monkeypatch):
    """With window_chain the resblocks' chain path runs and hands on
    window states (the gate failing closed would still be exact)."""
    from sige_torch.models.ddpm import unet

    outs = []
    orig = unet.SIGEResnetBlock._chain_window

    def spy(self, x, ctx):
        out = orig(self, x, ctx)
        outs.append(out)
        return out

    monkeypatch.setattr(unet.SIGEResnetBlock, "_chain_window", spy)
    tm = pair.torch_model(True)
    tm.full(_t(pair.x0), _t(pair.t))
    tm.set_masks(pair.masks)
    tm.sparse(_t(pair.x1), _t(pair.t))
    assert outs and all(isinstance(o, WindowState) for o in outs)
    n_chain = len(outs)
    tm = pair.torch_model(False)
    tm.full(_t(pair.x0), _t(pair.t))
    tm.set_masks(pair.masks)
    tm.sparse(_t(pair.x1), _t(pair.t))
    assert len(outs) == n_chain


def test_macs_match_sige_tpu(pair):
    tm = pair.torch_model(True)
    tm.full(_t(pair.x0), _t(pair.t))
    tm.set_masks(pair.masks)
    ctx = SIGECtx(mode="sparse", macs=[])
    with torch.inference_mode():
        tm.module(_t(pair.x1), _t(pair.t), ctx=ctx)
    jm = pair.j_models[True]
    want = traced_macs(jm.module, {"params": jm.params, "cache": jm.cache,
                                   "sige": jm.plan},
                       jnp.asarray(pair.x1), jnp.asarray(pair.t),
                       ctx=JCtx(mode="sparse"))
    assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


def test_auto_picks_what_sige_tpu_picks(pair):
    compact = np.zeros((R, R), bool)
    compact[10:18, 12:20] = True
    scattered = np.zeros((R, R), bool)
    scattered[2:6, 2:6] = True
    scattered[26:30, 26:30] = True
    jm = JModel(pair.jm.module, pair.jm.params, layout="auto")
    jm.meta = pair.jm.meta
    tm = pair.torch_model(True, layout="auto")
    full = tm.full(_t(pair.x0), _t(pair.t)).numpy()
    picked = []
    for mask in (compact, scattered):
        masks = downsample_mask(dilate_mask(mask, 1), min_res=4)
        jm.set_masks(masks)
        tm.set_masks(masks)
        assert tm.active_layout == jm.active_layout
        picked.append(tm.active_layout)
        np.testing.assert_allclose(tm.sparse(_t(pair.x0), _t(pair.t)).numpy(),
                                   full, atol=ATOL, rtol=0)
    assert picked == ["window", "tiles"]


@pytest.mark.parametrize("chain", [True, False])
def test_border_edit_matches_sige_tpu(chain):
    """The edit of tests/test_window.py::test_window_edit_at_image_border:
    4-form metas at the canvas edge."""
    pair = _pair("tiny")
    rng = np.random.default_rng(4)
    x1, masks = _edit(rng, pair.x0, BORDER)
    jm = JModel(JUNet(cfg=JConfig(**pair.kw, window_chain=chain)),
                pair.jm.params, layout="window")
    jm.cache, jm.meta = pair.jm.cache, pair.jm.meta
    jm.set_masks(masks)
    want = np.asarray(jm.sparse(jnp.asarray(x1), jnp.asarray(pair.t)))

    tm = pair.torch_model(chain)
    full = tm.full(_t(pair.x0), _t(pair.t)).numpy()
    plan = tm.set_masks(masks)
    assert any(len(g["win_in"]) == 4 for g in _gathers(plan))
    np.testing.assert_allclose(tm.sparse(_t(x1), _t(pair.t)).numpy(), want,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.sparse(_t(pair.x0), _t(pair.t)).numpy(),
                               full, atol=ATOL, rtol=0)


def _gathers(plan):
    for v in plan.values():
        if isinstance(v, dict):
            if "win_in" in v:
                yield v
            else:
                yield from _gathers(v)


def test_ddim_twin_trajectory_through_auto_runner():
    pair = _pair("chain")
    rc = dict(sampler_type="ddim", sample_steps=3, noise_level=300)
    jr = JRunner(JConfig(**pair.kw), JRunConfig(**rc), params=pair.jm.params)
    tr = DiffusionRunner(DDPMUNetConfig(**pair.kw), DiffusionRunConfig(**rc),
                         params=pair.sd, device="cpu")
    assert tr.model.layout == jr.model.layout == "auto"
    rng = np.random.default_rng(0)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    edited[10:16, 12:19] = rng.random((6, 7, 3))
    jx0, jx1, mask = jr.preprocess(original, edited)
    tx0, tx1, tmask = tr.preprocess(original, edited)
    np.testing.assert_array_equal(tmask, mask)
    assert tr.active_layout == jr.model.active_layout == "window"

    e = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    seq = get_sampling_sequence(3, 300)
    xts = jr.sampler.q_sample(jnp.concatenate([jx0, jx1]), int(seq[-1]),
                              jnp.asarray(np.concatenate([e, e])))
    want, _ = jr.sampler.sample_sige(
        jr.module, jr.model.params, jr.model.plan, jr.model.cache, xts,
        jnp.asarray(seq), jnp.asarray(mask), jx0, jnp.asarray(e),
        jax.random.key(1))
    got = tr.sampler.sample_sige(
        tr.model, torch.from_numpy(np.array(xts)), seq, _t(mask), tx0, _t(e),
        noise=np.zeros((len(seq), 2, R, R, 3), np.float32))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= ATOL, err


def test_window_chain_off_plans_without_nesting():
    """chain_nesting=False plans no up2 markers and stays exact."""
    kw, box = CONFIGS["chain"]
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    _, masks = _edit(rng, x0, box)
    tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**kw)), layout="window",
                   chain_nesting=False, device="cpu")
    tm.init(0)
    t = torch.zeros(1)
    full = tm.full(_t(x0), t).numpy()
    plan = tm.set_masks(masks)
    assert not any("wup_ok" in g for g in _gathers(plan))
    np.testing.assert_allclose(tm.sparse(_t(x0), t).numpy(), full, atol=ATOL,
                               rtol=0)
