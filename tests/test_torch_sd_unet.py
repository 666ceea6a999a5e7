"""The port's SD U-Net against sige_tpu's, on the tiny configuration of
``tests/test_sd.py`` with weights carried by ``utils/from_jax.py``.

In the window layout (the SD runner's), at batch 1 and at batch 2 (the
classifier-free-guidance batch: the caches hold both halves), with
``window_chain`` on (masked stale-K/V transformers) and off: full and
sparse outputs agree with sige_tpu at atol 1e-4 (fp32 on both sides);
sparse on the original input equals full, also after a sparse call on
the edited input; a plan that mixes window and tile gathers (the
planner's ``max_cover`` drops the coarse level) agrees too; MACs equal
sige_tpu's traced count.

sige_tpu runs once at batch 2: one full pass that every edit and chain
setting shares, and per edit one sparse pass with chains on and one with
them off. Batch rows are independent (per-sample norms, attention and
caches), so the port at batch 1 is held against row 0 of those outputs.

The other SD test files import the shared pieces from here: the tiny
configurations and seeded flax parameter trees.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.sd import SDUNetConfig as JConfig
from sige_tpu.models.sd import SIGESDUNet as JUNet
from sige_tpu.models.sd.unet import sd_timestep_embedding as j_embedding
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.utils import traced_macs
from sige_torch.models.sd import SDUNetConfig, SIGESDUNet
from sige_torch.models.sd import unet as sd_unet
from sige_torch.nn import SIGEModel
from sige_torch.nn.module import SIGECtx, WindowState
from sige_torch.utils.from_jax import state_dict_from_flax

ATOL = 1e-4

# tests/test_sd.py:19-27
TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4,
                 num_res_blocks=1, attention_resolutions=(1, 2),
                 channel_mult=(1, 2), num_heads=4, context_dim=16,
                 num_groups=8)
TINY_VAE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                z_channels=4, resolution=32, num_groups=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's tiny CPU ops while a module of
    these tests runs: a parallel test run has one process per core, and
    torch's default of one thread per core oversubscribes the CPU and
    slows these files several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_params(module, *args, seed: int = 0):
    """A seeded parameter tree (nested dicts of numpy arrays) for a
    ``sige_tpu`` module called as ``module(*args, ctx=full)``.

    The shapes come from ``jax.eval_shape`` of the flax init (no compile),
    the values from ``numpy.random.default_rng``: fan-in-scaled kernels,
    norm scales near 1 and small non-zero biases, so a bias or scale that
    the weight bridge put in the wrong place shows."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), *(jnp.asarray(a) for a in args),
        ctx=JCtx(mode="full")))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "bias" or name.endswith("_bias"):
            a = 0.05 * rng.standard_normal(s.shape)
        elif len(s.shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:  # HWIO conv or [in, out] dense kernel
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def box_mask(shape, box):
    m = np.zeros(shape, bool)
    m[box[0]:box[1], box[2]:box[3]] = True
    return m


def gather_plans(plan):
    """Every gather entry of a (host) plan tree."""
    for v in plan.values():
        if isinstance(v, dict):
            if "indices" in v:
                yield v
            else:
                yield from gather_plans(v)


H = 32  # latent size
# edit boxes: "window" plans windows at both levels; "mixed" is wide
# enough that the 16 px level's window would cover more than max_cover
# of its canvas, so that level runs tiles
EDITS = {"window": (8, 18, 10, 22), "mixed": (6, 26, 6, 26)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(args):
    return [jnp.asarray(a) for a in args]


class Reference:
    """sige_tpu's U-Net at batch 2, window layout: the weights, the full
    pass and, per edit, the sparse outputs with chains on and off."""

    def __init__(self):
        rng = np.random.default_rng(2)
        self.x0 = rng.standard_normal((2, H, H, 4)).astype(np.float32)
        self.t = np.full((2,), 3.0, np.float32)
        self.c = rng.standard_normal((2, 7, 16)).astype(np.float32)
        self.noise = rng.standard_normal(self.x0.shape).astype(np.float32)
        self.args0 = (self.x0, self.t, self.c)
        params = flax_params(JUNet(cfg=JConfig(**TINY_UNET)), *self.args0)
        self.sd = state_dict_from_flax(params)
        self.jm = JModel(JUNet(cfg=JConfig(**TINY_UNET)), params,
                         layout="window")
        self.j_full = np.asarray(self.jm.full(*_j(self.args0)))

    @functools.lru_cache(maxsize=None)
    def edit(self, name):
        """(masks, edited input, {chain: sparse output}, {chain: model})."""
        mask = box_mask((H, H), EDITS[name])
        x1 = (self.x0 + self.noise * mask[None, :, :, None]).astype(
            np.float32)
        masks = downsample_mask(dilate_mask(mask, 1), min_res=4)
        sparse, models = {}, {}
        for chain in (True, False):
            m = JModel(JUNet(cfg=JConfig(**TINY_UNET, window_chain=chain)),
                       self.jm.params, layout="window")
            m.cache, m.meta = self.jm.cache, self.jm.meta
            m.set_masks(masks)
            sparse[chain] = np.asarray(m.sparse(*_j((x1, self.t, self.c))))
            models[chain] = m
        return masks, x1, sparse, models

    @functools.cached_property
    def j_dense(self):
        """sige_tpu's dense pass on the "window" edit's input."""
        jm = self.edit("window")[3][True]
        return np.asarray(jax.jit(lambda p, *a: jm.module.apply(
            {"params": p}, *a, ctx=JCtx(mode="dense")))(
            jm.params, *_j((self.edit("window")[1], self.t, self.c))))


@functools.lru_cache(maxsize=None)
def _reference():
    return Reference()


class Pair:
    """The first ``B`` rows of the reference's inputs and outputs for one
    edit, and the port's U-Net with the same weights."""

    def __init__(self, B, edit):
        ref = _reference()
        self.masks, x1, sparse, self.j_models = ref.edit(edit)
        self.B, self.sd = B, ref.sd
        self.args0 = tuple(a[:B] for a in ref.args0)
        self.args1 = (x1[:B], ref.t[:B], ref.c[:B])
        self.j_full = ref.j_full[:B]
        self.j_sparse = {k: v[:B] for k, v in sparse.items()}

    def torch_model(self, chain=True, **kw):
        tm = SIGEModel(SIGESDUNet(SDUNetConfig(**TINY_UNET,
                                               window_chain=chain, **kw)),
                       layout="window", device="cpu")
        tm.module.load_state_dict(self.sd, strict=True)
        return tm

    def primed(self, chain=True):
        tm = self.torch_model(chain)
        full = tm.full(*map(_t, self.args0)).numpy()
        tm.set_masks(self.masks)
        return tm, full


@functools.lru_cache(maxsize=None)
def _pair(B, edit="window"):
    return Pair(B, edit)


@pytest.fixture(scope="module", params=[1, 2], ids=["B1", "B2"])
def pair(request):
    return _pair(request.param)


def test_flax_tree_loads_strictly():
    """Every flax leaf maps onto a port parameter and none is left over
    (LayerNorm scales, the GEGLU ``proj``, bias-free Dense layers)."""
    p = _pair(1)
    module = SIGESDUNet(SDUNetConfig(**TINY_UNET))
    assert set(module.state_dict()) == set(p.sd)
    module.load_state_dict(p.sd, strict=True)
    assert "in_blocks.0.1.blocks.0.ff.proj.weight" in p.sd
    assert "in_blocks.0.1.blocks.0.attn1.to_q.bias" not in p.sd


@pytest.mark.parametrize("chain", [True, False])
def test_forwards_match_sige_tpu(pair, chain):
    tm, full = pair.primed(chain)
    np.testing.assert_allclose(full, pair.j_full, atol=ATOL, rtol=0)
    assert all("win_in" in g for g in gather_plans(tm.plan_host))
    sparse = tm.sparse(*map(_t, pair.args1)).numpy()
    np.testing.assert_allclose(sparse, pair.j_sparse[chain], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("chain", [True, False])
def test_sparse_on_original_equals_full_also_after_an_edit(pair, chain):
    tm, full = pair.primed(chain)
    before = tm.sparse(*map(_t, pair.args0)).numpy()
    np.testing.assert_allclose(before, full, atol=ATOL, rtol=0)
    edited = tm.sparse(*map(_t, pair.args1)).numpy()
    assert np.abs(edited - full).max() > 1e-2
    after = tm.sparse(*map(_t, pair.args0)).numpy()
    np.testing.assert_allclose(after, full, atol=ATOL, rtol=0)


def test_dense_matches_sige_tpu(pair):
    tm = pair.torch_model()
    want = _reference().j_dense[:pair.B]
    np.testing.assert_allclose(tm.dense(*map(_t, pair.args1)).numpy(),
                               want, atol=ATOL, rtol=0)


def test_transformers_run_masked_stale_kv(pair, monkeypatch):
    """With window_chain every sparse transformer takes the masked
    stale-K/V path and hands on a window state."""
    outs = []
    orig = sd_unet.SIGESpatialTransformer._chain_window

    def spy(self, *a):
        out = orig(self, *a)
        outs.append(out)
        return out

    monkeypatch.setattr(sd_unet.SIGESpatialTransformer, "_chain_window", spy)
    tm, _ = pair.primed(True)
    tm.sparse(*map(_t, pair.args1))
    n_sparse = sum(isinstance(m, sd_unet.SIGESpatialTransformer)
                   and m.sparse_ok for m in tm.module.modules())
    assert len(outs) == n_sparse > 0
    assert all(isinstance(o, WindowState) for o in outs)


@pytest.mark.parametrize("chain", [True, False])
def test_mixed_window_and_tile_plan(chain):
    p = _pair(2, "mixed")
    tm, full = p.primed(chain)
    entries = list(gather_plans(tm.plan_host))
    assert any("win_in" in g for g in entries)
    assert any(k.startswith("srcbox_") for g in entries for k in g)
    np.testing.assert_allclose(full, p.j_full, atol=ATOL, rtol=0)
    sparse = tm.sparse(*map(_t, p.args1)).numpy()
    np.testing.assert_allclose(sparse, p.j_sparse[chain], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.sparse(*map(_t, p.args0)).numpy(), full,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["full", "sparse"])
def test_macs_match_sige_tpu(mode):
    p = _pair(2)
    tm, _ = p.primed(True)
    ctx = SIGECtx(mode=mode, macs=[])
    with torch.inference_mode():
        tm.module(*map(_t, p.args1), ctx=ctx)
    jm = p.j_models[True]
    want = traced_macs(jm.module, {"params": jm.params, "cache": jm.cache,
                                   "sige": jm.plan},
                       *_j(p.args1), ctx=JCtx(mode=mode))
    assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


def test_timestep_embedding_matches_sige_tpu():
    t = np.array([0.0, 1.0, 37.0, 981.0], np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            sd_unet.sd_timestep_embedding(_t(t), dim).numpy(),
            np.asarray(j_embedding(jnp.asarray(t), dim)), atol=ATOL, rtol=0)


def test_later_options_raise():
    """Cache slots, once left for a later slice, run on the SD U-Net: a
    full pass fills its own slot only, the text K/V caches included
    (tests/test_torch_slots.py holds slots and sparse_update to
    sige_tpu)."""
    model = SIGEModel(SIGESDUNet(SDUNetConfig(**TINY_UNET, cache_slots=2)),
                      device="cpu")
    assert model.cache_slots == 2
    model.init(seed=0)
    rng = np.random.default_rng(4)
    model.full(_t(rng.standard_normal((1, H, H, 4)).astype(np.float32)),
               _t(np.full((1,), 3.0, np.float32)),
               _t(rng.standard_normal((1, 7, 16)).astype(np.float32)),
               cache_id=1)
    assert not model.state.tensors(0)
    names = {k for slots in model.state.caches.values() for k in slots[1]}
    assert {"original", "k", "v", "scale", "shift"} <= names
