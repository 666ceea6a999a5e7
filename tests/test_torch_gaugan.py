"""The port's GauGAN (SPADE) path against sige_tpu's.

Configurations: ``tests/test_gaugan.py``'s ``TINY`` (ngf 8, 6 semantic
channels, 64x32 canvas, latent 1x2, five sparse blocks: the window chain
crosses four bare 2x upsamples on a non-square canvas) for the fused
and the sub-mobile generator, and ``tests/test_gaugan_vanilla.py``'s
``CFG`` (ngf 4) for the vanilla one. Weights are seeded flax trees,
their BatchNorm running statistics drawn away from 0 and 1 so that the
fold shows, bridged with ``utils/from_jax.py``.

sige_tpu runs one full pass per tail setting (shared by every layout and
chain setting) and one sparse pass per variant. The port agrees with it
at atol 1e-4 (fp32 on both sides; sums reassociate): dense, full and
sparse forwards in the tile and window layouts with ``window_chain`` on
and off and ``sige_tail`` on and off, a border edit (4-form metas), the
sub-mobile generator in both layouts, the vanilla one dense; sparse on
the original equals full, also after a sparse call on the edit; the
window plans equal sige_tpu's key by key (``wup_ok`` included);
``nearest_resize`` and ``_seg_window`` equal sige_tpu's; MACs equal the
traced count; ``layout="auto"`` picks what sige_tpu picks; and
``GauGANRunner.generate`` agrees with sige_tpu's runner. The engine's
fp32 scope sets its cuDNN benchmark limit inside a forward and gives the
caller's value back, None included.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import downsample_mask
from sige_tpu.models.gaugan import SIGEFusedSPADEGenerator as JGen
from sige_tpu.models.gaugan import SIGESubMobileSPADEGenerator as JSubGen
from sige_tpu.models.gaugan import SPADEGenConfig as JConfig
from sige_tpu.models.gaugan import VanillaSPADEGenerator as JVanilla
from sige_tpu.models.gaugan import spade as jspade
from sige_tpu.models.gaugan import sub_mobile as jsub_mobile
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.runners.gaugan_runner import GauGANRunConfig as JRunConfig
from sige_tpu.runners.gaugan_runner import GauGANRunner as JRunner
from sige_tpu.utils import traced_macs
from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                      SIGESubMobileSPADEGenerator,
                                      SPADEGenConfig, VanillaSPADEGenerator,
                                      decode_config, spade)
from sige_torch.nn import SIGEModel
from sige_torch.nn.engine import (BENCHMARK_LIMIT, precision_flags,
                                  set_precision_flags)
from sige_torch.nn.module import SIGECtx, WindowState
from sige_torch.runners import GauGANRunConfig, GauGANRunner
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_pd import _flat
from test_torch_sd_unet import (ATOL, flax_params,  # noqa: F401
                                one_torch_thread)

# tests/test_gaugan.py
TINY = dict(ngf=8, semantic_nc=6, crop_size=64, aspect_ratio=2.0,
            num_upsampling_layers="normal", num_sparse_layers=5)
# tests/test_gaugan_vanilla.py
VANILLA = dict(ngf=4, semantic_nc=6, crop_size=64, aspect_ratio=2.0,
               num_upsampling_layers="normal", main_block_size=None,
               shortcut_block_size=None, num_sparse_layers=0)
SUB_CHANNELS = (4, 4, 4, 6, 4, 3, 3, 4)  # tests/test_gaugan.py
H, W = 32, 64
N_LABELS = TINY["semantic_nc"] - 1
EDITS = {"inner": (H // 4, H // 4 + 6, W // 4, W // 4 + 10),  # test_gaugan
         "border": (0, 5, W - 10, W)}                   # the top-right corner
VARIANTS = [("window", True), ("window", False), ("tiles", True)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _scramble_stats(params, seed=1):
    """BatchNorm running statistics away from flax's zeros and ones."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "running_mean":
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "running_var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, params)


def _sems(box):
    """(original, edited) one-hot + edge semantics [1, H, W, 6]: labels
    from default_rng(0), the edit a box of the last class but one."""
    rng = np.random.default_rng(0)
    l0 = rng.integers(0, N_LABELS - 1, (H, W))
    l1 = l0.copy()
    l1[box[0]:box[1], box[2]:box[3]] = N_LABELS - 2
    r = JRunner.__new__(JRunner)  # preprocess_input only
    r.run_cfg = JRunConfig(input_nc=N_LABELS)
    return r.preprocess_input(l0), r.preprocess_input(l1)


@functools.lru_cache(maxsize=None)
def _masks(box):
    """The runner's mask pyramid at downsample dilation 1 (as
    tests/test_gaugan.py plans the tiny model)."""
    from sige_tpu.core.masks import compute_difference_mask, dilate_mask

    s0, s1 = _sems(box)
    mask = dilate_mask(compute_difference_mask(s0[0], s1[0], eps=1e-3), 1)
    return downsample_mask(mask, min_res=JConfig(**TINY).latent_hw,
                           dilation=1)


@functools.lru_cache(maxsize=None)
def _params(kind):
    seg = _sems(EDITS["inner"])[0]
    module = {"fused": lambda: JGen(cfg=JConfig(**TINY)),
              "sub": lambda: JSubGen(cfg=JConfig(**TINY),
                                     channels=SUB_CHANNELS),
              "vanilla": lambda: JVanilla(cfg=JConfig(**VANILLA))}[kind]()
    if kind == "vanilla":
        shapes = jax.eval_shape(lambda: module.init(
            jax.random.key(0), jnp.asarray(seg)))["params"]
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s.shape)
                       / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1
                                 else 20.0)).astype(np.float32), shapes)
    else:
        params = flax_params(module, seg)
    params = _scramble_stats(params)
    return params, state_dict_from_flax(params)


class Reference:
    """sige_tpu's fused generator for one tail setting: the full pass on
    the original and, per (layout, chain, edit), the sparse pass on the
    edit."""

    def __init__(self, tail):
        self.kw = dict(TINY, sige_tail=tail)
        self.params, self.sd = _params("fused")
        self.s0 = _sems(EDITS["inner"])[0]
        self.jm = JModel(JGen(cfg=JConfig(**self.kw)), self.params,
                         layout="window", bucket_min=1)
        self.j_full = np.asarray(self.jm.full(jnp.asarray(self.s0)))

    @functools.lru_cache(maxsize=None)
    def sparse(self, layout, chain, edit):
        """(sparse output on the edit, host plan, model) of sige_tpu."""
        m = JModel(JGen(cfg=JConfig(**self.kw, window_chain=chain)),
                   self.params, layout=layout, bucket_min=1)
        m.cache, m.meta = self.jm.cache, self.jm.meta
        m.set_masks(_masks(EDITS[edit]))
        out = np.asarray(m.sparse(jnp.asarray(_sems(EDITS[edit])[1])))
        return out, jax.device_get(m.plan), m

    @property
    def j_dense(self):
        return _j_dense()

    def torch_model(self, layout, chain):
        tm = SIGEModel(SIGEFusedSPADEGenerator(SPADEGenConfig(
            **self.kw, window_chain=chain)), layout=layout, bucket_min=1,
            device="cpu")
        tm.module.load_state_dict(self.sd, strict=True)
        return tm


def _dense(module, params, x):
    """sige_tpu's dense forward, compiled (op-by-op dispatch of the flax
    apply takes several times as long)."""
    return jax.jit(lambda p, x: module.apply(
        {"params": p}, x, ctx=JCtx(mode="dense")))(params, jnp.asarray(x))


@functools.lru_cache(maxsize=None)
def _j_dense():
    """sige_tpu's dense forward on the edit (the tail setting does not
    change it)."""
    params, _ = _params("fused")
    return np.asarray(_dense(JGen(cfg=JConfig(**TINY)), params,
                             _sems(EDITS["inner"])[1]))


@functools.lru_cache(maxsize=None)
def _reference(tail):
    return Reference(tail)


@pytest.fixture(scope="module", params=[True, False],
                ids=["tail1", "tail0"])
def ref(request):
    return _reference(request.param)


def _check_variant(ref, layout, chain, edit="inner"):
    want, _, _ = ref.sparse(layout, chain, edit)
    s0, s1 = _sems(EDITS[edit])
    tm = ref.torch_model(layout, chain)
    full = tm.full(_t(s0)).numpy()
    np.testing.assert_allclose(full, ref.j_full, atol=ATOL, rtol=0)
    plan = tm.set_masks(_masks(EDITS[edit]))
    assert tm.active_layout == layout
    got = tm.sparse(_t(s1)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - full).max() > 1e-3  # the edit shows
    return tm, plan, full


def test_flax_trees_load_strictly():
    """Every flax leaf maps onto a port parameter or buffer, none is left
    over: BatchNorm running statistics (flax ``params``, torch buffers),
    depthwise kernels (HWIO with I = 1 -> OIHW [C, 1, kh, kw]) and the
    bias-free shortcut convs."""
    modules = {"fused": SIGEFusedSPADEGenerator(SPADEGenConfig(**TINY)),
               "sub": SIGESubMobileSPADEGenerator(SPADEGenConfig(**TINY),
                                                  SUB_CHANNELS),
               "vanilla": VanillaSPADEGenerator(SPADEGenConfig(**VANILLA))}
    for kind, module in modules.items():
        _, sd = _params(kind)
        assert set(module.state_dict()) == set(sd), kind
        module.load_state_dict(sd, strict=True)
    sd = _params("sub")[1]
    assert sd["head.0.norm.0.mlp_gamma.dw.weight"].shape == (8, 1, 3, 3)
    assert "up.0.conv_s.bias" not in sd
    assert sd["up.0.norm_s.running_var"].shape == (64,)


@pytest.mark.parametrize("layout,chain", VARIANTS,
                         ids=[f"{v[0]}-chain{int(v[1])}" for v in VARIANTS])
def test_forwards_match_sige_tpu(ref, layout, chain):
    tm, _, full = _check_variant(ref, layout, chain)
    np.testing.assert_allclose(tm.dense(_t(_sems(EDITS["inner"])[1])).numpy(),
                               ref.j_dense, atol=ATOL, rtol=0)
    # sparse on the original equals full, also after the edit's sparse
    # pass (a join that wrote into its cache would show there)
    np.testing.assert_allclose(tm.sparse(_t(_sems(EDITS["inner"])[0])).numpy(),
                               full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("chain", [True, False])
def test_border_edit_matches_sige_tpu(chain):
    """An edit at the corner: 4-form metas, the seg windows' too."""
    _, plan, _ = _check_variant(_reference(True), "window", chain, "border")
    metas = [v for k, v in _flat(plan, False).items() if k.endswith("win_in")]
    assert any(len(m) == 4 for m in metas)


def test_window_plans_match_sige_tpu_key_by_key():
    ref = _reference(True)
    _, want, _ = ref.sparse("window", True, "inner")
    tm = ref.torch_model("window", True)
    tm.full(_t(ref.s0))
    got = _flat(tm.set_masks(_masks(EDITS["inner"])), False)
    want = _flat(want, True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k
    # the chain crosses the bare upsamples into up.1-3 (and the tail's
    # gather has the marker too); up.0's input comes from G_middle.1,
    # whose 2x4 map runs tiles
    assert {k.rsplit("/", 1)[0] for k in got if k.endswith("wup_ok")} == {
        f"up/{i}/{g}" for i in (1, 2, 3) for g in (
            "main_gather", "seg_gather", "shortcut_gather",
            "norm_s_regather")} | {"out_gather"}


def test_chain_crosses_the_upsamples(monkeypatch):
    """With window_chain the blocks' chain path runs for every block whose
    gather is windowed and, where the planner nested the windows across
    the upsample (``wup_ok``), from the carried doubled window; each hands
    on a window state."""
    seen = []
    orig = spade.SIGEFusedSPADEResnetBlock._chain_window

    def spy(self, x, seg, ctx):
        out = orig(self, x, seg, ctx)
        seen.append((self, type(x).__name__, out))
        return out

    monkeypatch.setattr(spade.SIGEFusedSPADEResnetBlock, "_chain_window", spy)
    ref = _reference(True)
    tm = ref.torch_model("window", True)
    tm.full(_t(ref.s0))
    tm.set_masks(_masks(EDITS["inner"]))
    tm.sparse(_t(_sems(EDITS["inner"])[1]))
    names = {m: n for n, m in tm.module.named_modules()}
    # G_middle.1's 2x4 map runs tiles (a window would cover more than the
    # planner's max_cover of it), so the chain starts at up.0
    assert [(names[b], kind) for b, kind, _ in seen] == [
        ("up.0", "Tensor"), ("up.1", "_Up2State"), ("up.2", "_Up2State"),
        ("up.3", "_Up2State")]
    assert all(isinstance(o, WindowState) for _, _, o in seen)


def test_sparse_on_original_equals_full_after_an_edit_tiles_no_tail():
    ref = _reference(False)
    tm = ref.torch_model("tiles", True)
    full = tm.full(_t(ref.s0)).numpy()
    tm.set_masks(_masks(EDITS["inner"]))
    tm.sparse(_t(_sems(EDITS["inner"])[1]))
    np.testing.assert_allclose(tm.sparse(_t(ref.s0)).numpy(), full,
                               atol=ATOL, rtol=0)


def _exact_instance_norm(x, weight=None, bias=None, eps=1e-5):
    """sige_tpu's ``instance_norm_with_affine`` (no weight or bias, as the
    separable convs call it) with its statistics in the input's dtype
    instead of float32."""
    mean = jnp.mean(x, axis=(1, 2), keepdims=True)
    std = jnp.sqrt(jnp.mean(jnp.square(x - mean), axis=(1, 2),
                            keepdims=True) + eps)
    return (x - mean) / std, (1.0 / std)[:, 0, 0], (-mean / std)[:, 0, 0]


def _exact_sige_tpu():
    """float64 and exact InstanceNorm statistics for sige_tpu's sub-mobile
    generator while the context is active."""
    scope = contextlib.ExitStack()
    scope.enter_context(jax.enable_x64(True))
    scope.enter_context(mock.patch.object(
        jsub_mobile, "instance_norm_with_affine", _exact_instance_norm))
    return scope


@functools.lru_cache(maxsize=None)
def _sub_reference(layout):
    """(full on the original, sparse on the edit, dense on the edit,
    model) of sige_tpu's sub-mobile generator in float64 with exact
    InstanceNorm statistics (dense for the window layout only: it does
    not depend on the layout).

    sige_tpu computes the statistics in float32, and on this configuration
    its float32 forward misses the float64 one by ~4.6e-4 (XLA's CPU
    reductions; the port's float32 forward misses it by ~2e-5): here
    sige_tpu is not the truth at 1e-4, so the port is held to the stated
    contract, 1e-4 against the exact function, which is sige_tpu's in
    float64."""
    params, _ = _params("sub")
    with _exact_sige_tpu():
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)
        s0, s1 = (jnp.asarray(s, jnp.float64) for s in _sems(EDITS["inner"]))
        jm = JModel(JSubGen(cfg=JConfig(**TINY), channels=SUB_CHANNELS), p64,
                    layout=layout, bucket_min=1)
        full = np.asarray(jm.full(s0))
        jm.set_masks(_masks(EDITS["inner"]))
        sparse = np.asarray(jm.sparse(s1))
        dense = (np.asarray(_dense(jm.module, p64, s1))
                 if layout == "window" else None)
    return full, sparse, dense, jm


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_sub_mobile_matches_sige_tpu(layout):
    """GAN-Compression sub-mobile: separable convs (depthwise, groups =
    C) with the InstanceNorm fold cached in full mode and replayed in
    sparse mode; full, sparse and dense against sige_tpu's function (see
    :func:`_sub_reference`), sparse on the original equal to full."""
    _, sd = _params("sub")
    s0, s1 = _sems(EDITS["inner"])
    want_full, want_sparse, _, _ = _sub_reference(layout)
    want_dense = _sub_reference("window")[2]
    tm = SIGEModel(SIGESubMobileSPADEGenerator(SPADEGenConfig(**TINY),
                                               SUB_CHANNELS),
                   layout=layout, bucket_min=1, device="cpu")
    tm.module.load_state_dict(sd, strict=True)
    full = tm.full(_t(s0)).numpy()
    np.testing.assert_allclose(full, want_full, atol=ATOL, rtol=0)
    tm.set_masks(_masks(EDITS["inner"]))
    assert tm.active_layout == layout
    np.testing.assert_allclose(tm.sparse(_t(s1)).numpy(), want_sparse,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.sparse(_t(s0)).numpy(), full, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tm.dense(_t(s1)).numpy(), want_dense,
                               atol=ATOL, rtol=0)


def test_sub_mobile_most_raises_and_config_decodes():
    with pytest.raises(NotImplementedError, match="most"):
        SIGESubMobileSPADEGenerator(SPADEGenConfig(
            **dict(TINY, num_upsampling_layers="most")))
    assert decode_config("32_32_32_48_32_24_24_32") == [32, 32, 32, 48, 32,
                                                         24, 24, 32]


def test_vanilla_dense_matches_sige_tpu():
    params, sd = _params("vanilla")
    seg = _sems(EDITS["inner"])[1]
    module = JVanilla(cfg=JConfig(**VANILLA))
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, jnp.asarray(seg)))
    module = VanillaSPADEGenerator(SPADEGenConfig(**VANILLA))
    module.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = module(_t(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_nearest_resize_and_seg_window_match_sige_tpu():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 12, 20, 3)).astype(np.float32)
    for out in ((3, 5), (4, 10), (12, 20), (5, 7), (24, 40), (7, 13)):
        np.testing.assert_array_equal(
            spade.nearest_resize(_t(x), out).numpy(),
            np.asarray(jspade.nearest_resize(jnp.asarray(x), out)))
    # every seg gather's window in the inner (2-form) and border (4-form)
    # plans, off the full-resolution seg map
    ref = _reference(True)
    forms = set()
    for edit in ("inner", "border"):
        _, plan, _ = ref.sparse("window", True, edit)
        seg = _sems(EDITS[edit])[1]
        flat = _flat(plan, True)
        for key in (k for k in flat if k.endswith("seg_gather/win_in")):
            base = key.rsplit("/", 1)[0]
            meta, edge = flat[key], flat[base + "/win_edge"]
            # the block's resolution: the seg map over 2^(levels above it)
            res = next(tuple(map(int, k.rsplit("_", 1)[1].split("x")))
                       for k in flat if k.startswith(base + "/wsc_org_"))
            want = jax.jit(jspade._seg_window, static_argnums=1)(
                jnp.asarray(seg), res, jnp.asarray(meta), jnp.asarray(edge))
            # as a one-session plan holds them: [1, k] and [1, EH, EW]
            got = spade._seg_window(_t(seg), res,
                                    _t(meta).to(torch.int64)[None],
                                    _t(edge)[None])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            forms.add(len(meta))
    assert forms == {2, 4}


@pytest.mark.parametrize("case", ["sub-dense", "sub-sparse-tiles",
                                  "fused-sparse-window"])
def test_macs_match_sige_tpu(case):
    """Depthwise convs count C_in / groups per output element, as
    sige_tpu's traced count does: the sub-mobile generator dense and
    sparse in tiles; the fused one sparse in the window layout."""
    s0, s1 = _sems(EDITS["inner"])
    kind, mode, layout = case.split("-", 2) + ["window"] * (case.count("-")
                                                             == 1)
    if kind == "fused":
        ref = _reference(True)
        _, _, jm = ref.sparse("window", True, "inner")
        tm = ref.torch_model("window", True)
        variables = {"params": jm.params, "cache": jm.cache, "sige": jm.plan}
        jmodule = jm.module
    else:
        params, sd = _params("sub")
        jmodule = JSubGen(cfg=JConfig(**TINY), channels=SUB_CHANNELS)
        variables = {"params": params}
        if mode == "sparse":  # the plan and caches of the float64 model
            jm = _sub_reference(layout)[3]
            variables = {"params": jm.params, "cache": jm.cache,
                         "sige": jm.plan}
            s1 = s1.astype(np.float64)
        tm = SIGEModel(SIGESubMobileSPADEGenerator(SPADEGenConfig(**TINY),
                                                   SUB_CHANNELS),
                       layout=layout, bucket_min=1, device="cpu")
        tm.module.load_state_dict(sd, strict=True)
    tm.full(_t(s0))
    tm.set_masks(_masks(EDITS["inner"]))
    ctx = SIGECtx(mode=mode, macs=[])
    with torch.inference_mode():
        tm.module(_t(s1.astype(np.float32)), ctx=ctx)
    with _exact_sige_tpu() if s1.dtype == np.float64 else (
            contextlib.nullcontext()):
        want = traced_macs(jmodule, variables, jnp.asarray(s1),
                           ctx=JCtx(mode=mode))
    assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


def test_full_config_dense_macs():
    """The full Cityscapes generator (SPADEGenConfig(): 93.07 M parameters
    and running statistics) counts 281.3 dense GMACs, sige_tpu's README
    count, and the sub-mobile one (20.19 M) fewer; counted on the meta
    device."""
    seg = torch.zeros((1, 256, 512, 36), device="meta")
    counts = {}
    for name, make in (("fused", SIGEFusedSPADEGenerator),
                       ("sub", SIGESubMobileSPADEGenerator)):
        with torch.device("meta"):
            module = make(SPADEGenConfig())
        size = sum(t.numel() for t in module.state_dict().values())
        ctx = SIGECtx(mode="dense", macs=[])
        module(seg, ctx=ctx)
        counts[name] = (size / 1e6, sum(ctx.macs) / 1e9)
    assert round(counts["fused"][0], 2) == 93.07
    assert round(counts["sub"][0], 2) == 20.19
    assert round(counts["fused"][1], 1) == 281.3
    assert counts["sub"][1] < counts["fused"][1] / 5


def test_auto_picks_what_sige_tpu_picks():
    ref = _reference(True)
    jm = JModel(ref.jm.module, ref.params, layout="auto", bucket_min=1)
    jm.meta = ref.jm.meta
    tm = ref.torch_model("auto", True)
    full = tm.full(_t(ref.s0)).numpy()
    scattered = np.zeros((H, W), bool)
    scattered[1:4, 1:4] = scattered[28:31, 58:62] = True
    picked = []
    for mask in (_masks(EDITS["inner"]),
                 downsample_mask(scattered, min_res=(1, 2), dilation=1)):
        jm.set_masks(mask)
        tm.set_masks(mask)
        assert tm.active_layout == jm.active_layout
        picked.append(tm.active_layout)
        np.testing.assert_allclose(tm.sparse(_t(ref.s0)).numpy(), full,
                                   atol=ATOL, rtol=0)
    assert picked == ["window", "tiles"]


def _runner_labels():
    rng = np.random.default_rng(1)
    l0 = rng.integers(0, N_LABELS - 1, (H, W))
    l1 = l0.copy()
    l1[10:17, 20:31] = N_LABELS - 2
    return l0, l1


def test_generate_through_runner_matches_sige_tpu():
    """GauGANRunner (preprocess_input with instance edges, the difference
    mask, planning under layout="auto", one sparse pass) against
    sige_tpu's runner on the CPU."""
    params, sd = _params("fused")
    kw = dict(input_nc=N_LABELS, mask_dilate_radius=1,
              downsample_dilate_radius=1)
    jr = JRunner(JConfig(**TINY), JRunConfig(**kw), params=params,
                 bucket_min=1)
    tr = GauGANRunner(SPADEGenConfig(**TINY), GauGANRunConfig(**kw),
                      params=sd, bucket_min=1, device="cpu")
    assert tr.model.layout == jr.model.layout == "auto"
    l0, l1 = _runner_labels()
    s0, s1 = tr.preprocess_input(l0), tr.preprocess_input(l1)
    np.testing.assert_array_equal(s1, jr.preprocess_input(l1))
    got = tr.generate(s0, s1)
    want = jr.generate(s0, s1)
    assert tr.active_layout == jr.model.active_layout == "window"
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert tr.last_edit_ratio == jr.last_edit_ratio


def test_runner_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GauGANRunner(SPADEGenConfig(**TINY))


@pytest.mark.parametrize("caller_limit", [None, 7])
def test_fp32_scope_sets_the_benchmark_limit_and_restores_it(caller_limit):
    """Inside a forward cuDNN's benchmark limit is the engine's; after it
    the caller's value is back, None (a torch without cuDNN) included."""
    before = precision_flags()
    inside = []
    try:
        torch.backends.cudnn.benchmark_limit = caller_limit
        flags = precision_flags()
        tm = _reference(True).torch_model("window", True)
        tm.module.register_forward_pre_hook(
            lambda mod, args: inside.append(precision_flags()))
        x = _t(np.zeros((1, H, W, TINY["semantic_nc"]), np.float32))
        tm.dense(x)
        assert torch.backends.cudnn.benchmark_limit == caller_limit
        tm.full(x)
        assert precision_flags() == flags
    finally:
        set_precision_flags(before)
    assert inside == [("ieee", "ieee", True, BENCHMARK_LIMIT)] * 2
    assert precision_flags() == before
