"""The port's Progressive Distillation path against sige_tpu's.

Two tiny configurations: ``tiny`` is ``tests/test_pd.py``'s ``TINY`` (two
levels; the window chain crosses the up-resampling resblock at 16 px,
and the middle attention runs 4 heads at 16 px); ``attn`` adds a third
level and attention at 8 and 16 px (4 heads of 16), so chains break at
the attention blocks. Weights are one seeded flax tree per configuration
(``sige_tail`` adds no parameters), bridged with ``utils/from_jax.py``.

sige_tpu runs one full pass per configuration and tail setting, shared by
every layout and chain setting, and one sparse pass per variant. The port
agrees with it at atol 1e-4 (fp32 on both sides; sums reassociate) in
the dense, full and sparse forwards, in the tile layout and in the window
layout with ``window_chain`` on and off; its window plans (the pre-pool
``wdnp_in`` / ``wdnp_edge`` records of the down-resampling blocks
included) equal sige_tpu's key by key; sparse on the original input
equals full, also after a sparse call on the edit; ``layout="auto"``
picks what sige_tpu picks; the folded norm's scale-shift terms equal
sige_tpu's; and a 5-step twin trajectory through ``PDRunner`` agrees
with ``sige_tpu``'s ``sample_sige`` on the same noise. The engine's
fp32 scope is checked here too: inside a forward cuDNN and matmuls run
fp32 in benchmark mode, and the caller's settings come back after it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.ddpm.unet import _FoldedGroupNorm as JFoldedGroupNorm
from sige_tpu.models.pd import PDUNetConfig as JConfig
from sige_tpu.models.pd import SIGEPDUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.runners.pd_runner import PDRunConfig as JRunConfig
from sige_tpu.runners.pd_runner import PDRunner as JRunner
from sige_tpu.samplers import PDSampler as JSampler
from sige_tpu.samplers import get_sampling_sequence
from sige_tpu.samplers import logsnr_schedule as j_logsnr_schedule
from sige_tpu.utils import traced_macs
from sige_torch.models import blocks
from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.engine import (BENCHMARK_LIMIT, precision_flags,
                                  set_precision_flags)
from sige_torch.nn.module import SIGECtx, WindowState
from sige_torch.runners import PDRunConfig, PDRunner
from sige_torch.samplers import PDSampler, logsnr_schedule
from sige_torch.utils.from_jax import state_dict_from_flax, torch_path
from test_torch_sd_unet import (ATOL, box_mask, flax_params,  # noqa: F401
                                one_torch_thread)

R = 32
CONFIGS = {
    # tests/test_pd.py TINY
    "tiny": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 attn_resolutions=(8,), resolution=R, temb_ch=64,
                 head_dim=16, sparse_resolution_threshold=16),
    "attn": dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                 attn_resolutions=(8, 16), resolution=R, temb_ch=64,
                 head_dim=16, sparse_resolution_threshold=16),
}
CASES = [("tiny", True), ("tiny", False), ("attn", True)]  # (config, tail)
VARIANTS = [("window", True), ("window", False), ("tiles", True)]
EDIT = (8, 16, 10, 20)      # tests/test_pd.py
BORDER = (0, 7, 26, 32)     # the top-right corner: 4-form window metas
LOGSNR = np.array([1.3], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks(box):
    return downsample_mask(dilate_mask(box_mask((R, R), box), 2), min_res=4)


def _flat(plan, torch_names):
    """{path: leaf} of a plan tree, paths in the port's module names."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            p = path + (torch_path((k,)) if torch_names else (k,))
            if hasattr(v, "items"):
                walk(v, p)
            else:
                out["/".join(p)] = np.asarray(v)

    walk(plan, ())
    return out


@functools.lru_cache(maxsize=None)
def _params(name):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
    params = flax_params(JUNet(cfg=JConfig(**CONFIGS[name])), x0, LOGSNR)
    module = JUNet(cfg=JConfig(**CONFIGS[name]))
    dense = jax.jit(lambda p, x, ls: module.apply(
        {"params": p}, x, ls, ctx=JCtx(mode="dense")))
    return params, state_dict_from_flax(params), x0, np.asarray(
        dense(params, jnp.asarray(x0), jnp.asarray(LOGSNR)))


class Reference:
    """sige_tpu's PD U-Net for one (config, tail) case: the full pass on
    x0 and, per (layout, chain, edit), the sparse pass on the edit."""

    def __init__(self, name, tail):
        self.name, self.tail = name, tail
        self.params, self.sd, self.x0, self.j_dense = _params(name)
        rng = np.random.default_rng(1)
        self.noise = rng.standard_normal(self.x0.shape).astype(np.float32)
        self.kw = dict(CONFIGS[name], sige_tail=tail)
        self.jm = JModel(JUNet(cfg=JConfig(**self.kw)), self.params,
                         layout="window", bucket_min=1)
        self.j_full = np.asarray(self.jm.full(jnp.asarray(self.x0),
                                              jnp.asarray(LOGSNR)))

    def edited(self, box):
        m = box_mask((R, R), box)[None, :, :, None]
        return (self.x0 + 0.5 * self.noise * m).astype(np.float32)

    @functools.lru_cache(maxsize=None)
    def sparse(self, layout, chain, box):
        """(sparse output, host plan, model) of sige_tpu for one variant
        (cached: every caller passes all three arguments)."""
        m = JModel(JUNet(cfg=JConfig(**self.kw, window_chain=chain)),
                   self.params, layout=layout, bucket_min=1)
        m.cache, m.meta = self.jm.cache, self.jm.meta
        m.set_masks(_masks(box))
        out = np.asarray(m.sparse(jnp.asarray(self.edited(box)),
                                  jnp.asarray(LOGSNR)))
        return out, jax.device_get(m.plan), m

    def torch_model(self, layout, chain):
        tm = SIGEModel(SIGEPDUNet(PDUNetConfig(**self.kw,
                                               window_chain=chain)),
                       layout=layout, bucket_min=1, device="cpu")
        tm.module.load_state_dict(self.sd, strict=True)
        return tm


@functools.lru_cache(maxsize=None)
def _reference(name, tail):
    return Reference(name, tail)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-tail{int(c[1])}")
def ref(request):
    return _reference(*request.param)


def _check_variant(ref, layout, chain, box=EDIT):
    want, _, _ = ref.sparse(layout, chain, box)
    tm = ref.torch_model(layout, chain)
    full = tm.full(_t(ref.x0), _t(LOGSNR)).numpy()
    np.testing.assert_allclose(full, ref.j_full, atol=ATOL, rtol=0)
    plan = tm.set_masks(_masks(box))
    assert tm.active_layout == layout
    got = tm.sparse(_t(ref.edited(box)), _t(LOGSNR)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return tm, plan, full


@pytest.mark.parametrize("layout,chain", VARIANTS,
                         ids=[f"{v[0]}-chain{int(v[1])}" for v in VARIANTS])
def test_forwards_match_sige_tpu(ref, layout, chain):
    tm, _, full = _check_variant(ref, layout, chain)
    np.testing.assert_allclose(tm.dense(_t(ref.x0), _t(LOGSNR)).numpy(),
                               ref.j_dense, atol=ATOL, rtol=0)
    # sparse on the original equals full, also after the edit's sparse
    # pass (a join that wrote into its cache would show there)
    np.testing.assert_allclose(tm.sparse(_t(ref.x0), _t(LOGSNR)).numpy(),
                               full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("chain", [True, False])
def test_border_edit_matches_sige_tpu(chain):
    """An edit at the corner: 4-form metas, also the doubled pre-pool
    windows'."""
    ref = _reference("tiny", True)
    _, plan, full = _check_variant(ref, "window", chain, BORDER)
    assert any(len(v) == 4 for k, v in _flat(plan, False).items()
               if k.endswith("wdnp_in"))


def test_window_plans_match_sige_tpu_key_by_key(ref):
    _, want, _ = ref.sparse("window", True, EDIT)
    tm = ref.torch_model("window", True)
    tm.full(_t(ref.x0), _t(LOGSNR))
    got = _flat(tm.set_masks(_masks(EDIT)), False)
    want = _flat(want, True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k
    nres = len(CONFIGS[ref.name]["ch_mult"])
    assert {k.rsplit("/", 2)[0] for k in got if "wdnp" in k} == {
        f"downsamples/{i}" for i in range(nres - 1)}


def test_sparse_on_original_equals_full_after_an_edit(ref):
    tm = ref.torch_model("window", True)
    full = tm.full(_t(ref.x0), _t(LOGSNR)).numpy()
    tm.set_masks(_masks(EDIT))
    edited = tm.sparse(_t(ref.edited(EDIT)), _t(LOGSNR)).numpy()
    assert np.abs(edited - full).max() > 1e-3
    np.testing.assert_allclose(tm.sparse(_t(ref.x0), _t(LOGSNR)).numpy(),
                               full, atol=ATOL, rtol=0)


def test_chain_crosses_the_resampling_blocks(monkeypatch):
    """With window_chain the resblocks' chain path runs, across the
    down-resampling block (pre-pool products) and the up-resampling one
    (doubled carried window), and hands on window states."""
    seen = []
    orig = blocks.ResBlock._chain_window

    def spy(self, x, ctx):
        out = orig(self, x, ctx)
        seen.append((self.resample, out))
        return out

    monkeypatch.setattr(blocks.ResBlock, "_chain_window", spy)
    ref = _reference("tiny", True)
    tm = ref.torch_model("window", True)
    tm.full(_t(ref.x0), _t(LOGSNR))
    tm.set_masks(_masks(EDIT))
    tm.sparse(_t(ref.edited(EDIT)), _t(LOGSNR))
    assert {r for r, _ in seen} == {None, "down", "up"}
    assert all(isinstance(o, WindowState) for _, o in seen)


def test_macs_match_sige_tpu():
    ref = _reference("attn", True)
    _, _, jm = ref.sparse("window", True, EDIT)
    tm = ref.torch_model("window", True)
    tm.full(_t(ref.x0), _t(LOGSNR))
    tm.set_masks(_masks(EDIT))
    ctx = SIGECtx(mode="sparse", macs=[])
    with torch.inference_mode():
        tm.module(_t(ref.edited(EDIT)), _t(LOGSNR), ctx=ctx)
    want = traced_macs(jm.module, {"params": jm.params, "cache": jm.cache,
                                   "sige": jm.plan},
                       jnp.asarray(ref.edited(EDIT)), jnp.asarray(LOGSNR),
                       ctx=JCtx(mode="sparse"))
    assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


def test_auto_picks_what_sige_tpu_picks():
    ref = _reference("tiny", True)
    jm = JModel(ref.jm.module, ref.params, layout="auto", bucket_min=1)
    jm.meta = ref.jm.meta
    tm = ref.torch_model("auto", True)
    full = tm.full(_t(ref.x0), _t(LOGSNR)).numpy()
    scattered = box_mask((R, R), (2, 6, 2, 6)) | box_mask((R, R),
                                                         (26, 30, 26, 30))
    picked = []
    for mask in (box_mask((R, R), (10, 18, 12, 20)), scattered):
        masks = downsample_mask(dilate_mask(mask, 1), min_res=4)
        jm.set_masks(masks)
        tm.set_masks(masks)
        assert tm.active_layout == jm.active_layout
        picked.append(tm.active_layout)
        np.testing.assert_allclose(tm.sparse(_t(ref.x0), _t(LOGSNR)).numpy(),
                                   full, atol=ATOL, rtol=0)
    assert picked == ["window", "tiles"]


def test_folded_norm_scale_shift_fold_matches_sige_tpu():
    """PD's ``h * (1 + s) + b`` after norm2, folded into the cached
    affine, with DDPM's pre-shift beside it, against _FoldedGroupNorm."""
    rng = np.random.default_rng(5)
    C, G = 16, 4
    x = rng.standard_normal((2, 6, 5, C)).astype(np.float32)
    w, b = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    pre, ps, pb = (rng.standard_normal((2, C)).astype(np.float32)
                   for _ in range(3))
    for kw in (dict(post_scale=ps, post_shift=pb),
               dict(pre_shift=pre, post_scale=ps, post_shift=pb)):
        jn = JFoldedGroupNorm(channels=C, num_groups=G)
        (jxn, _, _), mut = jn.apply(
            {"params": {"scale": w, "bias": b}}, jnp.asarray(x),
            JCtx(mode="full"), mutable=["cache"],
            **{k: jnp.asarray(v) for k, v in kw.items()})
        tn = blocks.FoldedGroupNorm(C, G)
        tn.load_state_dict({"weight": _t(w), "bias": _t(b)})
        txn, _, _ = tn(_t(x), SIGECtx(mode="full"),
                       **{k: _t(v) for k, v in kw.items()})
        np.testing.assert_allclose(txn.detach().numpy(), np.asarray(jxn),
                                   atol=1e-5, rtol=0)
        _, sc, sh = tn(None, SIGECtx(mode="sparse"))
        cache = jax.device_get(mut["cache"])
        np.testing.assert_allclose(sc.detach().numpy(),
                                   np.asarray(cache["scale"])[0], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(sh.detach().numpy(),
                                   np.asarray(cache["shift"])[0], atol=1e-5,
                                   rtol=0)


def test_schedule_and_prediction_match_sige_tpu():
    u = np.linspace(1e-4, 1 - 1e-4, 16)
    np.testing.assert_allclose(logsnr_schedule(u).numpy(),
                               np.asarray(j_logsnr_schedule(u)), atol=1e-4,
                               rtol=1e-6)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    out = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    for t in range(5):
        ls = PDSampler(8).logsnr(t)
        got = PDSampler._predict(_t(z), _t(out), ls)
        want = JSampler._predict(jnp.asarray(z), jnp.asarray(out),
                                 j_logsnr_schedule((t + 1) / 8))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)


def _runner_images():
    rng = np.random.default_rng(0)
    original = rng.random((R, R, 3)).astype(np.float32)
    edited = original.copy()
    edited[10:16, 12:19] = rng.random((6, 7, 3))
    return original, edited


def test_twin_trajectory_through_runner_matches_sige_tpu():
    """PDRunner's preprocess (mask, planning, layout="auto") and a 5-step
    PDSampler trajectory (noise level 5 of 8), against sige_tpu's on the
    same noise."""
    params, sd, _, _ = _params("tiny")
    jr = JRunner(JConfig(**CONFIGS["tiny"]), JRunConfig(), params=params)
    tr = PDRunner(PDUNetConfig(**CONFIGS["tiny"]), PDRunConfig(), params=sd,
                  device="cpu")
    assert tr.model.layout == jr.model.layout == "auto"
    original, edited = _runner_images()
    jx0, jx1, mask = jr.preprocess(original, edited)
    tx0, tx1, tmask = tr.preprocess(original, edited)
    np.testing.assert_array_equal(tmask, mask)
    assert tr.active_layout == jr.model.active_layout == "window"

    e = np.random.default_rng(2).standard_normal((1, R, R, 3)).astype(
        np.float32)
    seq = get_sampling_sequence(5, 5)
    assert len(seq) == 5
    xts = jr.sampler.q_sample(jnp.concatenate([jx0, jx1]),
                              jnp.int32(seq[-1]),
                              jnp.asarray(np.concatenate([e, e])))
    txts = tr.sampler.q_sample(torch.cat([tx0, tx1]), int(seq[-1]),
                               _t(np.concatenate([e, e])))
    np.testing.assert_allclose(txts.numpy(), np.asarray(xts), atol=1e-6,
                               rtol=0)
    want, _ = jr.sampler.sample_sige(
        jr.module, jr.model.params, jr.model.plan, jr.model.cache, xts,
        jnp.asarray(seq), jnp.asarray(mask), jx0, jnp.asarray(e))
    got = tr.sampler.sample_sige(tr.model, txts, seq, _t(mask), tx0, _t(e))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= ATOL, err


def test_generate_on_cpu():
    _, sd, _, _ = _params("tiny")
    runner = PDRunner(PDUNetConfig(**CONFIGS["tiny"]), PDRunConfig(),
                      params=sd, device="cpu")
    out = runner.generate(*_runner_images(), seed=0)
    assert out.shape == (R, R, 3) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_runner_raises_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDRunner(PDUNetConfig(**CONFIGS["tiny"]))


@pytest.mark.parametrize("caller", ["defaults", "other"])
def test_fp32_scope_holds_inside_forwards_and_restores(caller):
    """Under PyTorch's defaults and under other settings of the caller,
    the engine's forwards run cuDNN convs and matmuls in fp32 with cuDNN's
    benchmark mode at the engine's benchmark limit, and the caller's
    settings come back after each."""
    before = precision_flags()
    flags = before if caller == "defaults" else ("ieee", "tf32", True, 7)
    inside = []
    try:
        set_precision_flags(flags)
        tm = _reference("tiny", True).torch_model("window", True)
        tm.module.register_forward_pre_hook(
            lambda mod, args: inside.append(precision_flags()))
        x = _t(np.zeros((1, R, R, 3), np.float32))
        tm.dense(x, _t(LOGSNR))
        assert precision_flags() == flags
        tm.full(x, _t(LOGSNR))
        assert precision_flags() == flags
    finally:
        set_precision_flags(before)
    assert inside == [("ieee", "ieee", True, BENCHMARK_LIMIT)] * 2
