"""The port's checkpoint layer against sige_tpu's.

  * every converter: the port's conversion of a reference-layout state
    dict equals ``state_dict_from_flax`` of ``sige_tpu``'s conversion of
    the same dict, key by key and value by value — exactly (0.0) for the
    pure re-layouts and surgeries, within 1e-6 * max|w| for the SD
    encoder's ``quant_conv`` fold (the port folds in float64) — and loads
    into the port's module with ``strict=True``. The reference-layout
    dicts are built as ``tests/test_convert.py``,
    ``tests/test_convert_sd.py``, ``tests/test_vanilla_ddpm.py`` and
    ``tests/test_gaugan_vanilla.py`` build them, from seeded ``sige_tpu``
    trees: church256 DDPM at full width (fused, and vanilla unfused and
    to fused), and tiny PD, GauGAN (fused, plain, sub-mobile from fused
    and unfused checkpoints), SD U-Net and VAE configs;
  * the vanilla DDPM U-Net equals ``sige_tpu``'s on the same weights, and
    the port's fused U-Net on the fused conversion equals it (atol 1e-4);
  * ``load_torch_state_dict``: the EMA container, the lightning wrapper,
    the ``module.`` prefix, the md5 check; native checkpoints round-trip
    and a ``sige_tpu`` orbax directory is refused; ``ema_update`` equals
    ``sige_tpu``'s;
  * ``chip_smoke.py``'s reference layouts (the keys and shapes its card
    phase writes) equal the test helpers' at the tiny configs.
"""

import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet, VanillaDDPMUNet
from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                      SIGESubMobileSPADEGenerator,
                                      SPADEGenConfig, VanillaSPADEGenerator)
from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                  SIGEEncoder, SIGESDUNet)
from sige_torch.nn.module import SIGECtx
from sige_torch.utils import checkpoint, convert, convert_sd, ema
from sige_torch.utils.from_jax import state_dict_from_flax
from sige_tpu.models import ddpm as jddpm
from sige_tpu.models import gaugan as jgaugan
from sige_tpu.models import pd as jpd
from sige_tpu.models import sd as jsd
from sige_tpu.nn.module import SIGECtx as JCtx
from sige_tpu.utils import convert as jconvert
from sige_tpu.utils import convert_sd as jconvert_sd
from test_convert import _torch_style_state_dict
from test_convert_sd import _leaf_to_torch, _unet_torch_key, _vae_sd
from test_gaugan_vanilla import _sub_mobile_sd, _vanilla_sd
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)
from test_vanilla_ddpm import _params_to_torch_sd

# tests/test_vanilla_ddpm.py:27-31
VANILLA_TINY = dict(ch=8, ch_mult=(1, 2), num_res_blocks=2,
                    attn_resolutions=(8,), in_ch=3, out_ch=3, resolution=16,
                    num_groups=4, block_size_normal=None,
                    block_size_instance=None,
                    sparse_resolution_threshold=10_000)
# tests/test_convert.py:178-180
PD_TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=2,
               attn_resolutions=(16,), resolution=32, temb_ch=64, head_dim=16)
# tests/test_gaugan_vanilla.py:23-26
GAUGAN_TINY = dict(ngf=4, semantic_nc=6, crop_size=64, aspect_ratio=2.0,
                   num_upsampling_layers="normal", main_block_size=None,
                   shortcut_block_size=None, num_sparse_layers=0)
SUB_CHANNELS = (2, 2, 2, 3, 2, 2, 2, 2)
# tests/test_convert_sd.py:22-33
SD_UNET_TINY = dict(in_channels=4, model_channels=8, out_channels=4,
                    num_res_blocks=2, attention_resolutions=(2,),
                    channel_mult=(1, 2), num_heads=2, transformer_depth=1,
                    context_dim=16, num_groups=4, main_block_size=None,
                    shortcut_block_size=None, transformer_block_size=None)
SD_VAE_TINY = dict(ch=8, ch_mult=(1, 2), num_res_blocks=2,
                   attn_resolutions=(), in_channels=3, out_ch=3,
                   z_channels=4, resolution=16, num_groups=4,
                   main_block_size=None, shortcut_block_size=None,
                   attn_block_size=None)


def seeded_tree(init, seed=0):
    """A seeded parameter tree (nested dicts of numpy arrays) with the
    shapes of ``init()``'s ``params`` (``jax.eval_shape``: no compile):
    fan-in-scaled kernels, norm scales near 1, small non-zero biases and
    running means, running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(init)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "running_var":
            a = 0.5 + rng.random(s.shape)
        elif name in ("bias", "running_mean") or name.endswith("_bias"):
            a = 0.05 * rng.standard_normal(s.shape)
        elif len(s.shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_same(ours, theirs_tree, module, atol_of=None):
    """``ours`` (the port's conversion) equals ``state_dict_from_flax`` of
    ``sige_tpu``'s conversion key by key and value by value (exactly, or
    within ``atol_of(key)``), and loads into ``module`` strictly."""
    theirs = state_dict_from_flax(theirs_tree)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert ours[k].dtype == torch.float32 and ours[k].shape == theirs[k].shape
        atol = atol_of(k) if atol_of else 0.0
        err = (ours[k] - theirs[k]).abs().max().item()
        assert err <= atol, (k, err, atol)
    convert.load_converted(module, ours)


def meta(make):
    with torch.device("meta"):
        return make()


def load_meta(module, state):
    """A strict load into a module built on the meta device (keys and
    shapes checked without allocating)."""
    convert.assert_params_match(state, module)
    module.load_state_dict(state, strict=True, assign=True)


# --- DDPM church256 at full width ---------------------------------------

@pytest.fixture(scope="module")
def church_fused_sd():
    cfg = jddpm.DDPMUNetConfig()
    net = jddpm.SIGEFusedUNet(cfg=cfg)
    tree = seeded_tree(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,)),
        ctx=JCtx(mode="dense")))
    return _torch_style_state_dict(tree)


def test_ddpm_fused_church256(church_fused_sd):
    sd = church_fused_sd
    ours = convert.convert_ddpm_fused_unet(sd)
    theirs = state_dict_from_flax(jconvert.convert_ddpm_fused_unet(sd))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k
    load_meta(meta(lambda: SIGEFusedUNet(DDPMUNetConfig())), ours)


@pytest.fixture(scope="module")
def church_vanilla_sd():
    net = jddpm.VanillaDDPMUNet(cfg=jddpm.DDPMUNetConfig())
    tree = seeded_tree(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 256, 256, 3)), jnp.zeros((1,))),
        seed=1)
    return _params_to_torch_sd(tree)


@pytest.mark.parametrize("fuse", [True, False], ids=["to_fused", "vanilla"])
def test_ddpm_vanilla_church256(church_vanilla_sd, fuse):
    sd = church_vanilla_sd
    ours = convert.convert_ddpm_vanilla_unet(sd, fuse=fuse)
    theirs = state_dict_from_flax(jconvert.convert_ddpm_vanilla_unet(
        sd, fuse=fuse))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k
    load_meta(meta(lambda: (SIGEFusedUNet if fuse else VanillaDDPMUNet)(
        DDPMUNetConfig())), ours)


# --- the vanilla U-Net's numerics -----------------------------------------

@pytest.fixture(scope="module")
def vanilla_stack():
    jnet = jddpm.VanillaDDPMUNet(cfg=jddpm.DDPMUNetConfig(**VANILLA_TINY))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([37.0, 611.0], np.float32)
    tree = seeded_tree(lambda: jnet.init(jax.random.key(0), jnp.asarray(x),
                                         jnp.asarray(t)), seed=2)
    y = np.asarray(jnet.apply({"params": tree}, jnp.asarray(x),
                              jnp.asarray(t)))
    return tree, _params_to_torch_sd(tree), x, t, y


def test_vanilla_unet_equals_sige_tpu(vanilla_stack):
    tree, sd, x, t, y = vanilla_stack
    cfg = DDPMUNetConfig(**VANILLA_TINY)
    ours = VanillaDDPMUNet(cfg)
    ours.load_state_dict(state_dict_from_flax(tree), strict=True)
    out = ours(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, y, atol=1e-4)
    # the reference checkpoint's conversion loads the same weights
    conv = convert.load_converted(VanillaDDPMUNet(cfg),
                                  convert.convert_ddpm_vanilla_unet(
                                      sd, ch_mult=cfg.ch_mult,
                                      num_res_blocks=cfg.num_res_blocks,
                                      attn_resolutions=cfg.attn_resolutions,
                                      resolution=cfg.resolution))
    np.testing.assert_array_equal(
        conv(torch.from_numpy(x), torch.from_numpy(t)).numpy(), out)


def test_fused_on_surgery_equals_vanilla(vanilla_stack):
    _, sd, x, t, y = vanilla_stack
    cfg = DDPMUNetConfig(**VANILLA_TINY)
    fused = convert.load_converted(SIGEFusedUNet(cfg),
                                   convert.convert_ddpm_unet_to_fused(
                                       sd, ch_mult=cfg.ch_mult,
                                       num_res_blocks=cfg.num_res_blocks,
                                       attn_resolutions=cfg.attn_resolutions,
                                       resolution=cfg.resolution))
    with torch.inference_mode():
        out = fused(torch.from_numpy(x), torch.from_numpy(t),
                    ctx=SIGECtx(mode="dense"))
    np.testing.assert_allclose(out.numpy(), y, atol=1e-4)


# --- PD, GauGAN, SD at tiny configs ------------------------------------------

def _pd_sd(params):
    """tests/test_convert.py test_pd_converter_bijection's naming."""
    sd = {}
    for key, a in flax.traverse_util.flatten_dict(params).items():
        m = "/".join(key)
        m = m.replace("temb_dense0", "temb.dense.0")
        m = m.replace("temb_dense1", "temb.dense.1")
        for pref, ref in (("down_blocks_", "down.{}.block.{}"),
                          ("down_attns_", "down.{}.attn.{}"),
                          ("up_blocks_", "up.{}.block.{}"),
                          ("up_attns_", "up.{}.attn.{}")):
            if m.startswith(pref):
                nums, _, sub = m[len(pref):].partition("/")
                i, b = nums.split("_")
                m = ref.format(i, b) + ("." + sub.replace("/", ".") if sub
                                        else "")
        if m.startswith("downsamples_"):
            i = m.split("_")[1].split("/")[0]
            m = f"down.{i}.downsample." + m.split("/", 1)[1].replace("/", ".")
        if m.startswith("upsamples_"):
            i = int(m.split("_")[1].split("/")[0])
            m = f"up.{i + 1}.upsample." + m.split("/", 1)[1].replace("/", ".")
        m = m.replace("mid_block1", "mid.block_1").replace(
            "mid_block2", "mid.block_2").replace("mid_attn", "mid.attn_1")
        m = m.replace("/", ".")
        if m == "norm_out_scale":
            sd["norm_out.weight"] = a
        elif m == "norm_out_bias":
            sd["norm_out.bias"] = a
        elif m.endswith(".kernel"):
            sd[m[:-len(".kernel")] + ".weight"] = (
                np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4
                else np.transpose(a, (1, 0)))
        elif m.endswith(".scale"):
            sd[m[:-len(".scale")] + ".weight"] = a
        else:
            sd[m] = a
    return sd


def _fused_spade_sd(params):
    """tests/test_convert.py test_gaugan_converter_bijection's naming."""
    sd = {}
    for key, a in flax.traverse_util.flatten_dict(params).items():
        path = list(key)
        name = path[-1]
        mod = ".".join(path[:-1]).replace("mlp_shared", "mlp_shared.0")
        if "norm_" in mod and name in ("running_mean", "running_var"):
            sd[f"{mod}.param_free_norm.{name}"] = a
        elif name == "kernel":
            sd[f"{mod}.weight"] = np.transpose(a, (3, 2, 0, 1))
        else:
            sd[f"{mod}.{name}"] = a
    return sd


def _pd_tree():
    net = jpd.SIGEPDUNet(cfg=jpd.PDUNetConfig(**PD_TINY))
    return seeded_tree(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)),
        ctx=JCtx(mode="dense")), seed=3)


def test_pd(tmp_path):
    sd = _pd_sd(_pd_tree())
    kw = dict(ch_mult=PD_TINY["ch_mult"],
              num_res_blocks=PD_TINY["num_res_blocks"],
              attn_resolutions=PD_TINY["attn_resolutions"],
              resolution=PD_TINY["resolution"])
    assert_same(convert.convert_pd_unet(sd, **kw),
                jconvert.convert_pd_unet(sd, **kw),
                SIGEPDUNet(PDUNetConfig(**PD_TINY)))


def _gaugan_tree(kind):
    seg = jnp.zeros((1, 32, 64, GAUGAN_TINY["semantic_nc"]), jnp.float32)
    cfg = jgaugan.SPADEGenConfig(**GAUGAN_TINY)
    if kind == "spade":
        net = jgaugan.VanillaSPADEGenerator(cfg=cfg)
        return seeded_tree(lambda: net.init(jax.random.key(0), seg), seed=4)
    net = (jgaugan.SIGEFusedSPADEGenerator(cfg=cfg) if kind == "fused" else
           jgaugan.SIGESubMobileSPADEGenerator(cfg=cfg, channels=SUB_CHANNELS))
    return seeded_tree(lambda: net.init(jax.random.key(0), seg,
                                        ctx=JCtx(mode="dense")), seed=5)


def test_gaugan_fused():
    sd = _fused_spade_sd(_gaugan_tree("fused"))
    nul = GAUGAN_TINY["num_upsampling_layers"]
    assert not convert.is_unfused_spade(sd)
    assert_same(convert.convert_gaugan_fused_spade(sd, nul),
                jconvert.convert_gaugan_fused_spade(sd, nul),
                SIGEFusedSPADEGenerator(SPADEGenConfig(**GAUGAN_TINY)))


@pytest.mark.parametrize("fuse", [False, True], ids=["vanilla", "to_fused"])
def test_gaugan_spade(fuse):
    sd = _vanilla_sd(_gaugan_tree("spade"))
    nul = GAUGAN_TINY["num_upsampling_layers"]
    assert convert.is_unfused_spade(sd)
    cfg = SPADEGenConfig(**GAUGAN_TINY)
    assert_same(convert.convert_gaugan_spade(sd, nul, fuse=fuse),
                jconvert.convert_gaugan_spade(sd, nul, fuse=fuse),
                SIGEFusedSPADEGenerator(cfg) if fuse
                else VanillaSPADEGenerator(cfg))


@pytest.mark.parametrize("fused_ckpt", [True, False],
                         ids=["fused_ckpt", "unfused_ckpt"])
def test_gaugan_sub_mobile(fused_ckpt):
    """Running statistics stored at a longer nominal width are truncated;
    the unfused checkpoint's per-norm mlp_shared convs are concatenated
    (``tests/test_gaugan_vanilla.py:114-171``)."""
    sd = _sub_mobile_sd(_gaugan_tree("sub"), pad_stats=17)
    if not fused_ckpt:
        for name, (_ic, _ch, hidden, sc) in convert.sub_mobile_block_dims(
                SUB_CHANNELS, GAUGAN_TINY["ngf"]).items():
            w = sd.pop(f"{name}.mlp_shared.0.weight")
            b = sd.pop(f"{name}.mlp_shared.0.bias")
            for j, br in enumerate(["norm_0", "norm_1"]
                                   + (["norm_s"] if sc else [])):
                sd[f"{name}.{br}.mlp_shared.0.weight"] = w[j * hidden:
                                                           (j + 1) * hidden]
                sd[f"{name}.{br}.mlp_shared.0.bias"] = b[j * hidden:
                                                         (j + 1) * hidden]
    assert convert.is_unfused_spade(sd) == (not fused_ckpt)
    kw = dict(channels=SUB_CHANNELS, ngf=GAUGAN_TINY["ngf"],
              fused_ckpt=fused_ckpt)
    assert_same(convert.convert_gaugan_sub_mobile_spade(sd, **kw),
                jconvert.convert_gaugan_sub_mobile_spade(sd, **kw),
                SIGESubMobileSPADEGenerator(SPADEGenConfig(**GAUGAN_TINY),
                                            SUB_CHANNELS))


def _sd_trees():
    unet = jsd.SIGESDUNet(cfg=jsd.SDUNetConfig(**SD_UNET_TINY))
    vcfg = jsd.SDVAEConfig(**SD_VAE_TINY)
    ctx = JCtx(mode="dense")
    u = seeded_tree(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 7, 16)), ctx=ctx), seed=6)
    e = seeded_tree(lambda: jsd.SIGEEncoder(cfg=vcfg).init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), ctx=ctx), seed=7)
    d = seeded_tree(lambda: jsd.SIGEDecoder(cfg=vcfg).init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 4)), ctx=ctx), seed=8)
    return u, e, d


def _sd_unet_sd(tree):
    """tests/test_convert_sd.py test_sd_unet_converter_bijection's naming."""
    sd = {}
    for path, leaf in flax.traverse_util.flatten_dict(tree).items():
        if path[-1] in ("out_norm_scale", "out_norm_bias"):
            sd["out.0." + ("weight" if path[-1].endswith("scale")
                           else "bias")] = np.asarray(leaf)
            continue
        suffix, arr = _leaf_to_torch(path, leaf)
        sd[f"{_unet_torch_key(path)}.{suffix}"] = arr
    return sd


@pytest.fixture(scope="module")
def sd_checkpoint():
    """A tiny sd-v1-style LDM state dict: prefixed U-Net and VAE keys,
    ``quant_conv`` and ``post_quant_conv``."""
    u, e, d = _sd_trees()
    z = SD_VAE_TINY["z_channels"]
    rng = np.random.default_rng(9)
    sd = {f"model.diffusion_model.{k}": v for k, v in _sd_unet_sd(u).items()}
    sd.update({f"first_stage_model.encoder.{k}": v
               for k, v in _vae_sd(e, "encoder").items()})
    sd.update({f"first_stage_model.decoder.{k}": v
               for k, v in _vae_sd(d, "decoder").items()})
    for name, c in (("quant_conv", 2 * z), ("post_quant_conv", z)):
        sd[f"first_stage_model.{name}.weight"] = rng.normal(
            size=(c, c, 1, 1)).astype(np.float32)
        sd[f"first_stage_model.{name}.bias"] = rng.normal(
            size=(c,)).astype(np.float32)
    return sd


def _sd_kw():
    u, v = SD_UNET_TINY, SD_VAE_TINY
    return dict(channel_mult=u["channel_mult"],
                num_res_blocks=u["num_res_blocks"],
                attention_resolutions=u["attention_resolutions"],
                transformer_depth=u["transformer_depth"],
                vae_ch_mult=v["ch_mult"],
                vae_num_res_blocks=v["num_res_blocks"],
                vae_attn_resolutions=v["attn_resolutions"],
                resolution=v["resolution"])


def test_sd(sd_checkpoint):
    sd = sd_checkpoint
    ours = convert_sd.convert_sd(sd, **_sd_kw())
    theirs = jconvert_sd.convert_sd(sd, **_sd_kw())
    fold = max(abs(float(np.abs(v).max())) for k, v in sd.items()
               if "encoder.conv_out" in k or "quant_conv" in k)
    modules = {"unet": SIGESDUNet(SDUNetConfig(**SD_UNET_TINY)),
               "encoder": SIGEEncoder(SDVAEConfig(**SD_VAE_TINY)),
               "decoder": SIGEDecoder(SDVAEConfig(**SD_VAE_TINY))}
    for name, module in modules.items():
        # the folded conv_out: float64 against sige_tpu's float32 einsum
        assert_same(ours[name], theirs[name], module,
                    lambda k: (1e-6 * fold if name == "encoder"
                               and k.startswith("conv_out") else 0.0))
    for a, b in zip(ours["post_quant"], theirs["post_quant"]):
        assert torch.equal(a, torch.from_numpy(np.asarray(b)))
    # the fold is the quant_conv applied after the raw conv_out
    raw = convert_sd.convert_sd_encoder(
        convert_sd.strip_prefix(sd, "first_stage_model.encoder."),
        ch_mult=SD_VAE_TINY["ch_mult"], resolution=SD_VAE_TINY["resolution"])
    qw = torch.from_numpy(sd["first_stage_model.quant_conv.weight"])[:, :, 0, 0]
    qb = torch.from_numpy(sd["first_stage_model.quant_conv.bias"])
    x = torch.randn(1, raw["conv_out.weight"].shape[1], 6, 6,
                    generator=torch.Generator().manual_seed(0))
    y_raw = torch.nn.functional.conv2d(x, raw["conv_out.weight"],
                                       raw["conv_out.bias"])
    y_fold = torch.nn.functional.conv2d(x, ours["encoder"]["conv_out.weight"],
                                        ours["encoder"]["conv_out.bias"])
    want = torch.einsum("pc,bchw->bphw", qw, y_raw) + qb[None, :, None, None]
    torch.testing.assert_close(y_fold, want, atol=1e-5, rtol=1e-5)


# --- containers, native checkpoints, EMA --------------------------------

def test_load_torch_state_dict_containers(tmp_path):
    """{"model", "ema"} training states with the EMA overlaid
    (reference: diffusion/runner.py:74-86), the ``module.`` prefix, the
    lightning ``state_dict`` wrapper: as sige_tpu reads them."""
    from sige_tpu.utils.convert import load_torch_state_dict as jload

    model = {"module.w": torch.full((2,), 1.0), "b": torch.full((2,), 2.0)}
    ema_sd = {"module.w": torch.full((2,), 9.0)}
    path = tmp_path / "states.pth"
    torch.save({"model": model, "ema": ema_sd, "step": 3}, path)
    for prefer in (True, False):
        ours = convert.load_torch_state_dict(str(path), prefer_ema=prefer)
        theirs = jload(str(path), prefer_ema=prefer)
        assert ours.keys() == theirs.keys() == {"w", "b"}
        for k in theirs:
            np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    assert convert.load_torch_state_dict(str(path))["w"][0] == 9.0
    lightning = tmp_path / "lightning.ckpt"
    torch.save({"state_dict": {"a.weight": torch.ones(3)}, "epoch": 1,
                "callbacks": {"x": 1}}, lightning)
    assert list(convert.load_torch_state_dict(str(lightning))) == ["a.weight"]


def test_md5_check(tmp_path):
    path = tmp_path / "w.pth"
    torch.save({"w": torch.arange(4.0)}, path)
    from sige_tpu.utils.convert import md5_file as jmd5

    digest = convert.md5_file(str(path))
    assert digest == jmd5(str(path))
    assert torch.equal(convert.load_torch_state_dict(str(path), md5=digest)["w"],
                       torch.arange(4.0))
    with pytest.raises(ValueError, match="md5 mismatch"):
        convert.load_torch_state_dict(str(path), md5="0" * 32)


def test_assert_params_match_names_every_mismatch():
    module = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    state = dict(module.state_dict())
    state.pop("0.bias")
    state["1.weight"] = torch.zeros(1, 5)
    state["2.weight"] = torch.zeros(1)
    with pytest.raises(ValueError) as e:
        convert.load_converted(module, state)
    msg = str(e.value)
    assert "0.bias" in msg and "2.weight" in msg and "1.weight" in msg


def test_native_checkpoint_round_trip(tmp_path):
    flat = {"a.weight": torch.randn(3, 2), "b": torch.arange(4.0)}
    nested = {"unet": flat, "encoder": {"c": torch.ones(2)},
              "post_quant": (torch.eye(4), torch.zeros(4)), "decoder": None}
    for name, params in (("flat", flat), ("nested", nested)):
        path = checkpoint.save_params(str(tmp_path / name), params)
        back = checkpoint.maybe_load_native(path, "cpu")
        if name == "flat":
            assert back.keys() == flat.keys()
            assert all(torch.equal(back[k], flat[k]) for k in flat)
        else:
            assert set(back) == {"unet", "encoder", "post_quant"}
            assert torch.equal(back["post_quant"][0], torch.eye(4))
            assert torch.equal(back["unet"]["a.weight"], flat["a.weight"])
    assert checkpoint.maybe_load_native(str(tmp_path / "none.pth")) is None
    assert checkpoint.maybe_load_native(None) is None


def test_native_refuses_an_orbax_directory(tmp_path):
    from sige_tpu.utils.checkpoint import save_params as jsave

    jsave(str(tmp_path / "orbax"), {"w": np.ones((2, 2), np.float32)})
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_params(str(tmp_path / "orbax"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not a sige_torch checkpoint"):
        checkpoint.load_params(str(tmp_path / "empty"))


def test_ema_equals_sige_tpu():
    from sige_tpu.utils import ema as jema

    rng = np.random.default_rng(0)
    live = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    shadow = ema.ema_init({k: torch.from_numpy(v) for k, v in live.items()})
    jshadow = jema.ema_init(live)
    for step in range(3):
        new = {k: v + step for k, v in live.items()}
        shadow = ema.ema_update(shadow, {k: torch.from_numpy(v)
                                         for k, v in new.items()}, 0.9)
        jshadow = jema.ema_update(jshadow, new, 0.9)
    for k in live:
        np.testing.assert_allclose(shadow[k].numpy(), np.asarray(jshadow[k]),
                                   rtol=0, atol=1e-6)


# --- chip_smoke.py's reference layouts ---------------------------------------

def _shapes(sd):
    return {k: tuple(np.shape(v)) for k, v in sd.items()}


def test_chip_smoke_layouts_match_the_test_helpers(sd_checkpoint):
    """The keys and shapes ``chip_smoke.py``'s card phase writes for each
    reference checkpoint equal what the ``sige_tpu`` test helpers build,
    at the tiny configs."""
    lay = chip_smoke.reference_layout
    vanilla = jddpm.VanillaDDPMUNet(cfg=jddpm.DDPMUNetConfig(**VANILLA_TINY))
    fused = jddpm.SIGEFusedUNet(cfg=jddpm.DDPMUNetConfig(**VANILLA_TINY))
    x, t = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    cfg = DDPMUNetConfig(**VANILLA_TINY)
    assert lay("ddpm", meta(lambda: VanillaDDPMUNet(cfg))) == _shapes(
        _params_to_torch_sd(seeded_tree(lambda: vanilla.init(
            jax.random.key(0), x, t))))
    assert lay("ddpm", meta(lambda: SIGEFusedUNet(cfg))) == _shapes(
        _torch_style_state_dict(seeded_tree(lambda: fused.init(
            jax.random.key(0), x, t, ctx=JCtx(mode="dense")))))
    assert lay("ddpm", meta(lambda: SIGEPDUNet(PDUNetConfig(**PD_TINY)))) \
        == _shapes(_pd_sd(_pd_tree()))
    gcfg = SPADEGenConfig(**GAUGAN_TINY)
    assert lay("gaugan", meta(lambda: SIGEFusedSPADEGenerator(gcfg))) == \
        _shapes(_fused_spade_sd(_gaugan_tree("fused")))
    assert lay("gaugan", meta(lambda: VanillaSPADEGenerator(gcfg))) == \
        _shapes(_vanilla_sd(_gaugan_tree("spade")))
    assert lay("gaugan", meta(lambda: SIGESubMobileSPADEGenerator(
        gcfg, SUB_CHANNELS))) == _shapes(_sub_mobile_sd(_gaugan_tree("sub"),
                                                        pad_stats=0))
    sd_layout = chip_smoke.sd_reference_layout(
        SDUNetConfig(**SD_UNET_TINY), SDVAEConfig(**SD_VAE_TINY))
    assert sd_layout == _shapes(sd_checkpoint)
    # the sub-mobile statistics at nominal width: every channel ngf
    widths = chip_smoke.sub_mobile_widths(gcfg)
    sub = lay("gaugan", meta(lambda: SIGESubMobileSPADEGenerator(
        gcfg, SUB_CHANNELS)), widths=widths)
    ngf = GAUGAN_TINY["ngf"]
    assert sub["head_0.norm_0.param_free_norm.running_mean"] == (16 * ngf,)
    assert sub["up_0.norm_1.param_free_norm.running_var"] == (8 * ngf,)
    assert sub["up_3.norm_s.param_free_norm.running_var"] == (2 * ngf,)


def test_chip_smoke_values_convert_and_load():
    """``chip_smoke.reference_values`` (drawn here on the CPU) converts and
    loads strictly, the sub-mobile statistics truncated from nominal."""
    gcfg = SPADEGenConfig(**GAUGAN_TINY)
    layout = chip_smoke.reference_layout(
        "gaugan", meta(lambda: SIGESubMobileSPADEGenerator(gcfg,
                                                           SUB_CHANNELS)),
        widths=chip_smoke.sub_mobile_widths(gcfg))
    ref = chip_smoke.reference_values(layout, 0, device="cpu")
    assert all((v > 0).all() for k, v in ref.items()
               if k.endswith("running_var"))
    state = convert.convert_gaugan_sub_mobile_spade(
        ref, channels=SUB_CHANNELS, ngf=GAUGAN_TINY["ngf"])
    convert.load_converted(SIGESubMobileSPADEGenerator(gcfg, SUB_CHANNELS),
                           state)
    key = "head_0.norm_0.param_free_norm.running_mean"
    assert torch.equal(state["head.0.norm.0.running_mean"],
                       ref[key][:state["head.0.norm.0.running_mean"].numel()])
    assert re.match(r"^head_0\.", chip_smoke.reference_key(
        "gaugan", "head.0.norm.0.running_mean"))
