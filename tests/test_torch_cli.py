"""The port's command lines on the CPU (``--device cpu``) against sige_tpu's,
at ``tests/test_cli.py``'s tiny ``--hparams``:

  * ``cli.diffusion`` (DDPM and PD), ``cli.gaugan`` and ``cli.sd`` print
    sige_tpu's log lines, save their PNGs (and the diffusion suite its
    HTML gallery), and write a ``torch.profiler`` trace with ``--trace``;
  * ``--restore_from`` of a reference .pth (written from
    ``chip_smoke.py``'s reference layouts, which ``test_torch_convert.py``
    holds to the sige_tpu test helpers') builds the same model as
    sige_tpu's command line from the same file: one full forward agrees
    at atol 1e-4 (DDPM vanilla and fused checkpoints, PD, GauGAN), or the
    weights equal sige_tpu's conversion (SD, every GauGAN layout);
  * ``--save_converted`` then ``--restore_from`` of that directory gives
    the same weights and the same output, bit for bit;
  * ``cli.sd --prompt`` (a synthetic CLIP snapshot found through
    ``HF_HUB_CACHE``) writes the same PNG, byte for byte, as
    ``--embeddings`` of ``encode_prompts(["", prompt])``;
    ``--safety_model`` (a synthetic checker snapshot) blacks out a sample
    its seeded threshold flags and leaves one it does not as it was;
  * each command line raises without a GPU unless ``--device cpu``; the
    demo server restores a checkpoint.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sige_torch.cli import diffusion, gaugan, sd
from sige_torch.demo import server
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet, VanillaDDPMUNet
from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                      SIGESubMobileSPADEGenerator,
                                      SPADEGenConfig, VanillaSPADEGenerator,
                                      decode_config)
from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
from sige_torch.models.sd import SDUNetConfig, SDVAEConfig
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

DDPM_TINY_HPARAMS = (  # tests/test_cli.py
    "model.ch=16 model.ch_mult=1,2 model.num_res_blocks=1 "
    "model.attn_resolutions=16 model.sparse_resolution_threshold=32 "
    "model.num_groups=8 data.image_size=32 "
    "sampling.sample_steps=2 sampling.noise_level=100")
PD_TINY_HPARAMS = (  # tests/test_pd.py's TINY
    "model.ch=32 model.ch_mult=1,2 model.num_res_blocks=1 "
    "model.attn_resolutions=8 model.temb_ch=64 model.head_dim=16 "
    "model.sparse_resolution_threshold=16 data.image_size=32 "
    "sampling.sample_steps=2 sampling.noise_level=3")
GAUGAN_TINY = ["--ngf", "16", "--crop_size", "128", "--num_sparse_layers",
               "2"]  # tests/test_cli.py
SUB_CONFIG = "8_8_8_8_8_8_8_8"
SD_HPARAMS = ("unet.model_channels=8 unet.channel_mult=1,2 "
              "unet.attention_resolutions=2 unet.num_heads=2 "
              "unet.context_dim=16 unet.num_groups=4 vae.ch=8 "
              "vae.ch_mult=1,2 vae.num_groups=4")
SD_SIZE = 64

PROFILE_LINE = (r"^Image synthetic: Sparsity [\d.]+%    MACs [\d.]+G    "
                r"Avg Time [\d.]+ms$")
GENERATE_LINE = (r"^Image synthetic: Edit Ratio [\d.]+%    Tiles \d+/\d+"
                 r"    Time [\d.]+s$")
GAUGAN_LINE = r"^Image synthetic: Edit Ratio [\d.]+%    Tiles \d+/\d+$"


def _run(main, argv, capsys):
    runner = main(argv)
    return runner, capsys.readouterr().out


def _has(out, pattern):
    assert re.search(pattern, out, re.M), (pattern, out)


def _write_reference(tmp_path, name, family, module, seed=0, widths=None):
    """A reference-layout .pth of ``module`` (built on the meta device)."""
    with torch.device("meta"):
        m = module()
    ref = chip_smoke.reference_values(
        chip_smoke.reference_layout(family, m, widths=widths), seed,
        device="cpu")
    path = str(tmp_path / f"{name}.pth")
    torch.save(ref, path)
    return path, ref


def _ddpm_cfg(network):
    from sige_torch.utils.config import load_config, override_config

    config = load_config("configs/church_ddim256-sige.yml")
    override_config(config, DDPM_TINY_HPARAMS + f" model.network={network}")
    return config


def _torch_cfg(config):
    m = config.model
    return DDPMUNetConfig(
        ch=m.ch, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions),
        resolution=config.data.image_size, num_groups=m.num_groups,
        sparse_resolution_threshold=m.sparse_resolution_threshold)


def _same_full_forward(ours, theirs, cond):
    """One full forward of the port's runner and sige_tpu's on the same
    input agree at atol 1e-4."""
    R = ours.model_cfg.resolution
    x = np.random.default_rng(5).normal(size=(1, R, R, 3)).astype(np.float32)
    y_ours = ours.model.full(torch.from_numpy(x),
                             torch.tensor(cond, dtype=torch.float32)).numpy()
    y_theirs = np.asarray(theirs.model.full(jnp.asarray(x),
                                            jnp.asarray(cond, jnp.float32)))
    np.testing.assert_allclose(y_ours, y_theirs, atol=1e-4)


# --- cli.diffusion ------------------------------------------------------------

def test_diffusion_profile_and_trace(capsys, tmp_path):
    _, out = _run(diffusion.main, [
        "--config_path", "configs/church_ddpm256-sige.yml", "--mode",
        "profile", "--synthetic", "--hparams", DDPM_TINY_HPARAMS,
        "--warmup_times", "1", "--test_times", "2", "--device", "cpu",
        "--trace", str(tmp_path / "trace")], capsys)
    _has(out, PROFILE_LINE)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("network", ["ddpm.unet", "ddpm.sige_fused_unet"])
def test_diffusion_restore_generate_and_round_trip(capsys, tmp_path, network):
    """A vanilla checkpoint (the fuse surgery) or a fused one, through
    the port's command line and sige_tpu's ``build_runner``; then the
    native directory written by ``--save_converted``."""
    from sige_tpu.cli.diffusion import build_runner as jbuild

    config = _ddpm_cfg(network)
    cfg = _torch_cfg(config)
    module = (VanillaDDPMUNet if network == "ddpm.unet" else SIGEFusedUNet)
    pth, _ = _write_reference(tmp_path, "ddpm", "ddpm", lambda: module(cfg))
    argv = ["--config_path", "configs/church_ddim256-sige.yml", "--hparams",
            DDPM_TINY_HPARAMS + f" model.network={network}", "--synthetic",
            "--mode", "generate", "--device", "cpu"]
    native = str(tmp_path / "native")
    ours, out = _run(diffusion.main, argv + [
        "--restore_from", pth, "--save_converted", native, "--save_dir",
        str(tmp_path / "a")], capsys)
    _has(out, GENERATE_LINE)
    _has(out, r"^saved native checkpoint: ")
    assert (tmp_path / "a" / "synthetic.png").exists()
    assert "synthetic.png" in (tmp_path / "a" / "index.html").read_text()
    _same_full_forward(ours, jbuild(config, pth), [37.0])

    again, _ = _run(diffusion.main, argv + [
        "--restore_from", native, "--save_dir", str(tmp_path / "b")], capsys)
    a, b = ours.module.state_dict(), again.module.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    original, edited = diffusion.synthetic_pair(cfg.resolution, 0)
    np.testing.assert_array_equal(ours.generate(original, edited),
                                  again.generate(original, edited))
    assert (tmp_path / "a" / "synthetic.png").read_bytes() == (
        tmp_path / "b" / "synthetic.png").read_bytes()


def test_diffusion_pd_restore(capsys, tmp_path):
    from sige_tpu.cli.diffusion import build_runner as jbuild
    from sige_torch.utils.config import load_config, override_config

    config = override_config(load_config("configs/church_pd256-sige.yml"),
                             PD_TINY_HPARAMS)
    cfg = PDUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                       attn_resolutions=(8,), resolution=32, temb_ch=64,
                       head_dim=16, sparse_resolution_threshold=16)
    pth, _ = _write_reference(tmp_path, "pd", "ddpm", lambda: SIGEPDUNet(cfg))
    ours, out = _run(diffusion.main, [
        "--config_path", "configs/church_pd256-sige.yml", "--hparams",
        PD_TINY_HPARAMS, "--synthetic", "--mode", "generate", "--device",
        "cpu", "--restore_from", pth], capsys)
    _has(out, GENERATE_LINE)
    _same_full_forward(ours, jbuild(config, pth), [0.5])


# --- cli.gaugan -------------------------------------------------------------

def test_gaugan_profile(capsys):
    _, out = _run(gaugan.main, [
        "--netG", "sige_fused_spade", "--mode", "profile", "--synthetic",
        *GAUGAN_TINY, "--warmup_times", "1", "--test_times", "2",
        "--device", "cpu"], capsys)
    _has(out, PROFILE_LINE)


GAUGAN_CASES = {  # layout: (netG, the reference module, sige_tpu converter)
    "fused": ("sige_fused_spade", "fused"),
    "spade": ("spade", "spade"),
    "spade_sige": ("sige_fused_spade", "spade"),
    "sub_mobile_fused": ("sige_fused_sub_mobile_spade", "sub"),
    "sub_mobile_unfused": ("sub_mobile_spade", "sub_unfused"),
}


def _gaugan_reference(tmp_path, kind):
    cfg = SPADEGenConfig(ngf=16, crop_size=128, num_sparse_layers=2)
    channels = tuple(decode_config(SUB_CONFIG))
    make = {"fused": lambda: SIGEFusedSPADEGenerator(cfg),
            "spade": lambda: VanillaSPADEGenerator(cfg),
            "sub": lambda: SIGESubMobileSPADEGenerator(cfg, channels)}[
                kind.removesuffix("_unfused")]
    widths = chip_smoke.sub_mobile_widths(cfg) if "sub" in kind else None
    pth, ref = _write_reference(tmp_path, kind, "gaugan", make, seed=2,
                                widths=widths)
    if kind == "sub_unfused":  # per-norm mlp_shared, as sub_mobile_spade-*.pth
        from sige_torch.utils.convert import sub_mobile_block_dims

        for name, (_ic, _ch, hidden, sc) in sub_mobile_block_dims(
                channels, cfg.ngf).items():
            w = ref.pop(f"{name}.mlp_shared.0.weight")
            b = ref.pop(f"{name}.mlp_shared.0.bias")
            for j, br in enumerate(["norm_0", "norm_1"]
                                   + (["norm_s"] if sc else [])):
                ref[f"{name}.{br}.mlp_shared.0.weight"] = w[
                    j * hidden:(j + 1) * hidden].clone()
                ref[f"{name}.{br}.mlp_shared.0.bias"] = b[
                    j * hidden:(j + 1) * hidden].clone()
        torch.save(ref, pth)
    return pth, {k: v.numpy() for k, v in ref.items()}, channels


@pytest.mark.parametrize("case", list(GAUGAN_CASES))
def test_gaugan_restore(capsys, tmp_path, case):
    """Each reference layout under its netG (and a plain SPADE checkpoint
    under a sige_* netG: the checkpoint's keys pick the surgery): the
    weights equal sige_tpu's conversion; the fused checkpoint's full
    forward equals sige_tpu's runner's."""
    from sige_tpu.utils import convert as jconvert

    netg, kind = GAUGAN_CASES[case]
    pth, ref, channels = _gaugan_reference(tmp_path, kind)
    argv = ["--netG", netg, "--synthetic", "--mode", "generate", *GAUGAN_TINY,
            "--device", "cpu", "--restore_from", pth, "--save_dir",
            str(tmp_path / "out")]
    if "sub" in kind:
        argv += ["--config_str", SUB_CONFIG]
    ours, out = _run(gaugan.main, argv, capsys)
    _has(out, GAUGAN_LINE)
    assert (tmp_path / "out" / "synthetic.png").exists()
    if "sub" in kind:
        want = jconvert.convert_gaugan_sub_mobile_spade(
            ref, channels=channels, ngf=16, fused_ckpt=kind == "sub")
    elif kind == "spade":
        want = jconvert.convert_gaugan_spade(ref, "more", fuse=True)
    else:
        want = jconvert.convert_gaugan_fused_spade(ref, "more")
    want = state_dict_from_flax(want)
    got = ours.module.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    if case == "fused":
        from sige_tpu.models.gaugan import SPADEGenConfig as JConfig
        from sige_tpu.runners.gaugan_runner import GauGANRunner as JRunner
        from sige_tpu.utils.convert import convert_gaugan_fused_spade

        theirs = JRunner(JConfig(ngf=16, crop_size=128, num_sparse_layers=2),
                         params=convert_gaugan_fused_spade(ref, "more"))
        item = gaugan.synthetic_items(gaugan.get_args(["--synthetic",
                                                       *GAUGAN_TINY]))[0]
        seg = ours.preprocess_input(item["original_label"],
                                    item["original_instance"])
        np.testing.assert_allclose(
            ours.model.full(torch.from_numpy(seg)).numpy(),
            np.asarray(theirs.model.full(jnp.asarray(seg))), atol=1e-4)


# --- cli.sd --------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_reference(tmp_path_factory):
    """A tiny sd-v1-style LDM .pth (U-Net, VAE, quant_conv,
    post_quant_conv) and seeded text embeddings."""
    from sige_torch.cli.sd import _apply_hparams
    from sige_torch.runners import SDRunConfig

    tmp = tmp_path_factory.mktemp("sd")
    unet_cfg, vae_cfg, _ = _apply_hparams(
        SD_HPARAMS, SDUNetConfig(), SDVAEConfig(resolution=SD_SIZE),
        SDRunConfig())
    ref = chip_smoke.reference_values(
        chip_smoke.sd_reference_layout(unet_cfg, vae_cfg), 3, device="cpu")
    pth = str(tmp / "sd.ckpt")
    torch.save({"state_dict": ref, "global_step": 1}, pth)
    rng = np.random.default_rng(0)
    emb = str(tmp / "emb.npz")
    np.savez(emb, uc=rng.normal(size=(1, 77, 16)).astype(np.float32),
             c=rng.normal(size=(1, 77, 16)).astype(np.float32))
    return pth, emb, unet_cfg, vae_cfg, {k: v.numpy() for k, v in ref.items()}


def _sd_argv(tmp_path, *extra):
    return ["--task", "sdedit", "--synthetic", "--H", str(SD_SIZE), "--W",
            str(SD_SIZE), "--ddim_steps", "4", "--strength", "0.5",
            "--hparams", SD_HPARAMS, "--device", "cpu", "--save_dir",
            str(tmp_path), *extra]


def test_sd_restore_sdedit_and_round_trip(capsys, tmp_path, sd_reference):
    from sige_tpu.utils.convert_sd import convert_sd as jconvert_sd

    pth, emb, unet_cfg, vae_cfg, ref = sd_reference
    native = str(tmp_path / "native")
    ours, out = _run(sd.main, _sd_argv(tmp_path / "a", "--embeddings", emb,
                                       "--restore_from", pth,
                                       "--save_converted", native), capsys)
    _has(out, r"^WARNING: no --safety_model given")
    _has(out, r"^saved .*sdedit\.png$")
    assert (tmp_path / "a" / "sdedit.png").exists()
    want = jconvert_sd(ref, channel_mult=unet_cfg.channel_mult,
                       num_res_blocks=unet_cfg.num_res_blocks,
                       attention_resolutions=unet_cfg.attention_resolutions,
                       vae_ch_mult=vae_cfg.ch_mult, resolution=SD_SIZE)
    for name, model in (("unet", ours.unet), ("encoder", ours.encoder),
                        ("decoder", ours.decoder)):
        got, exp = model.module.state_dict(), state_dict_from_flax(want[name])
        assert got.keys() == exp.keys()
        for k in exp:  # the encoder's conv_out holds the quant_conv fold
            torch.testing.assert_close(got[k], exp[k], atol=1e-6, rtol=0)
    for a, b in zip(ours.post_quant, want["post_quant"]):
        np.testing.assert_array_equal(a.numpy(), b)
    again, _ = _run(sd.main, _sd_argv(tmp_path / "b", "--embeddings", emb,
                                      "--restore_from", native), capsys)
    for name in ("unet", "encoder", "decoder"):
        a = getattr(ours, name).module.state_dict()
        b = getattr(again, name).module.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(ours.post_quant,
                                                 again.post_quant))
    assert (tmp_path / "a" / "sdedit.png").read_bytes() == (
        tmp_path / "b" / "sdedit.png").read_bytes()


def _png(path):
    return path.read_bytes()


def test_sd_prompt_equals_its_embeddings(capsys, tmp_path, monkeypatch):
    """``--prompt`` through a CLIP snapshot in the hub cache, then
    ``--embeddings`` of the pair that ``encode_prompts`` gives: the same
    PNG, byte for byte."""
    from sige_torch.models.sd.clip import CLIPTextConfig, encode_prompts

    cfg = CLIPTextConfig(vocab_size=514 + 300, hidden_size=16,
                         intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2)
    snap = (tmp_path / "hub" / "models--openai--clip-vit-large-patch14" /
            "snapshots" / "0")
    chip_smoke.write_clip_snapshot(
        str(snap), cfg, chip_smoke.clip_text_state(cfg, 1, device="cpu"), 1)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    prompt = "a church at dusk, 2 towers"
    _, out = _run(sd.main, _sd_argv(tmp_path / "a", "--prompt", prompt),
                  capsys)
    _has(out, r"^saved .*sdedit\.png$")
    pair = encode_prompts(["", prompt], device="cpu").numpy()
    assert pair.shape == (2, 77, 16) and not np.allclose(pair[0], pair[1])
    emb = str(tmp_path / "emb.npz")
    np.savez(emb, uc=pair[:1], c=pair[1:])
    _run(sd.main, _sd_argv(tmp_path / "b", "--embeddings", emb), capsys)
    assert _png(tmp_path / "a" / "sdedit.png") == _png(
        tmp_path / "b" / "sdedit.png")


@pytest.mark.parametrize("flag", [True, False], ids=["flagged", "clean"])
def test_sd_safety_model(capsys, tmp_path, sd_reference, flag):
    """A checker snapshot whose concept 0 has threshold -1 flags every
    sample (blacked out, then watermarked); at threshold 1 none (the PNG
    equals the unscreened run's)."""
    from sige_torch.models.sd.safety import CLIPVisionConfig

    _, emb, _, _, _ = sd_reference
    vcfg = CLIPVisionConfig(hidden_size=16, intermediate_size=32,
                            num_hidden_layers=2, num_attention_heads=2,
                            patch_size=14)
    state = chip_smoke.safety_state(vcfg, 8, 2, device="cpu")
    state["concept_embeds_weights"][0] = -1.0 if flag else 1.0
    chip_smoke.write_safety_snapshot(str(tmp_path / "safety"), vcfg, 8,
                                     state)
    _, out = _run(sd.main, _sd_argv(
        tmp_path / "a", "--embeddings", emb, "--safety_model",
        str(tmp_path / "safety"), "--no_watermark"), capsys)
    assert "WARNING: no --safety_model" not in out
    assert ("NSFW concept detected" in out) == flag
    _run(sd.main, _sd_argv(tmp_path / "b", "--embeddings", emb,
                           "--no_watermark"), capsys)
    from sige_torch.data import load_image

    img = load_image(str(tmp_path / "a" / "sdedit.png"))
    if flag:
        assert (img == 0).all()
    else:
        assert _png(tmp_path / "a" / "sdedit.png") == _png(
            tmp_path / "b" / "sdedit.png")


# --- devices and the demo server ------------------------------------------

def test_command_lines_need_a_gpu_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (diffusion.main, ["--config_path",
                              "configs/church_ddpm256-sige.yml", "--synthetic",
                              "--hparams", DDPM_TINY_HPARAMS]),
            (gaugan.main, ["--synthetic", *GAUGAN_TINY]),
            (sd.main, ["--task", "sdedit", "--synthetic", "--hparams",
                       SD_HPARAMS, "--save_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    for get in (diffusion.get_args, gaugan.get_args):
        assert get(["--config_path", "x"] if get is diffusion.get_args
                   else []).device == "cuda"
    assert sd.get_args(["--task", "sdedit"]).device == "cuda"


def test_demo_server_restores_a_checkpoint(tmp_path):
    R = 32
    args = ["--tiny", "--resolution", str(R), "--sample_steps", "4",
            "--device", "cpu"]
    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=R,
                         sparse_resolution_threshold=R)
    pth, ref = _write_reference(tmp_path, "fused", "ddpm",
                                lambda: SIGEFusedUNet(cfg))
    from sige_torch.utils.checkpoint import save_params
    from sige_torch.utils.convert import convert_ddpm_fused_unet

    want = convert_ddpm_fused_unet(ref, cfg.ch_mult, cfg.num_res_blocks,
                                   cfg.attn_resolutions, R)
    native = save_params(str(tmp_path / "native"), want)
    for path in (pth, native):
        runner, _ = server.build(server.parse_args(args + ["--restore_from",
                                                           path]))
        got = runner.module.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert os.path.isdir(native)
