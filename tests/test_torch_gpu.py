"""Tests that need the card: the hand-written CUDA kernels against their
plain PyTorch twins, and tiny models on the card against the same models
on the CPU, under PyTorch's default precision flags (the engine holds
fp32 itself). They import nothing of JAX (the machine with the card has
none) and skip without a CUDA device. On that machine:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest``: the suite's conftest.py sets JAX up.)
"""

import numpy as np
import pytest
import torch

from sige_torch.core.masks import dilate_mask, downsample_mask
from sige_torch.nn.engine import (fp32_scope, precision_flags,
                                  set_precision_flags)
from sige_torch.ops import flash


def _pytorch_defaults():
    """PyTorch's default precision flags, in the API the engine uses:
    cuDNN convs in TF32, matmuls in fp32, no benchmark mode, a benchmark
    limit of 10."""
    if hasattr(torch.backends.cudnn, "conv"):
        return ("tf32", "none", False, 10)
    return ("tf32", "ieee", False, 10)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _held_to_fp64(got, q, k, v, bias):
    """The attention kernel's output ``got`` against the plain version in
    fp64: max |got - fp64| / max |fp64| at most 1e-5, and the plain
    version with one TF32 product per inner product (every operand of
    both products rounded to TF32; cuBLAS's own TF32 path skips small
    shapes) at least 10x further off, so the kernel's accuracy is not
    TF32's; returns the error."""
    scale = q.shape[-1] ** -0.5
    want = flash.flash_mha_plain(q.double(), k.double(), v.double(), scale,
                                 None if bias is None else bias.double())
    den = want.abs().max()
    err = ((got.double() - want).abs().max() / den).item()
    with fp32_scope():
        s = torch.einsum("bnhd,bmhd->bhnm", _tf32(q), _tf32(k)) * scale
        p = torch.softmax(flash._add_bias(s, bias), dim=-1)
        tf32 = torch.einsum("bhnm,bmhd->bnhd", _tf32(p), _tf32(v))
    assert err <= 1e-5
    assert ((tf32.double() - want).abs().max() / den).item() >= 10 * err
    return err


def _qkv_bias(gen, B, N, M, H, D, rows, p=0.3):
    """Random q, k, v and a 0 / -1e9 key bias of ``rows`` rows ([M] for
    1, none for 0) on the card."""
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    if not rows:
        return q, k, v, None
    bias = torch.where(torch.rand(rows, M, generator=gen, device="cuda") < p,
                       -1e9, 0.0)
    return q, k, v, bias[0] if rows == 1 else bias


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D,rows", [
    (1, 256, 256, 1, 512, 0),    # DDPM 16 px (SIMT kernel)
    (1, 64, 64, 1, 512, 0),      # DDPM 8 px mid block (SIMT kernel)
    (2, 100, 77, 2, 80, 1),      # ragged N and M, key bias
    (1, 130, 300, 3, 40, 1),
    (8, 1024, 1024, 20, 64, 0),  # SDXL dense middle, 32^2
    (8, 900, 4996, 10, 64, 4),   # SDXL masked 64^2, S = 4
    (8, 324, 1348, 20, 64, 4),   # SDXL masked 32^2, S = 4
    (8, 900, 77, 10, 64, 0),     # SDXL cross-attention
    (2, 4096, 4096, 8, 40, 0),   # (c) SD 64^2 self-attention
    (8, 324, 1348, 8, 80, 4),    # SD stacked S = 4, masked 32^2
    (8, 196, 452, 8, 160, 4),    # SD stacked S = 4, masked 16^2
    (3, 77, 61, 1, 8, 0),        # the narrowest tensor-core head
    (2, 130, 301, 2, 256, 1),    # the widest
    (2, 60, 90, 2, 36, 1),       # not a multiple of 8: SIMT kernel
])
def test_kernel_matches_plain_twin_on_card(B, N, M, H, D, rows):
    """The attention kernel D takes against the plain version in fp64
    (:func:`_held_to_fp64`); the tensor-core counter moves for every D
    that is a multiple of 8 up to 256 and for no other."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernel runs only on a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, bias = _qkv_bias(gen, B, N, M, H, D, rows)
    before = flash.flash_mha.launches, flash.flash_mha.tc_launches
    got = flash.flash_mha(q, k, v, D ** -0.5, bias)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == before[0] + 1
    tc = D % 8 == 0 and D <= 256
    assert flash.flash_mha.tc_launches == before[1] + tc
    _held_to_fp64(got, q, k, v, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D", [
    (1, 256, 256, 1, 512),   # DDPM 16 px: 8 tiles
    (1, 64, 300, 1, 512),    # ragged M: the last split's tile holds 12 keys
    (2, 100, 256, 2, 40),
    (1, 70, 77, 3, 40),      # 3 tiles, the last one of 13 keys
    (2, 130, 301, 2, 64),    # N past a 128-row block, M past a 32-key tile
    (1, 70, 77, 3, 160),     # 3 tiles, the last one of 13 keys
    (1, 70, 77, 2, 256),     # 5 tiles of 16 keys, the last one of 13
    (2, 65, 200, 1, 80),     # N one past a 64-row block
])
@pytest.mark.parametrize("which", ["one", "two", "max"])
@pytest.mark.parametrize("dead_split", [False, True])
def test_forced_splits_match_plain_twin_on_card(B, N, M, H, D, which,
                                                dead_split):
    """The attention kernel with S = 1, 2 or every key tile its own key
    range (the combine kernel merging S > 1), against the plain version
    in fp64; with ``dead_split`` every key of split 1 (of S = 2 or max)
    carries -1e9."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    tiles = -(-M // flash.block_k(D))
    splits = {"one": 1, "two": 2, "max": tiles}[which]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, _ = _qkv_bias(gen, B, N, M, H, D, 0)
    bias = None
    if dead_split:
        bias = torch.zeros(M, device="cuda")
        kb, ke = flash._split_bounds(M, D, max(splits, 2))[1]
        bias[kb:ke] = -1e9
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    got = flash._launch(q, k, v, D ** -0.5, bias, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == launches + 1
    assert flash.flash_mha.combine_launches == combines + (splits > 1)
    _held_to_fp64(got, q, k, v, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D,S", [
    (4, 120, 1144, 8, 40, 2),   # SD U-Net masked self-attention, 2 a session
    (8, 120, 1144, 8, 40, 4),
    (6, 48, 304, 5, 80, 3),     # ragged M, 3 sessions
    (2, 64, 1088, 1, 512, 2),   # SD decoder's mid attention, 1 a session
    (3, 100, 77, 2, 80, 3),
    (8, 196, 452, 8, 160, 4),   # SD U-Net masked 16^2, 4 sessions
    (8, 324, 1348, 20, 64, 4),  # SDXL masked 32^2, 4 sessions
])
@pytest.mark.parametrize("which", ["auto", "one", "max"])
def test_session_bias_rows_match_plain_twin_on_card(B, N, M, H, D, S, which):
    """A key bias of one row per session ([S, M], batch row b reading row
    b // (B / S)) through the attention kernel, split by the wrapper's
    rule, not split, or split into every tile, against the plain version
    in fp64;
    every session's row kills other keys, so a row read for the wrong
    session shows."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    bias = torch.where(torch.rand(S, M, generator=gen, device="cuda") < 0.4,
                       -1e9, 0.0)
    splits = {"auto": None, "one": 1, "max": -(-M // flash.block_k(D))}[which]
    launches = flash.flash_mha.launches
    got = flash._launch(q, k, v, D ** -0.5, bias, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == launches + 1
    _held_to_fp64(got, q, k, v, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D", [(2, 100, 77, 2, 80),
                                       (1, 64, 1088, 1, 512),
                                       (2, 900, 77, 4, 64)])
def test_shared_bias_row_forms_agree_bit_for_bit_on_card(B, N, M, H, D):
    """One shared key bias given as [M] or as [1, M] launches the same
    kernel on the same bytes: the outputs are equal bit for bit; a bias
    whose rows do not divide the batch, or that is not contiguous, is
    refused before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    bias = torch.where(torch.rand(M, generator=gen, device="cuda") < 0.3,
                       -1e9, 0.0)
    a = flash.flash_mha(q, k, v, D ** -0.5, bias)
    b = flash.flash_mha(q, k, v, D ** -0.5, bias[None])
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    launches = flash.flash_mha.launches
    for bad in (torch.zeros(B + 1, M, device="cuda"),
                torch.zeros(M, 2, device="cuda").t()):
        with pytest.raises(ValueError):
            flash.flash_mha(q, k, v, D ** -0.5, bad)
    assert flash.flash_mha.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 64, 160, 512])
def test_split_path_matches_plain_split_on_card(D):
    """The attention kernel's partials merged by the combine kernel,
    against the plain split path (partials per key range, then the plain
    combine) at the same split count."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    B, N, M, H, splits = 1, 48, 256, 2, 8
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    combines = flash.flash_mha.combine_launches
    got = flash._launch(q, k, v, D ** -0.5, None, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.combine_launches == combines + 1
    with fp32_scope():
        want = flash.flash_mha_plain_split(q, k, v, D ** -0.5, None, splits)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("v_org,ext", [((3, 4), (6, 7)),     # 2-form meta
                                       ((-1, 9), (6, 7)),    # border
                                       ((-1, -1), (14, 16))  # wider
                                       ])
def test_window_ops_card_match_cpu(v_org, ext):
    """Each window op on CUDA tensors against the same op on the CPU
    (which the CPU tests hold against sige_tpu), on a one-session plan's
    products ([1, k] metas and origins, [1, h, w] masks)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.nn.planner import _window_meta
    from sige_torch.ops import window as w

    H, W, C = 12, 14, 5
    meta, edge = _window_meta(v_org, ext, (H, W))
    WH, WW = ext[0] - 2, ext[1] - 2
    org = (max(v_org[0] + 1, 0), max(v_org[1] + 1, 0))
    WH, WW = min(WH, H - org[0]), min(WW, W - org[1])
    gen = torch.Generator().manual_seed(0)
    x, cache, y1 = (torch.randn(1, H, W, C, generator=gen) for _ in range(3))
    win, short = (torch.randn(1, WH, WW, C, generator=gen) for _ in range(2))
    scale, shift = (torch.randn(1, C, generator=gen) for _ in range(2))
    cov = torch.rand(WH, WW, generator=gen) < 0.6
    cov_s = torch.rand(WH, WW, generator=gen) < 0.4
    edge = torch.from_numpy(edge)

    def run(dev):
        d = lambda t: t.to(dev)  # noqa: E731
        one = lambda t: d(t)[None]  # noqa: E731  (a stack of one session)
        m = one(torch.from_numpy(meta.astype(np.int64)))
        o = one(torch.tensor(org))
        ring, c, c_s = one(edge), one(cov), one(cov_s)
        outs = [
            w.window_gather(d(x), m, ring, d(scale), d(shift), "swish"),
            w.window_chain_extend(d(win), o, d(cache), m, ring,
                                  d(scale), d(shift), "swish"),
            w.window_scatter(d(win), d(cache), o, c, d(x)),
            w.window_state_materialize(d(cache), d(win), o),
            w.window_scatter_block_residual(d(win), d(cache), d(short),
                                            d(y1), o, c, c_s),
        ]
        if (WH, WW) == (ext[0] - 2, ext[1] - 2):
            outs.append(w.window_scatter_gather(
                d(win), d(cache), m, ring, c, (1, 1), d(scale),
                d(shift), "swish"))
        return [o_.cpu() for o_ in outs]

    for got, want in zip(run("cuda"), run("cpu")):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [True, False])
def test_tiny_window_unet_card_matches_cpu(chain):
    """A tiny DDPM U-Net in the window layout (chains on and off) on the
    card against the same U-Net on the CPU; its attention runs the flash
    kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    _card_vs_cpu(*_tiny_ddpm(chain), bucket_min=2)


def _tiny_ddpm(chain=True, **kw):
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet

    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=16, window_chain=chain,
                         **kw)
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))
    mask = np.zeros((32, 32), bool)
    mask[10:18, 12:22] = True
    x1 = x0 + 0.5 * torch.from_numpy(mask)[None, :, :, None]
    t = torch.full((1,), 5.0)
    return (lambda: SIGEFusedUNet(cfg), (x0, t), (x1, t),
            downsample_mask(dilate_mask(mask, 2), min_res=8))


def _card_vs_cpu(make, args0, args1, masks, bucket_min=1, attention=True,
                 layout="window"):
    """full, sparse(edit), sparse(original) of one model on the card and
    on the CPU (the same seeded weights), in ``layout``, under the
    caller's precision flags; the card's sparse forwards launch the flash
    kernel (``attention``) or none (GauGAN)."""
    from sige_torch.nn import SIGEModel

    outs = {}
    for dev in ("cpu", "cuda"):
        model = SIGEModel(make(), layout=layout, bucket_min=bucket_min,
                          device=dev)
        model.init(0)
        a0 = [a.to(dev) for a in args0]
        a1 = [a.to(dev) for a in args1]
        full = model.full(*a0)
        model.set_masks(masks)
        before = flash.flash_mha.launches
        outs[dev] = [full.cpu(), model.sparse(*a1).cpu(),
                     model.sparse(*a0).cpu()]
        if dev == "cuda":
            assert (flash.flash_mha.launches > before) == attention
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4
    assert (outs["cuda"][2] - outs["cuda"][0]).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [True, False])
def test_tiny_sd_unet_card_matches_cpu(chain):
    """The tiny SD U-Net of tests/test_sd.py at batch 2 (guidance): its
    self- and cross-attentions (masked stale/fresh with the chain) run
    the flash kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    _card_vs_cpu(*_tiny_sd_unet(chain))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tiles", "window"])
@pytest.mark.parametrize("kv", [1, 200])
def test_tiny_kv_cache_sd_unet_card_matches_cpu(kv, layout):
    """The tiny SD U-Net with K/V-cached transformers (``kv=1``: every
    sparse level; 200: the 16 px level only, 256 tokens against 64)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    _card_vs_cpu(*_tiny_sd_unet(kv_cache_min_tokens=kv), layout=layout)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_tiny_sd_vae_card_matches_cpu(kind):
    """The tiny SD VAE of tests/test_sd.py: the mid block's masked
    stale/fresh attention runs the flash kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    _card_vs_cpu(*_tiny_sd_vae(kind))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_tiny_sd_vae_tile_chain_card_matches_cpu(kind):
    """The tiny SD VAE's tile-resident chain (``tile_chain``, tile
    layout)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    _card_vs_cpu(*_tiny_sd_vae(kind, tile_chain=True), layout="tiles")


def _tiny_sd_vae(kind, **kw):
    from sige_torch.models.sd import SDVAEConfig, SIGEDecoder, SIGEEncoder

    cfg = SDVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), z_channels=4, resolution=32,
                      num_groups=8, **kw)
    mask = np.zeros((32, 32), bool)
    mask[8:13, 10:16] = True
    gen = torch.Generator().manual_seed(4)
    if kind == "encoder":
        x0, m, make = torch.randn(1, 32, 32, 3, generator=gen), mask, \
            lambda: SIGEEncoder(cfg)
    else:
        x0, m, make = torch.randn(1, 16, 16, 4, generator=gen), \
            mask[::2, ::2], lambda: SIGEDecoder(cfg)
    x1 = x0 + 0.7 * torch.from_numpy(m)[None, :, :, None] * torch.randn(
        x0.shape, generator=gen)
    return make, (x0,), (x1,), downsample_mask(dilate_mask(mask, 1),
                                               min_res=4)


@pytest.mark.gpu
def test_tiny_clip_text_card_matches_cpu(tmp_path):
    """A tiny CLIP text encoder from a synthetic snapshot: the card's
    ``encode_prompts`` against the CPU's, under PyTorch's default flags
    (the encoder holds fp32 itself and restores them)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    import chip_smoke
    from sige_torch.models.sd.clip import CLIPTextConfig, encode_prompts

    cfg = CLIPTextConfig(vocab_size=514 + 300, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4)
    chip_smoke.write_clip_snapshot(
        str(tmp_path), cfg, chip_smoke.clip_text_state(cfg, 0, "cpu"), 0)
    prompts = ["", "a church at dusk, 2 towers", "x" * 200]
    saved = precision_flags()
    try:
        set_precision_flags(_pytorch_defaults())
        got = encode_prompts(prompts, model_path=str(tmp_path),
                             device="cuda")
        assert precision_flags() == _pytorch_defaults()
    finally:
        set_precision_flags(saved)
    want = encode_prompts(prompts, model_path=str(tmp_path), device="cpu")
    assert got.device.type == "cuda" and got.shape == (3, 77, 32)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_tiny_safety_checker_card_matches_cpu(tmp_path):
    """A tiny safety checker from a synthetic snapshot whose seeded
    thresholds split two images: pooled features card = CPU (<= 1e-4),
    the same verdicts, under PyTorch's default flags."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    import chip_smoke
    from sige_torch.models.sd.safety import (CLIPVisionConfig, SafetyChecker,
                                             preprocess_images)

    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           patch_size=14)
    state = chip_smoke.safety_state(cfg, 16, 0, "cpu")
    images = np.random.default_rng(5).random((2, 512, 384, 3)).astype(
        np.float32)
    trunk = chip_smoke.vision_trunk(state, cfg)
    with torch.inference_mode():
        pv = preprocess_images(images, device="cpu").permute(0, 3, 1, 2)
        embeds = trunk(pv).pooler_output @ state["visual_projection.weight"].T
    chip_smoke.split_thresholds(state, embeds)
    chip_smoke.write_safety_snapshot(str(tmp_path), cfg, 16, state)
    saved = precision_flags()
    out = {}
    try:
        set_precision_flags(_pytorch_defaults())
        for dev in ("cuda", "cpu"):
            checker = SafetyChecker.from_pretrained(str(tmp_path), device=dev)
            with torch.inference_mode(), fp32_scope():
                pooled = checker.vision_fn(preprocess_images(images,
                                                             device=dev))
            out[dev] = (pooled.cpu(), checker(images))
        assert precision_flags() == _pytorch_defaults()
    finally:
        set_precision_flags(saved)
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-4
    assert out["cuda"][1][1] == out["cpu"][1][1] == [True, False]
    np.testing.assert_array_equal(out["cuda"][1][0], out["cpu"][1][0])


def _tiny_pd(chain=True, **kw):
    """tests/test_pd.py's TINY PD U-Net: the window chain crosses its
    resampling resblocks; 4-head attention in the middle block."""
    from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet

    cfg = PDUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                       attn_resolutions=(8,), resolution=32, temb_ch=64,
                       head_dim=16, sparse_resolution_threshold=16,
                       window_chain=chain, **kw)
    gen = torch.Generator().manual_seed(6)
    x0 = torch.randn(1, 32, 32, 3, generator=gen)
    mask = np.zeros((32, 32), bool)
    mask[8:16, 10:20] = True
    x1 = x0 + 0.5 * torch.from_numpy(mask)[None, :, :, None] * torch.randn(
        1, 32, 32, 3, generator=gen)
    ls = torch.tensor([1.3])
    return (lambda: SIGEPDUNet(cfg), (x0, ls), (x1, ls),
            downsample_mask(dilate_mask(mask, 2), min_res=4))


@pytest.mark.gpu
@pytest.mark.parametrize("chain", [True, False])
def test_tiny_pd_unet_card_matches_cpu(chain):
    """The tiny PD U-Net, window layout: pre-pool and up2 chains, and its
    multi-head attention on the flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    _card_vs_cpu(*_tiny_pd(chain))


def _tiny_gaugan(kind):
    """tests/test_gaugan.py's TINY SPADE generator (fused, with the window
    chain across its upsamples) or its sub-mobile one (depthwise convs,
    the InstanceNorm fold), with BatchNorm running statistics away from 0
    and 1; the one-hot semantics of a random label map and an edited
    box."""
    from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                          SIGESubMobileSPADEGenerator,
                                          SPADEGenConfig)
    from sige_torch.runners import GauGANRunConfig, GauGANRunner

    cfg = SPADEGenConfig(ngf=8, semantic_nc=6, crop_size=64,
                         num_upsampling_layers="normal")

    def make():
        module = (SIGEFusedSPADEGenerator(cfg) if kind == "fused" else
                  SIGESubMobileSPADEGenerator(cfg, (4, 4, 4, 6, 4, 3, 3, 4)))
        gen = torch.Generator().manual_seed(8)
        for name, buf in module.named_buffers():
            buf.copy_(0.5 * torch.randn(buf.shape, generator=gen)
                      if name.endswith("mean") else
                      0.5 + torch.rand(buf.shape, generator=gen))
        return module

    rng = np.random.default_rng(0)
    l0 = rng.integers(0, 4, (32, 64))
    l1 = l0.copy()
    l1[8:14, 16:26] = 4
    runner = GauGANRunner(cfg, GauGANRunConfig(input_nc=5), device="cpu")
    s0, s1 = (torch.from_numpy(runner.preprocess_input(lab))
              for lab in (l0, l1))
    mask = (s0 != s1).any(-1)[0].numpy()
    return (make, (s0,), (s1,),
            downsample_mask(dilate_mask(mask, 1), min_res=(1, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fused", "sub_mobile"])
def test_tiny_gaugan_card_matches_cpu(kind):
    """The tiny GauGAN generators, window layout, under PyTorch's default
    precision flags: the engine holds fp32 for the SPADE convs and the
    depthwise convs (cuDNN's grouped path); no flash launch."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    saved = precision_flags()
    try:
        set_precision_flags(_pytorch_defaults())
        _card_vs_cpu(*_tiny_gaugan(kind), attention=False)
        assert precision_flags() == _pytorch_defaults()
    finally:
        set_precision_flags(saved)


def _tiny_sd_unet(chain=True, **kw):
    from sige_torch.models.sd import SDUNetConfig, SIGESDUNet

    cfg = SDUNetConfig(in_channels=4, model_channels=32, out_channels=4,
                       num_res_blocks=1, attention_resolutions=(1, 2),
                       channel_mult=(1, 2), num_heads=4, context_dim=16,
                       num_groups=8, window_chain=chain, **kw)
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn(2, 16, 16, 4, generator=gen)
    mask = np.zeros((16, 16), bool)
    mask[4:9, 5:11] = True
    x1 = x0 + torch.from_numpy(mask)[None, :, :, None] * torch.randn(
        2, 16, 16, 4, generator=gen)
    t = torch.full((2,), 3.0)
    c = torch.randn(2, 7, 16, generator=gen)
    return (lambda: SIGESDUNet(cfg), (x0, t, c), (x1, t, c),
            downsample_mask(dilate_mask(mask, 1), min_res=4))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["ddpm", "sd_unet", "pd"])
def test_engine_holds_fp32_under_pytorch_default_flags(model):
    """PyTorch's defaults run cuDNN convs in TF32. First the test shows
    that it can see that: the port's conv (NHWC, a channels_last view) at
    the tiny models' widths, called bare, differs from the CPU by more
    than 1e-4 under those defaults. Then the tiny model, run under the
    same defaults, matches the CPU at 1e-4, because the engine holds fp32
    for its own forwards; the defaults are the caller's again
    afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.ops.conv import conv2d_nhwc

    saved = precision_flags()
    defaults = _pytorch_defaults()
    try:
        set_precision_flags(defaults)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(1, 16, 16, 32, generator=gen)
        w = torch.randn(64, 32, 3, 3, generator=gen)
        b = torch.zeros(64)
        bare = conv2d_nhwc(x.cuda(), w.cuda(), b.cuda(), padding=1).cpu()
        tf32_err = (bare - conv2d_nhwc(x, w, b, padding=1)).abs().max().item()
        assert tf32_err > 1e-4, f"TF32 not visible: {tf32_err:.3e}"
        make = {"ddpm": _tiny_ddpm, "sd_unet": _tiny_sd_unet,
                "pd": _tiny_pd}[model]
        _card_vs_cpu(*make())
        assert precision_flags() == defaults
    finally:
        set_precision_flags(saved)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["ddim", "dpm_solver"])
def test_tiny_demo_runner_card_matches_cpu(sampler):
    """The tiny demo runner (per-step cache slots, sparse-only edits,
    apply, a second edit over the applied caches) on the card against the
    same runner on the CPU, under PyTorch's default precision flags: the
    engine holds fp32 for its own forwards."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.demo import DemoRunner
    from sige_torch.models.ddpm import DDPMUNetConfig

    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=32)
    rng = np.random.default_rng(0)
    base = rng.random((32, 32, 3)).astype(np.float32)
    e1 = base.copy()
    e1[10:18, 12:20] = 0.9
    e2 = e1.copy()
    e2[20:26, 4:12] = 0.1
    saved = precision_flags()
    outs = {}
    try:
        set_precision_flags(_pytorch_defaults())
        for dev in ("cpu", "cuda"):
            runner = DemoRunner(cfg, sample_steps=4, noise_level=40,
                                total_steps=100, mask_dilate_radius=2,
                                bucket_min=1, sampler_type=sampler,
                                device=dev)
            before = flash.flash_mha.launches
            outs[dev] = [runner.reset_base_image(base), runner.generate(e1),
                         runner.generate(e1, sparse_update=True),
                         runner.generate(e2)]
            if dev == "cuda":
                assert flash.flash_mha.launches > before
        assert precision_flags() == _pytorch_defaults()
    finally:
        set_precision_flags(saved)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert np.abs(got - want).max() <= 1e-4


_CLI_TINY = {  # tests/test_cli.py's tiny shapes, through each command line
    "diffusion": ["--config_path", "configs/church_ddim256-sige.yml",
                  "--synthetic", "--hparams",
                  "model.ch=16 model.ch_mult=1,2 model.num_res_blocks=1 "
                  "model.attn_resolutions=16 "
                  "model.sparse_resolution_threshold=32 model.num_groups=8 "
                  "data.image_size=32 sampling.sample_steps=2 "
                  "sampling.noise_level=100"],
    "gaugan": ["--synthetic", "--ngf", "16", "--crop_size", "128",
               "--num_sparse_layers", "2"],
    "sd": ["--task", "sdedit", "--synthetic", "--H", "64", "--W", "64",
           "--ddim_steps", "4", "--strength", "0.5", "--hparams",
           "unet.model_channels=8 unet.channel_mult=1,2 "
           "unet.attention_resolutions=2 unet.num_heads=2 "
           "unet.context_dim=16 unet.num_groups=4 vae.ch=8 vae.ch_mult=1,2 "
           "vae.num_groups=4"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("cli", sorted(_CLI_TINY))
def test_command_line_defaults_to_the_card(cli, tmp_path):
    """Each command line runs on the card by default and on the CPU with
    ``--device cpu``."""
    if not torch.cuda.is_available():
        pytest.skip("the default device is the CUDA device")
    import importlib

    main = importlib.import_module(f"sige_torch.cli.{cli}").main
    argv = _CLI_TINY[cli] + ["--save_dir", str(tmp_path)]
    for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
        runner = main(argv + extra)
        assert runner.device.type == want
        models = ([runner.unet, runner.encoder, runner.decoder]
                  if cli == "sd" else [runner.model])
        for model in models:
            assert all(p.device.type == want
                       for p in model.module.parameters())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_bf16_caches_card_matches_cpu(layout):
    """``cache_dtype=torch.bfloat16`` on the tiny DDPM U-Net: on the card,
    bf16 storage gives what fp32 storage of the same rounded values gives
    (within 1e-5: only storage narrows, the casts ride in the copies), and
    with the CPU's bf16 caches the card's sparse forward and commit agree
    with the CPU's (1e-4; the committed caches within one bf16 step and
    1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.nn import SIGEModel

    make, args0, args1, masks = _tiny_ddpm(cache_slots=2)
    models, outs = {}, {}
    for name, dev, dtype in (("cpu", "cpu", torch.bfloat16),
                             ("card", "cuda", torch.bfloat16),
                             ("wide", "cuda", None)):
        model = SIGEModel(make(), layout=layout, bucket_min=1,
                          cache_dtype=dtype, device=dev)
        model.init(0)
        for k in range(2):
            model.full(*[a.to(dev) for a in args0], cache_id=k)
        models[name] = model
    for name in ("card", "wide"):  # the CPU's rounded caches, on the card
        for path, slots in models["cpu"].state.caches.items():
            for k, d in enumerate(slots):
                for key, v in d.items():
                    models[name].state.caches[path][k][key] = v.to(
                        "cuda", None if name == "card" else torch.float32)
    for name, model in models.items():
        dev = model.device
        model.set_masks(masks)
        a0, a1 = ([a.to(dev) for a in args] for args in (args0, args1))
        outs[name] = [model.sparse(*a1, cache_id=0).cpu(),
                      model.sparse(*a1, cache_id=1, sparse_update=True).cpu(),
                      model.sparse(*a0, cache_id=0).cpu()]
    for got, wide, want in zip(outs["card"], outs["wide"], outs["cpu"]):
        assert (got - wide).abs().max().item() <= 1e-5
        assert (got - want).abs().max().item() <= 1e-4
    card, cpu = (models[n].state.tensors(1) for n in ("card", "cpu"))
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            # bf16 roundings of values within 1e-4: half a bf16 step each
            # (2 ** -8 relative) plus the fp32 difference
            a, b = a.cpu().float(), b.float()
            assert ((a - b).abs() <= 2 ** -7 * torch.maximum(a.abs(), b.abs())
                    + 1e-4).all()


def _tiny_family(family):
    """(make, args0, args1, masks, attention) of one tiny model per
    family, with two cache slots where the config has them."""
    if family == "ddpm":
        return (*_tiny_ddpm(cache_slots=2), True)
    if family == "pd":
        return (*_tiny_pd(cache_slots=2), True)
    if family == "sd_unet":
        return (*_tiny_sd_unet(cache_slots=2), True)
    if family == "sd_decoder":
        return (*_tiny_sd_vae("decoder", cache_slots=2), True)
    return (*_tiny_gaugan("fused"), False)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ddpm", "pd", "sd_unet", "sd_decoder",
                                    "gaugan"])
def test_sparse_update_card_matches_cpu(family):
    """One tiny model of each family, window layout: full passes on its
    slots, an edit committed into the last, the committed edit replayed,
    and slot 0's replay of its original, on the card against the CPU
    (1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.nn import SIGEModel

    make, args0, args1, masks, attention = _tiny_family(family)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = SIGEModel(make(), layout="window", bucket_min=1, device=dev)
        model.init(0)
        a0, a1 = ([a.to(dev) for a in args] for args in (args0, args1))
        last = model.cache_slots - 1
        out = [model.full(*a0, cache_id=k).cpu() for k in range(last + 1)]
        model.set_masks(masks)
        before = flash.flash_mha.launches
        out += [model.sparse(*a1, cache_id=last, sparse_update=True).cpu(),
                model.sparse(*a1, cache_id=last).cpu(),
                model.sparse(*a0, cache_id=0).cpu()]
        if dev == "cuda":
            assert (flash.flash_mha.launches > before) == attention
        outs[dev] = out
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4
    card = outs["cuda"]
    assert (card[-2] - card[-3]).abs().max().item() <= 1e-4  # the commit
    if len(card) == 5:  # two slots: slot 0 kept its full pass
        assert (card[-1] - card[0]).abs().max().item() <= 1e-4


@pytest.fixture(scope="module")
def metric_weights(tmp_path_factory):
    """Synthetic metric checkpoints (``chip_smoke.metric_weights``),
    written only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("the metric backbones run on the card here")
    import chip_smoke

    return chip_smoke.metric_weights(str(tmp_path_factory.mktemp("metric")))


def _metric_wrapper(kind, w, device):
    from sige_torch.metrics import LPIPS
    from sige_torch.metrics.backbones import CityscapesSegmenter, FIDInception
    from sige_torch.utils.convert import load_torch_state_dict

    if kind == "alexnet":
        return LPIPS(w["backbone_weights"], w["lpips_weights"],
                     device=device)._impl
    if kind == "inception":
        return FIDInception(load_torch_state_dict(w["inception_weights"]),
                            device=device)
    return CityscapesSegmenter(load_torch_state_dict(w["drn_weights"]),
                               device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["alexnet", "inception", "drn"])
def test_metric_backbones_card_match_cpu_float64(kind, metric_weights):
    """Each metric backbone on the card (fp32, under PyTorch's default
    flags: the wrappers hold fp32 themselves) against the same module in
    float64 on the CPU, within 1e-4 * max(1, max|ref|): AlexNet's taps at
    64^2, InceptionV3's features from 2 images of 80x96 (resized to 299),
    DRNSeg's logits at 64x96."""
    import chip_smoke

    card = _metric_wrapper(kind, metric_weights, "cuda")
    ref = chip_smoke.on_cpu_float64(card)
    rng = np.random.default_rng(3)
    flags = precision_flags()
    if kind == "alexnet":
        x = rng.random((64, 64, 3)).astype(np.float32) * 2 - 1
        pairs = list(zip(card.features(x), ref.features(x)))
    elif kind == "inception":
        x = rng.random((2, 80, 96, 3)).astype(np.float32)
        pairs = [(card(x), ref(x))]
    else:
        x = rng.random((64, 96, 3)).astype(np.float32)
        pairs = [(card.logits(x).cpu().numpy(), ref.logits(x).numpy())]
    assert precision_flags() == flags
    for got, want in pairs:
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.gpu
def test_get_metric_card_equals_cpu(tmp_path, metric_weights, capsys):
    """``cli.get_metric`` on the card and with ``--device cpu`` over the
    same small directories: PSNR and mIoU (through the DRN) lines equal,
    LPIPS within 1e-4 and FID within 1e-3 relative."""
    from sige_torch.cli import get_metric
    from sige_torch.data import save_image

    w = metric_weights
    rng = np.random.default_rng(4)
    for sub in ("a", "b", "labels"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        img = rng.random((48, 64, 3)).astype(np.float32)
        save_image(str(tmp_path / "a" / f"{i}.png"), img)
        save_image(str(tmp_path / "b" / f"{i}.png"),
                   np.clip(img + 0.1 * rng.standard_normal(img.shape), 0, 1))
        np.save(tmp_path / "labels" / f"{i}.npy", rng.integers(0, 34, (48, 64)))
    base = ["--root", str(tmp_path / "a"), "--gt_root", str(tmp_path / "b")]
    runs = {"psnr": base, "lpips": base + [
                "--backbone_weights", w["backbone_weights"],
                "--lpips_weights", w["lpips_weights"]],
            "fid": base + ["--inception_weights", w["inception_weights"]],
            "miou": ["--root", str(tmp_path / "a"), "--gt_root",
                     str(tmp_path / "labels"), "--drn_weights",
                     w["drn_weights"]]}
    for metric, argv in runs.items():
        got = {}
        for device in ("cuda", "cpu"):
            value = get_metric.main(["--metric", metric, *argv, "--device",
                                     device])
            got[device] = (value, capsys.readouterr().out)
        (card, card_line), (cpu, cpu_line) = got["cuda"], got["cpu"]
        if metric in ("psnr", "miou"):
            assert card_line == cpu_line
        else:
            tol = 1e-4 if metric == "lpips" else 1e-3
            assert abs(card - cpu) <= tol * abs(cpu)


def test_png_codec_on_this_host():
    """The port's PNG decoder on this host (numpy and zlib as installed
    here) reads every color type, bit depth and interlacing as PIL does
    (the expectations of tests/torch_png_writer.py), and the bicubic
    resize is deterministic; no card needed."""
    from sige_torch.data import resize_bicubic
    from sige_torch.demo.png import decode_png, encode_png
    from torch_png_writer import CASES, encode, expected_rgb, pixels

    rng = np.random.default_rng(9)
    for color, depth, interlace in CASES:
        palette = (rng.integers(0, 256, (12, 3)) if color == 3 else None)
        for h, w in ((1, 1), (5, 7), (9, 13)):
            px = pixels(rng, h, w, color, depth)
            got = decode_png(encode(px, color, depth, interlace, palette))
            assert np.array_equal(got[..., :3],
                                  expected_rgb(px, color, depth, palette)), \
                (color, depth, interlace, h, w)
    img = rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)
    small = resize_bicubic(img, (6, 10))
    assert small.shape == (6, 10, 3) and small.dtype == np.uint8
    assert np.array_equal(small, resize_bicubic(img, (6, 10)))
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(b"\xff\xd8\xff\xe0" + bytes(16))


def test_native_planner_on_this_host(monkeypatch):
    """The native host planner builds and is in use on this host (the
    card's host has g++), and the core functions give the same arrays
    with it and with the numpy paths, bit for bit; no card needed."""
    from sige_torch import native
    from sige_torch.core import masks as m
    from sige_torch.core import scatter_map as sm
    from sige_torch.core.geometry import BlockGeometry

    def products(geom, mask):
        idx, n = m.reduce_mask_padded(mask, geom)
        hw = mask.shape
        return [m.dilate_mask(mask, 2), m.dilate_mask(mask, (1, 3)), idx,
                np.int64(n), sm.build_src_map(idx, n, geom, hw),
                *sm.build_sg_sources(idx, n, geom, hw)]

    assert native.available()
    rng = np.random.default_rng(0)
    cases = [(BlockGeometry.create(*g), rng.random((37, 41)) < p)
             for g in ((6, 3, 1, 1), (4, 1, 1, 0), (6, 3, 2, 1))
             for p in (0.0, 0.07, 1.0)]
    got = [products(*c) for c in cases]
    monkeypatch.setenv("SIGE_TPU_NO_NATIVE", "1")
    assert not native.available()
    for case, want in zip(got, (products(*c) for c in cases)):
        for a, b in zip(case, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.gpu
def test_mesh_of_one_keeps_the_current_card():
    """Without a process group the servers' mesh is on the device a server
    on one card takes (``cuda``, the current card), and ``device="cuda"``
    or ``"cuda:<current>"`` beside such a mesh is the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.parallel import TwinStepServer, make_mesh

    mesh = make_mesh()
    assert mesh.size == 1 and mesh.device == torch.device("cuda")
    cur = torch.cuda.current_device()
    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32)
    for dev in ("cuda", f"cuda:{cur}"):
        server = TwinStepServer(SIGEFusedUNet(cfg), None, {}, device=dev,
                                mesh=mesh)
        assert server.model.device == torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_tiny_twin_server_card_matches_cpu(layout):
    """TwinStepServer on a tiny DDPM U-Net: B = 3 distinct requests under
    one plan give the same y0 and y1 on the card as on the CPU, and each
    step launches the flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.nn import SIGEModel
    from sige_torch.parallel import TwinStepServer

    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=32)
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((3, 32, 32, 3)).astype(
        np.float32))
    mask = np.zeros((32, 32), bool)
    mask[8:16, 10:20] = True
    x1 = x0 + torch.from_numpy(rng.standard_normal((3, 32, 32, 3)).astype(
        np.float32) * mask[None, :, :, None])
    t = torch.zeros((3,))
    masks = downsample_mask(dilate_mask(mask, 2), min_res=4)
    params = None
    outs = {}
    for dev in ("cpu", "cuda"):
        model = SIGEModel(SIGEFusedUNet(cfg), bucket_min=1, layout=layout,
                          device=dev)
        if params is None:
            model.init(0)
            params = {k: v.clone() for k, v in
                      model.module.state_dict().items()}
        else:
            model.module.load_state_dict(params)
        model.full(x0[:1].to(dev), t[:1].to(dev))
        plan = model.set_masks(masks)
        server = TwinStepServer(SIGEFusedUNet(cfg), params, plan, device=dev)
        server.prime(x0.to(dev), t.to(dev))
        before = flash.flash_mha.launches
        outs[dev] = [y.cpu() for y in server.step(x0.to(dev), x1.to(dev),
                                                  t.to(dev))]
        if dev == "cuda":
            assert flash.flash_mha.launches > before
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4


def _session_inputs(S, B, H, W, C, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(S * B, H, W, C, generator=gen).to(dtype)
    return x.cuda(), gen


def _as_view(t, view):
    """``t``'s values as the view a case asks for: ``contiguous``, a
    ``channel_strided`` view (every other channel of a map twice as
    wide), a ``channel_slice`` (the middle C of 3C channels) or an
    ``offset`` one (contiguous, its data pointer one element past an
    aligned allocation)."""
    if view == "contiguous":
        return t
    N, H, W, C = t.shape
    if view == "offset":
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
    elif view == "channel_strided":
        out = torch.empty(N, H, W, 2 * C, dtype=t.dtype,
                          device=t.device)[..., ::2]
    else:
        out = torch.empty(N, H, W, 3 * C, dtype=t.dtype,
                          device=t.device)[..., C:2 * C]
    out.copy_(t)
    return out


def _vector_view(view, C, dtype):
    """Whether a map of this view, C and dtype takes the kernels' 16-byte
    instantiation."""
    return view in ("contiguous", "channel_slice") and \
        C % (16 // torch.tensor([], dtype=dtype).element_size()) == 0


# (S, B, H, W, C, EH, EW, origin rows): in image, at the border, negative
# virtual origins, an extent wider than the canvas, the DDPM path's widths
# (64 px at 128 channels), C = 3 and 6 (the scalar instantiation) with
# source rows wholly outside the image (above and below it)
CROP_CASES = [
    (2, 1, 12, 14, 5, 6, 7, [[3, 4], [0, 7]]),
    (3, 2, 12, 14, 8, 6, 7, [[-1, 9], [6, -2], [11, 13]]),
    (2, 2, 10, 12, 4, 14, 16, [[-1, -1], [-3, -2]]),
    (4, 1, 64, 64, 128, 34, 34, [[5, 7], [30, 30], [-1, 20], [0, 0]]),
    (2, 1, 9, 11, 3, 5, 6, [[-7, 2], [4, 8]]),
    (2, 2, 9, 11, 6, 5, 6, [[2, -3], [12, 1]]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CROP_CASES)
@pytest.mark.parametrize("epilogue", [None, "swish", "swish_first",
                                      "leaky", "tanh"])
@pytest.mark.parametrize("form", ["2", "4", "clamp"])
@pytest.mark.parametrize("view", ["contiguous", "channel_strided", "offset",
                                  "channel_slice"])
def test_crop_sessions_kernel_matches_plain_on_card(case, epilogue, form,
                                                    view):
    """crop_sessions_f32 against its plain version on the same CUDA
    tensors: exact without an epilogue, within 1e-6 with one (outside the
    image: the epilogue of zero); origins as [S, 2] rows, as 4-form metas
    (clamped, roll) and clamped; the 16-byte instantiation on contiguous
    maps and channel slices with C a multiple of 4, the scalar one
    otherwise, each counted."""
    if not torch.cuda.is_available():
        pytest.skip("the session kernels run only on a CUDA device")
    from sige_torch.ops import sessions as ss

    S, B, H, W, C, EH, EW, rows = case
    x, gen = _session_inputs(S, B, H, W, C, torch.float32, S + EH)
    x = _as_view(x, view)
    org = torch.tensor(rows, dtype=torch.int64)
    if form == "4":  # clamped origin and roll whose difference is the row
        cl = org.clamp(min=0)
        org = torch.cat([cl, cl - org], dim=1)
    org = org.cuda()
    edge = (torch.rand(S, EH, EW, generator=gen) < 0.8).cuda()
    kw = {}
    if epilogue is not None:
        kw = dict(scale=torch.randn(S * B, C, generator=gen).cuda(),
                  shift=torch.randn(C, generator=gen).cuda(),
                  activation=epilogue.split("_")[0],
                  activation_first=epilogue.endswith("first"))
    clamp = form == "clamp"
    before = ss.crop_sessions.launches, ss.crop_sessions.scalar_launches
    got = ss.crop_sessions(x, org, EH, EW, edge, clamp=clamp, **kw)
    torch.cuda.synchronize()
    scalar = not _vector_view(view, C, torch.float32)
    assert (ss.crop_sessions.launches, ss.crop_sessions.scalar_launches) \
        == (before[0] + 1, before[1] + scalar)
    want = ss.crop_sessions_plain(x, org, EH, EW, edge, clamp=clamp, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got - want).abs().max().item()
    assert err <= (0.0 if epilogue is None else 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CROP_CASES[:3] + CROP_CASES[5:])
@pytest.mark.parametrize("view", ["contiguous", "offset", "channel_slice"])
def test_crop_sessions_kernel_bf16_on_card(case, view):
    """The bf16 cache form: a crop of a bf16 map equals the plain version
    bit for bit (8 bf16 a vector where C is a multiple of 8, else the
    scalar instantiation); with an epilogue (which the kernel leaves to
    PyTorch for bf16 input, promoting to fp32 as the plain version does)
    too."""
    if not torch.cuda.is_available():
        pytest.skip("the session kernels run only on a CUDA device")
    from sige_torch.ops import sessions as ss

    S, B, H, W, C, EH, EW, rows = case
    x, gen = _session_inputs(S, B, H, W, C, torch.bfloat16, 1)
    x = _as_view(x, view)
    org = torch.tensor(rows, dtype=torch.int64).cuda()
    before = ss.crop_sessions.scalar_launches
    got = ss.crop_sessions(x, org, EH, EW)
    want = ss.crop_sessions_plain(x, org, EH, EW)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert ss.crop_sessions.scalar_launches == before + (
        not _vector_view(view, C, torch.bfloat16))
    edge = (torch.rand(S, EH, EW, generator=gen) < 0.8).cuda()
    scale = torch.randn(S * B, C, generator=gen).cuda()
    got = ss.crop_sessions(x, org, EH, EW, edge, scale, None, "swish")
    want = ss.crop_sessions_plain(x, org, EH, EW, edge, scale, None, "swish")
    assert got.dtype == torch.float32 and torch.equal(got, want)


# (S, B, H, W, C, WH, WW): B > 1, C = 6 (the scalar instantiation), a
# window wider than the map, the DDPM path's 46^2 windows at 128 channels
PASTE_CASES = [
    (3, 2, 16, 18, 8, 6, 7),
    (2, 1, 9, 11, 6, 4, 5),
    (2, 2, 10, 12, 8, 14, 16),
    (4, 1, 48, 48, 128, 46, 46),
]
PASTE_ORIGINS = {  # per-session rows, cut to S
    "rows": [[0, 0], [5, 11], [10, 3], [2, 1]],
    "negative": [[-2, 3], [-1, -4], [3, -6], [-5, -5]],
    "clamp": [[-2, 3], [14, 15], [7, -5], [60, 60]],
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("cov", [None, "shared", "sessions"])
@pytest.mark.parametrize("origin", ["rows", "host", "clamp", "negative",
                                    "meta4"])
@pytest.mark.parametrize("case", PASTE_CASES)
@pytest.mark.parametrize("view", ["contiguous", "offset",
                                  "channel_strided"])
def test_paste_sessions_kernel_matches_plain_on_card(dtypes, cov, origin,
                                                     case, view):
    """paste_sessions_f32 against its plain version, exactly: fp32, a bf16
    base under fp32 windows (the bf16 caches) and bf16 throughout; with
    per-session, shared or no coverage; per-session, negative, 4-form,
    host and clamped origins; the 16-byte instantiation where the base's
    view and C allow it, the scalar one otherwise, each counted."""
    if not torch.cuda.is_available():
        pytest.skip("the session kernels run only on a CUDA device")
    from sige_torch.ops import sessions as ss

    S, B, H, W, C, WH, WW = case
    base, gen = _session_inputs(S, B, H, W, C, dtypes[0], 2)
    base = _as_view(base, view)
    win = torch.randn(S * B, WH, WW, C, generator=gen).to(dtypes[1]).cuda()
    if origin == "host":
        org = (4, 9)
    else:
        rows = torch.tensor(PASTE_ORIGINS.get(origin, PASTE_ORIGINS[
            "negative"])[:S])
        if origin == "meta4":  # clamped origin and roll
            cl = rows.clamp(min=0)
            rows = torch.cat([cl, cl - rows], dim=1)
        org = rows.cuda()
    mask = {None: None,
            "shared": torch.rand(WH, WW, generator=gen) < 0.5,
            "sessions": torch.rand(S, WH, WW, generator=gen) < 0.5}[cov]
    mask = None if mask is None else mask.cuda()
    clamp = origin == "clamp"
    before = ss.paste_sessions.launches, ss.paste_sessions.scalar_launches
    got = ss.paste_sessions(base, win, org, mask, clamp=clamp)
    torch.cuda.synchronize()
    width = 16 // win.element_size()
    scalar = view != "contiguous" or C % width != 0
    assert (ss.paste_sessions.launches, ss.paste_sessions.scalar_launches) \
        == (before[0] + 1, before[1] + scalar)
    want = ss.paste_sessions_plain(base, win, org, mask, clamp=clamp)
    assert got.dtype == dtypes[1] and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_tiny_session_server_card_matches_cpu(layout):
    """SessionServer on a tiny DDPM U-Net, S = 3 sessions with their own
    edits (one at the border): the stacked step, the commit and a second
    edit give the same rows on the card as on the CPU, and the card's
    steps launch the session kernels and the flash kernel."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.ops import sessions as ss
    from sige_torch.parallel import SessionServer

    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=32)
    S, R = 3, 32
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy(rng.standard_normal((S, 1, R, R, 3)).astype(
        np.float32))
    boxes = [(2, 8, 4, 10), (20, 27, 18, 26), (0, 6, 0, 9)]
    masks, x1 = [], x0.clone()
    for i, (r0, r1, c0, c1) in enumerate(boxes):
        m = np.zeros((R, R), bool)
        m[r0:r1, c0:c1] = True
        x1[i] += torch.from_numpy(rng.standard_normal((1, R, R, 3)).astype(
            np.float32) * m[None, :, :, None])
        masks.append(downsample_mask(dilate_mask(m, 2), min_res=4))
    t = torch.zeros((S, 1))
    params, outs = None, {}
    for dev in ("cpu", "cuda"):
        server = SessionServer(SIGEFusedUNet(cfg), params, bucket_min=1,
                               layout=layout, device=dev)
        if params is None:
            server.model.init(0)
            params = {k: v.clone() for k, v in
                      server.model.module.state_dict().items()}
        server.prime(x0.to(dev), t.to(dev))
        for i in range(S):
            server.set_masks(i, masks[i])
        before = (ss.crop_sessions.launches, ss.paste_sessions.launches,
                  flash.flash_mha.launches)
        ys = [server.step(x1.to(dev), t.to(dev)),
              server.step(x1.to(dev), t.to(dev), sparse_update=True)]
        server.set_masks(0, masks[2])
        ys.append(server.step(x1.to(dev), t.to(dev)))
        outs[dev] = [y.cpu() for y in ys]
        if dev == "cuda":
            after = (ss.crop_sessions.launches, ss.paste_sessions.launches,
                     flash.flash_mha.launches)
            assert all(a > b for a, b in zip(after, before))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.shape == (S, 1, R, R, 3)
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_row_installs_without_a_sync_on_card():
    """Two edits whose steps follow each other with no synchronise, the
    first plan's copy held back behind a busy stream: the second install
    waits for that copy before it writes the staging buffer, so both
    steps equal, bit for bit, a server that installs its plan in full
    and synchronises every step; both edits take the row path into the
    same device buffer."""
    if not torch.cuda.is_available():
        pytest.skip("the pinned staging buffer's event needs a CUDA device")
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.nn.planner import plan_layout, plan_rows, stack_plans
    from sige_torch.parallel import SessionServer
    from sige_torch.utils import trace

    class FullInstall(SessionServer):
        def _install(self):
            self._stack.stacked()
            host = plan_rows(stack_plans(self._stack.plans),
                             self.mesh.rows(self.num_sessions))
            self.model.set_plan(host, plan_layout(host))

    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=32)
    S, R = 3, 32

    def masks(box):
        m = np.zeros((R, R), bool)
        r0, r1, c0, c1 = box
        m[r0:r1, c0:c1] = True
        return downsample_mask(dilate_mask(m, 2), min_res=4)

    first = [(10, 15, 10, 16), (14, 18, 14, 18), (8, 14, 14, 20)]
    # smaller edits inside the pinned shapes: the row path
    edits = [(0, (11, 15, 11, 16)), (1, (15, 19, 13, 17))]
    rng = np.random.default_rng(12)
    x0 = torch.from_numpy(rng.standard_normal((S, 1, R, R, 3)).astype(
        np.float32)).cuda()
    x1 = x0 + 0.5 * torch.from_numpy(rng.standard_normal(
        (S, 1, R, R, 3)).astype(np.float32)).cuda()
    t = torch.zeros((S, 1), device="cuda")
    params, outs = None, {}
    for cls in (FullInstall, SessionServer):
        server = cls(SIGEFusedUNet(cfg), params, bucket_min=1,
                     layout="window", device="cuda")
        if params is None:
            server.model.init(0)
            params = {k: v.clone() for k, v in
                      server.model.module.state_dict().items()}
        server.prime(x0, t)
        for i, box in enumerate(first):
            server.set_masks(i, masks(box))
        server.step(x1, t)
        torch.cuda.synchronize()
        ys, rows = [], trace.counters["plan_row_installs"]
        buf = None if cls is FullInstall else server._plan.buf.data_ptr()
        for i, box in edits:
            if cls is FullInstall:
                torch.cuda.synchronize()
            else:
                torch.cuda._sleep(100_000_000)  # hold the copy back
            server.set_masks(i, masks(box))
            ys.append(server.step(x1, t))
        torch.cuda.synchronize()
        outs[cls] = [y.cpu() for y in ys]
        if cls is SessionServer:
            assert trace.counters["plan_row_installs"] == rows + len(edits)
            assert server._plan.buf.data_ptr() == buf
    for n, (got, want) in enumerate(zip(outs[SessionServer],
                                        outs[FullInstall])):
        assert torch.equal(got, want), n


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["crop_sessions", "paste_sessions"])
def test_session_kernels_refuse_what_they_do_not_take(op):
    """The wrappers raise before a launch on inputs the kernels cannot
    read: a mask or a window on another device, a mask of the wrong
    shape or dtype, an unsupported dtype pair; the C entries return -1
    for a vector width they have no instantiation for."""
    if not torch.cuda.is_available():
        pytest.skip("the session kernels run only on a CUDA device")
    from sige_torch.ops import sessions as ss

    x = torch.randn(2, 8, 8, 4, device="cuda")
    org = torch.tensor([[1, 2], [3, 0]], device="cuda")
    out = torch.empty(2, 4, 4, 4, device="cuda")
    lib = ss.LIBRARY.load()
    stream = torch.cuda.current_stream().cuda_stream
    before = getattr(ss, op).launches
    if op == "crop_sessions":
        with pytest.raises(ValueError, match="mask on cpu"):
            ss.crop_sessions(x, org, 4, 4,
                             torch.ones(2, 4, 4, dtype=torch.bool))
        with pytest.raises(ValueError, match="expected bool"):
            ss.crop_sessions(x, org, 4, 4, torch.ones(
                3, 4, 4, device="cuda", dtype=torch.bool))
        err = lib.sige_crop_sessions(
            0, 2, 1, x.data_ptr(), out.data_ptr(), org.data_ptr(), 2, 0, 0,
            0, 2, 1, 8, 8, 4, 4, 4, *x.stride(), None, 0, None, 1, None, 1,
            0, 0, 0, stream)
    else:
        with pytest.raises(ValueError, match="window on cpu"):
            ss.paste_sessions(x, torch.randn(2, 4, 4, 4), org)
        with pytest.raises(TypeError, match="dtypes"):
            ss.paste_sessions(x, torch.randn(2, 4, 4, 4, device="cuda",
                                             dtype=torch.bfloat16), org)
        err = lib.sige_paste_sessions(
            0, 0, 2, 1, x.data_ptr(), out.data_ptr(), x.data_ptr(),
            org.data_ptr(), 2, 0, 0, 0, 2, 1, 8, 8, 4, 4, 4, *x.stride(),
            *out.stride(), None, 0, stream)
    assert err == -1
    torch.cuda.synchronize()
    assert getattr(ss, op).launches == before


class TwoBands:
    """The row bands of one map held in one process: the stand-in for
    ``sige_torch.parallel.RowBand`` that ``conv2d_nhwc`` takes, rank
    ``index`` of ``n`` reading its halo rows from the whole map ``full``
    (zeros beyond it) where the real band receives them from its
    neighbours."""

    def __init__(self, full: torch.Tensor, index: int, n: int = 2):
        self.full, self.index, self.n = full, index, n

    def height(self, h: int) -> int:
        return h * self.n

    def band(self) -> torch.Tensor:
        h = self.full.shape[1] // self.n
        return self.full[:, self.index * h:(self.index + 1) * h]

    def halo(self, x, above: int, below: int) -> torch.Tensor:
        h = x.shape[1]
        pad = torch.nn.functional.pad(self.full, (0, 0, 0, 0, above, below))
        start = self.index * h
        return pad[:, start:start + above + h + below]


# the conv shapes of the sharded paths: (kernel, stride, padding)
BAND_CONVS = {"3x3": (3, 1, 1),
              "down (0, 1)": (3, 2, ((0, 1), (0, 1))),
              "down pad 1": (3, 2, 1)}


def band_conv_error(device: str, kernel: int, stride: int, padding) -> float:
    """The largest difference, over max(1, max|ref|), between the whole
    map's conv and the concatenation of its two bands' convs, each band
    with its halo rows (:class:`TwoBands`)."""
    from sige_torch.ops.conv import conv2d_nhwc

    gen = torch.Generator().manual_seed(kernel + stride)
    x = torch.randn(2, 12, 10, 8, generator=gen).to(device)
    w = torch.randn(16, 8, kernel, kernel, generator=gen).to(device)
    b = torch.randn(16, generator=gen).to(device)
    with fp32_scope():
        ref = conv2d_nhwc(x, w, b, stride=stride, padding=padding)
        bands = [TwoBands(x, r) for r in range(2)]
        got = torch.cat([conv2d_nhwc(t.band(), w, b, stride=stride,
                                     padding=padding, band=t)
                         for t in bands], dim=1)
    assert got.shape == ref.shape
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(BAND_CONVS))
def test_band_conv_matches_the_whole_map_on_card(shape):
    """The halo form of ``conv2d_nhwc`` (two row bands of one map,
    simulated in one process) on the card equals the conv of the whole
    map within 1e-4 * max(1, max|ref|), for the 3x3 conv, the DDPM and VAE
    downsample's (0, 1) pad at stride 2, and the SD U-Net's stride 2 with
    padding 1."""
    if not torch.cuda.is_available():
        pytest.skip("the card's convs run only on a CUDA device")
    assert band_conv_error("cuda", *BAND_CONVS[shape]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("N,M", [(128, 256), (512, 1024)])
def test_local_queries_over_gathered_keys_on_card(N, M):
    """The sharded mid attention's call shape at a small size: one rank's
    queries (N = M / 2) over every rank's keys, D = 512; the kernel equals
    its plain version within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernel runs only on a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(N)
    q, k, v = (torch.randn(1, n, 1, 512, generator=gen, device="cuda")
               for n in (N, M, M))
    got = flash.flash_mha(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    with fp32_scope():
        want = flash.flash_mha_plain(q, k, v, 512 ** -0.5)
    assert (got - want).abs().max().item() <= 1e-4
