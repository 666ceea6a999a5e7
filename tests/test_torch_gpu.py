"""Tests that need the card: the hand-written CUDA kernels against their
plain PyTorch twins. They import nothing of JAX (the machine with the
card has none) and skip without a CUDA device. On that machine:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest``: the suite's conftest.py sets JAX up.)
"""

import pytest
import torch

from sige_torch.ops import flash


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D,with_bias", [
    (1, 256, 256, 1, 512, False),   # DDPM 16 px
    (1, 64, 64, 1, 512, False),     # DDPM 8 px mid block
    (2, 100, 77, 2, 80, True),      # ragged N and M, key bias
    (1, 130, 300, 3, 40, True),
])
def test_kernel_matches_plain_twin_on_card(B, N, M, H, D, with_bias):
    if not torch.cuda.is_available():
        pytest.skip("the flash kernel runs only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    bias = None
    if with_bias:
        bias = torch.where(torch.rand(M, generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0)
    before = flash.flash_mha.launches
    got = flash.flash_mha(q, k, v, D ** -0.5, bias)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == before + 1
    want = flash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,H,D", [
    (1, 256, 256, 1, 512),   # DDPM 16 px: 8 tiles
    (1, 64, 300, 1, 512),    # ragged M: the last split's tile holds 12 keys
    (2, 100, 256, 2, 40),
    (1, 70, 77, 3, 40),      # 3 tiles, the last one of 13 keys
])
@pytest.mark.parametrize("which", ["one", "two", "max"])
@pytest.mark.parametrize("dead_split", [False, True])
def test_forced_splits_match_plain_twin_on_card(B, N, M, H, D, which,
                                                dead_split):
    """The attention kernel with S = 1, 2 or ceil(M/32) key ranges (the
    combine kernel merging S > 1), against the plain version; with
    ``dead_split`` every key of split 1 (of S = 2 or max) carries -1e9."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    tiles = -(-M // flash.BLOCK_K)
    splits = {"one": 1, "two": 2, "max": tiles}[which]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    bias = None
    if dead_split:
        bias = torch.zeros(M, device="cuda")
        kb, ke = flash._split_bounds(M, max(splits, 2))[1]
        bias[kb:ke] = -1e9
    launches = flash.flash_mha.launches
    combines = flash.flash_mha.combine_launches
    got = flash._launch(q, k, v, D ** -0.5, bias, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.launches == launches + 1
    assert flash.flash_mha.combine_launches == combines + (splits > 1)
    want = flash.flash_mha_plain(q, k, v, D ** -0.5, bias)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("D", [40, 512])
def test_split_path_matches_plain_split_on_card(D):
    """The attention kernel's partials merged by the combine kernel,
    against the plain split path (partials per key range, then the plain
    combine) at the same split count."""
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels run only on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, M, H, splits = 1, 48, 256, 2, 8
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(B, n, H, D, generator=gen, device="cuda")
               for n in (N, M, M))
    combines = flash.flash_mha.combine_launches
    got = flash._launch(q, k, v, D ** -0.5, None, splits)
    torch.cuda.synchronize()
    assert flash.flash_mha.combine_launches == combines + 1
    want = flash.flash_mha_plain_split(q, k, v, D ** -0.5, None, splits)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("v_org,ext", [((3, 4), (6, 7)),     # 2-form meta
                                       ((-1, 9), (6, 7)),    # border
                                       ((-1, -1), (14, 16))  # wider
                                       ])
def test_window_ops_card_match_cpu(v_org, ext):
    """Each window op on CUDA tensors against the same op on the CPU
    (which the CPU tests hold against sige_tpu)."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    from sige_torch.nn.planner import _window_meta
    from sige_torch.ops import window as w

    torch.backends.cuda.matmul.allow_tf32 = False
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
        ring = d(edge)
        outs = [
            w.window_gather(d(x), meta, ring, d(scale), d(shift), "swish"),
            w.window_chain_extend(d(win), org, d(cache), meta, ring,
                                  d(scale), d(shift), "swish"),
            w.window_scatter(d(win), d(cache), org, d(cov), d(x)),
            w.window_state_materialize(d(cache), d(win), org),
            w.window_scatter_block_residual(d(win), d(cache), d(short),
                                            d(y1), org, d(cov), d(cov_s)),
        ]
        if (WH, WW) == (ext[0] - 2, ext[1] - 2):
            outs.append(w.window_scatter_gather(
                d(win), d(cache), meta, ring, d(cov), (1, 1), d(scale),
                d(shift), "swish"))
        return [o.cpu() for o in outs]

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
    import numpy as np

    from sige_torch.core.masks import dilate_mask, downsample_mask
    from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
    from sige_torch.nn import SIGEModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
                         attn_resolutions=(8,), resolution=32,
                         sparse_resolution_threshold=16, window_chain=chain)
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(
        np.float32))
    mask = np.zeros((32, 32), bool)
    mask[10:18, 12:22] = True
    x1 = x0 + 0.5 * torch.from_numpy(mask)[None, :, :, None]
    masks = downsample_mask(dilate_mask(mask, 2), min_res=8)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = SIGEModel(SIGEFusedUNet(cfg), layout="window", device=dev)
        model.init(0)
        t = torch.full((1,), 5.0, device=dev)
        full = model.full(x0.to(dev), t)
        model.set_masks(masks)
        before = flash.flash_mha.launches
        outs[dev] = [full.cpu(), model.sparse(x1.to(dev), t).cpu(),
                     model.sparse(x0.to(dev), t).cpu()]
        if dev == "cuda":
            assert flash.flash_mha.launches > before
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4
    assert (outs["cuda"][2] - outs["cuda"][0]).abs().max().item() <= 1e-4


def _sd_card_vs_cpu(make, args0, args1, masks):
    """full, sparse(edit), sparse(original) of one SD model on the card
    and on the CPU (the same seeded weights), window layout."""
    from sige_torch.nn import SIGEModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    for dev in ("cpu", "cuda"):
        model = SIGEModel(make(), layout="window", device=dev)
        model.bucket_min = 1
        model.init(0)
        a0 = [a.to(dev) for a in args0]
        a1 = [a.to(dev) for a in args1]
        full = model.full(*a0)
        model.set_masks(masks)
        before = flash.flash_mha.launches
        outs[dev] = [full.cpu(), model.sparse(*a1).cpu(),
                     model.sparse(*a0).cpu()]
        if dev == "cuda":
            assert flash.flash_mha.launches > before
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
    import numpy as np

    from sige_torch.core.masks import dilate_mask, downsample_mask
    from sige_torch.models.sd import SDUNetConfig, SIGESDUNet

    cfg = SDUNetConfig(in_channels=4, model_channels=32, out_channels=4,
                       num_res_blocks=1, attention_resolutions=(1, 2),
                       channel_mult=(1, 2), num_heads=4, context_dim=16,
                       num_groups=8, window_chain=chain)
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn(2, 16, 16, 4, generator=gen)
    mask = np.zeros((16, 16), bool)
    mask[4:9, 5:11] = True
    x1 = x0 + torch.from_numpy(mask)[None, :, :, None] * torch.randn(
        2, 16, 16, 4, generator=gen)
    t = torch.full((2,), 3.0)
    c = torch.randn(2, 7, 16, generator=gen)
    _sd_card_vs_cpu(lambda: SIGESDUNet(cfg), (x0, t, c), (x1, t, c),
                    downsample_mask(dilate_mask(mask, 1), min_res=4))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_tiny_sd_vae_card_matches_cpu(kind):
    """The tiny SD VAE of tests/test_sd.py: the mid block's masked
    stale/fresh attention runs the flash kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("card-vs-CPU comparison needs a CUDA device")
    import numpy as np

    from sige_torch.core.masks import dilate_mask, downsample_mask
    from sige_torch.models.sd import SDVAEConfig, SIGEDecoder, SIGEEncoder

    cfg = SDVAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), z_channels=4, resolution=32,
                      num_groups=8)
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
    _sd_card_vs_cpu(make, (x0,), (x1,),
                    downsample_mask(dilate_mask(mask, 1), min_res=4))
