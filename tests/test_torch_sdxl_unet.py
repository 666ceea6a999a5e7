"""SDXL's base U-Net in the port (``SIGESDUNet`` with transformer depth
per level, 64-wide heads in the published model, the label embedding)
against the plain reference ``sigebench/reference/sdxl_unet.py`` on the
CPU, at a tiny SDXL-shaped configuration (depth 2 at 16 px, 3 at 8 px
and in the middle, 8-wide heads, a 12-wide label vector) with seeded weights:

  * the full pass equals the reference's dense forward;
  * ``SessionServer`` sparse steps in the window layout (masked stale-K/V
    chains), in the tile layout (the non-chain path, whose blocks past the
    first take their K/V from scatters over the original's block maps),
    and stacked at S = 2 with different masks equal the reference's
    sparse step, session by session;
  * ``y`` moves the output, and a U-Net with a label embedding refuses a
    call without it;
  * on the meta device the parameter names and shapes are the
    reference's, SD v1's default tree is unchanged, and the published
    configuration counts SDXL's 2,567,463,684 parameters;
  * one sparse forward counts its transformer blocks on and off the chain
    and records ``sige.op.transformer`` spans under a profiler.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sige_torch.models.sd import SDUNetConfig, SIGESDUNet
from sige_torch.parallel import SessionServer
from sige_torch.utils import trace
from sigebench.masks import dilate_mask, downsample_mask
from sigebench.reference import sd_unet, sdxl_unet
from sigebench.reference.common import Pass, precision, seeded_params
from sigebench.reference.windows import SessionWindows

ROOT = Path(__file__).resolve().parents[1]
L = 32  # latent side
TINY = dict(in_channels=4, model_channels=16, out_channels=4,
            num_res_blocks=1, attention_resolutions=(4, 2),
            channel_mult=(1, 2, 4), num_head_channels=8,
            transformer_depth=(1, 2, 3), context_dim=16, adm_in_channels=12,
            num_groups=8)
# latent-side edit boxes (r0, r1, c0, c1); the second touches the border
BOXES = [(9, 17, 10, 20), (0, 6, 22, 32)]
REL = 2e-5  # fp32 throughout: the port and the reference differ by rounding


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(S, seed=0):
    """Originals, edited inputs and extras, each [S, 2, ...], and each
    session's mask pyramid."""
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn((S, 2, L, L, 4), generator=g)
    t = torch.tensor([[21.0, 21.0], [401.0, 401.0]][:S])
    ctx = torch.randn((S, 2, 7, 16), generator=g)
    y = torch.randn((S, 2, 12), generator=g)
    x1, masks = x0.clone(), []
    for i, (r0, r1, c0, c1) in enumerate(BOXES[:S]):
        m = np.zeros((L, L), bool)
        m[r0:r1, c0:c1] = True
        x1[i, :, r0:r1, c0:c1] += 0.7 * torch.randn((2, r1 - r0, c1 - c0, 4),
                                                    generator=g)
        masks.append(downsample_mask(dilate_mask(m, 1), min_res=4))
    return x0, x1, (t, ctx, y), masks


def _server(S, layout, params):
    server = SessionServer(SIGESDUNet(SDUNetConfig(**TINY)), params,
                           bucket_min=2, layout=layout, device="cpu")
    return server


def _reference_rows(params, x0, x1, extras, masks, layout):
    """The reference's sparse step for each session ([S, 2, L, L, 4])."""
    S = x0.shape[0]
    rows, replay = [], None
    with precision(tf32=False), torch.no_grad():
        for i in range(S):
            store = {}
            ex = tuple(a[i] for a in extras)
            orig = Pass("orig", store)
            sdxl_unet.forward(params, TINY, x0[i], *ex, orig)
            if layout == "window" and replay is None:
                replay = SessionWindows(S, orig.out_reses)
                for j in range(S):
                    replay.set(j, masks[j])
                windows = replay.current()
            pyr = {hw: torch.from_numpy(m) for hw, m in masks[i].items()}
            win = windows[i] if layout == "window" else None
            rows.append(sdxl_unet.forward(params, TINY, x1[i], *ex,
                                          Pass("edit", store, pyr, win)))
    return torch.stack(rows)


def _close(got, want):
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err < REL, err


@pytest.fixture(scope="module")
def params():
    return seeded_params(sdxl_unet.param_shapes(TINY), 7, "cpu")


def test_full_pass_matches_the_reference(params):
    x0, _, (t, ctx, y), _ = _inputs(1)
    server = _server(1, "window", params)
    with torch.no_grad():
        got = server.model.full(x0[0], t[0], ctx[0], y[0])
        want = sdxl_unet.forward(params, TINY, x0[0], t[0], ctx[0], y[0],
                                 Pass("orig"))
    _close(got, want)


@pytest.mark.parametrize("layout,S", [("window", 1), ("tiles", 1),
                                      ("window", 2), ("tiles", 2)])
def test_sparse_steps_match_the_reference(params, layout, S):
    x0, x1, extras, masks = _inputs(S)
    server = _server(S, layout, params)
    server.prime(x0, *extras)
    for i in range(S):
        server.set_masks(i, masks[i])
    got = server.step(x1, *extras)
    want = _reference_rows(params, x0, x1, extras, masks, layout)
    for i in range(S):
        _close(got[i], want[i])
    # the edit moves the output: the comparison is not of the originals
    assert (want - server.step(x0, *extras)).abs().max() > 1e-2


def test_y_moves_the_output_and_is_required(params):
    x0, _, (t, ctx, y), _ = _inputs(1)
    server = _server(1, "window", params)
    with torch.no_grad():
        a = server.model.dense(x0[0], t[0], ctx[0], y[0])
        b = server.model.dense(x0[0], t[0], ctx[0], y[0] + 0.5)
        assert (a - b).abs().max() > 1e-3
        with pytest.raises(ValueError, match="adm_in_channels"):
            server.model.dense(x0[0], t[0], ctx[0])
    sd1 = SIGESDUNet(SDUNetConfig(
        model_channels=16, channel_mult=(1, 2), attention_resolutions=(2,),
        num_heads=2, context_dim=16, num_groups=8, num_res_blocks=1))
    with pytest.raises(ValueError, match="adm_in_channels"):
        sd1(x0[0], t[0], ctx[0], y[0], ctx=None)


def _meta_shapes(cfg):
    with torch.device("meta"):
        module = SIGESDUNet(SDUNetConfig(**cfg))
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_parameter_names_and_shapes_are_the_references():
    assert _meta_shapes(TINY) == sdxl_unet.param_shapes(TINY)
    # SD v1's default tree is untouched by the new fields
    assert _meta_shapes({}) == sd_unet.param_shapes({})
    assert not any(k.startswith("label_") for k in _meta_shapes({}))


def test_published_configuration_counts_sdxl_parameters():
    conf = json.loads((ROOT / "sigebench/configs/sdxl_1024.json")
                      .read_text())["model"]["unet"]
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in conf.items()}
    shapes = _meta_shapes(cfg)
    by_module = {}
    for name, s in shapes.items():
        top = name.split(".")[0]
        by_module[top] = by_module.get(top, 0) + math.prod(s)
    # generative-models' UNetModel for sd_xl_base.yaml: 2,567,463,684
    assert sum(by_module.values()) == 2_567_463_684, by_module
    assert shapes == sdxl_unet.param_shapes(cfg)
    heads = SDUNetConfig(**cfg).heads
    assert heads(640) == (10, 64) and heads(1280) == (20, 64)


def test_counters_and_span_of_one_sparse_forward(params):
    x0, x1, extras, masks = _inputs(1)
    server = _server(1, "window", params)
    server.prime(x0, *extras)
    server.set_masks(0, masks[0])
    before = trace.snapshot()
    server.step(x1, *extras)
    after = trace.snapshot()
    # sparse: 2 (16 px, in) + 3 (8 px, in) + 2 x 3 (8 px, out)
    # + 2 x 2 (16 px, out) = 15 on the chain; the middle's 3 dense
    assert after["transformer_chain_blocks"] - before[
        "transformer_chain_blocks"] == 15
    assert after["transformer_dense_blocks"] - before[
        "transformer_dense_blocks"] == 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        server.step(x1, *extras)
    spans = [e for e in prof.events() if e.name == "sige.op.transformer"]
    assert len(spans) == 7  # 6 sparse transformers and the middle
    inner = [e for e in prof.events() if e.name == "sige.op.attention"]
    assert inner and all(any(
        s.time_range.start <= e.time_range.start
        and e.time_range.end <= s.time_range.end for s in spans)
        for e in inner)
