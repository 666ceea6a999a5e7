"""The port's DDPM U-Net against sige_tpu's, through the weight bridge.

Two tiny configurations:
  * ``graft`` — the tiny config of ``__graft_entry__._build(tiny=True)``;
  * ``join`` — every level sparse, so the down path's channel change runs
    the block-residual join, the attention runs its gather/scatter pairs
    and the Downsample gathers with ``conv_padding=0``.

Plans (and the meta they come from) must be equal key by key; dense, full
and sparse outputs agree at atol 1e-4 (fp32 on both sides; convolutions
and reductions sum in different orders — the outputs are O(1)); in the
port, sparse on the original input equals full at 1e-4 (the SIGE
contract of examples/minimal.py).
"""

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
from sige_tpu.utils import traced_macs
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.module import SIGECtx
from sige_torch.utils.from_jax import state_dict_from_flax, torch_path

ATOL = 1e-4
CONFIGS = {
    "graft": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                  attn_resolutions=(8,), resolution=32,
                  sparse_resolution_threshold=32),
    "join": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 attn_resolutions=(8,), resolution=16,
                 sparse_resolution_threshold=8),
}


def _flatten(tree, path=()):
    """{path tuple: leaf} with flax module names mapped to the port's."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, path + (k,)))
        else:
            out[torch_path(path) + (k,)] = v
    return out


class Pair:
    """A sige_tpu model and the port's, with the same weights, run on the
    same inputs."""

    def __init__(self, name):
        kw = CONFIGS[name]
        R = kw["resolution"]
        rng = np.random.default_rng(0)
        self.x0 = rng.standard_normal((1, R, R, 3)).astype(np.float32)
        mask = np.zeros((R, R), bool)
        mask[R // 4:R // 2, R // 4 + 1:R // 2 + 3] = True
        mask[-2:, :3] = True  # a second region at the border
        self.x1 = self.x0 + (0.5 * rng.standard_normal((1, R, R, 3))
                             * mask[None, :, :, None]).astype(np.float32)
        self.t = np.array([17.0], np.float32)
        self.masks = downsample_mask(dilate_mask(mask, 2), min_res=4)

        self.jm = JModel(JUNet(cfg=JConfig(**kw)))
        self.jm.init(jax.random.key(0), jnp.asarray(self.x0),
                     jnp.asarray(self.t))
        self.tm = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**kw)),
                            device="cpu")
        self.tm.module.load_state_dict(
            state_dict_from_flax(jax.device_get(self.jm.params)))

        j = lambda a: jnp.asarray(a)  # noqa: E731
        tt = lambda a: torch.from_numpy(a)  # noqa: E731
        self.j_dense = np.asarray(self.jm.module.apply(
            {"params": self.jm.params}, j(self.x0), j(self.t),
            ctx=JCtx(mode="dense")))
        self.j_full = np.asarray(self.jm.full(j(self.x0), j(self.t)))
        self.j_plan = self.jm.set_masks(self.masks)
        self.j_sparse = np.asarray(self.jm.sparse(j(self.x1), j(self.t)))

        self.t_dense = self.tm.dense(tt(self.x0), tt(self.t)).numpy()
        self.t_full = self.tm.full(tt(self.x0), tt(self.t)).numpy()
        self.t_plan = self.tm.set_masks(self.masks)
        self.t_sparse = self.tm.sparse(tt(self.x1), tt(self.t)).numpy()
        self.t_sparse0 = self.tm.sparse(tt(self.x0), tt(self.t)).numpy()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return Pair(request.param)


def test_weight_bridge_covers_every_parameter(pair):
    sd = state_dict_from_flax(jax.device_get(pair.jm.params))
    assert sd.keys() == pair.tm.module.state_dict().keys()


def test_meta_and_plans_equal_key_by_key(pair):
    jmeta = _flatten(jax.device_get(pair.jm.meta))
    tmeta = _flatten(pair.tm.meta)
    assert jmeta.keys() == tmeta.keys()
    for k in jmeta:
        assert len(jmeta[k]) >= 1 and len(tmeta[k]) >= 1
        want = {tuple(np.asarray(a).tolist()) for a in jmeta[k]}
        assert want == {tuple(np.asarray(a).tolist()) for a in tmeta[k]}, k
    jplan = _flatten(jax.device_get(pair.j_plan))
    tplan = _flatten(pair.t_plan)
    assert jplan.keys() == tplan.keys()
    assert any(k[-1].startswith("sgsrc_") for k in tplan)
    for k in jplan:
        assert np.array_equal(np.asarray(jplan[k]), np.asarray(tplan[k])), k


@pytest.mark.parametrize("mode", ["dense", "full", "sparse"])
def test_forward_matches_sige_tpu(pair, mode):
    got, want = getattr(pair, f"t_{mode}"), getattr(pair, f"j_{mode}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sparse_on_original_equals_full(pair):
    np.testing.assert_allclose(pair.t_sparse0, pair.t_full, atol=ATOL, rtol=0)
    assert pair.tm.stats()


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_macs_match_sige_tpu(pair, mode):
    ctx = SIGECtx(mode=mode, macs=[])
    with torch.inference_mode():
        pair.tm.module(torch.from_numpy(pair.x1), torch.from_numpy(pair.t),
                       ctx=ctx)
    variables = {"params": pair.jm.params, "cache": pair.jm.cache,
                 "sige": pair.jm.plan}
    want = traced_macs(pair.jm.module, variables, jnp.asarray(pair.x1),
                       jnp.asarray(pair.t), ctx=JCtx(mode=mode))
    assert sum(ctx.macs) == pytest.approx(want, rel=1e-6)


def test_later_slices_raise_not_implemented():
    """cache_dtype, cache_slots > 1 and sparse_update come with a later
    slice of the port (the window layout and layout="auto" run now:
    tests/test_torch_ddpm_window.py)."""
    module = SIGEFusedUNet(DDPMUNetConfig(**CONFIGS["join"]))
    with pytest.raises(NotImplementedError):
        SIGEModel(module, device="cpu", cache_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**CONFIGS["join"],
                                               cache_slots=2)), device="cpu")
    model = SIGEModel(module, device="cpu")
    with pytest.raises(NotImplementedError):
        model.sparse(torch.zeros(1, 16, 16, 3), torch.zeros(1),
                     sparse_update=True)


def test_gpu_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**CONFIGS["join"])))
