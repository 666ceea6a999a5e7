"""The port's ``TwinStepServer`` against sige_tpu's, on the tiny DDPM of
``tests/test_parallel.py:20-22`` with weights bridged by
``utils/from_jax.py``: B = 4 distinct requests (originals and edits from
one seeded numpy generator) under one shared mask, in the tile and the
window layout.

  * ``prime`` then ``step`` equal sige_tpu's server on a one-device CPU
    mesh (y0 and y1, atol 1e-4; fp32 on both sides, sums reassociate);
  * every row of y0 and y1 equals the port's single-request engine under
    the same plan (``full`` and ``sparse`` at batch 1, atol 1e-5);
  * ``prime`` keeps the shared plan (a new batch shape makes ``full``
    drop a state's plan), and so does a step at another batch size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.parallel import TwinStepServer as JTwin
from sige_tpu.parallel import make_mesh
from sige_torch.core.masks import dilate_mask, downsample_mask
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.nn.planner import plan_leaves, plan_rows
from sige_torch.parallel import TwinStepServer
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
ROW_ATOL = 1e-5
R, B = 32, 4
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=R, sparse_resolution_threshold=32)


class TwinPair:
    """sige_tpu's model, plan and twin server on one layout: prime on the
    originals, one step."""

    def __init__(self, layout):
        rng = np.random.default_rng(5)
        self.x0 = rng.standard_normal((B, R, R, 3)).astype(np.float32)
        mask = np.zeros((R, R), bool)
        mask[8:16, 10:20] = True
        self.x1 = (self.x0 + rng.standard_normal((B, R, R, 3)).astype(
            np.float32) * mask[None, :, :, None]).astype(np.float32)
        self.t = np.zeros((B,), np.float32)
        self.masks = downsample_mask(dilate_mask(mask, 2), min_res=4)
        j = jnp.asarray
        model = JModel(JUNet(cfg=JConfig(**TINY)), bucket_min=1,
                       layout=layout)
        model.init(jax.random.key(0), j(self.x0[:1]), j(self.t[:1]))
        model.full(j(self.x0[:1]), j(self.t[:1]))
        model.set_masks(self.masks)
        self.sd = state_dict_from_flax(jax.device_get(model.params))
        mesh = make_mesh(1, tp=1, devices=jax.devices("cpu")[:1])
        server = JTwin(model.module, model.params, model.plan, mesh=mesh)
        server.prime(j(self.x0), j(self.t))
        y0, y1 = server.step(j(self.x0), j(self.x1), j(self.t))
        self.y0, self.y1 = np.asarray(y0), np.asarray(y1)


@functools.lru_cache(maxsize=None)
def _pair(layout):
    return TwinPair(layout)


def _port_plan(p, layout):
    """The port's single-request engine, planned on request 0's original
    (the shared plan), and that plan."""
    model = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), bucket_min=1,
                      layout=layout, device="cpu")
    model.module.load_state_dict(p.sd)
    t = torch.from_numpy
    model.full(t(p.x0[:1]), t(p.t[:1]))
    return model, model.set_masks(p.masks)


@pytest.mark.parametrize("layout", ["tiles", "window"])
def test_twin_step_matches_sige_tpu_and_single_requests(layout):
    p = _pair(layout)
    single, plan = _port_plan(p, layout)
    t = torch.from_numpy
    server = TwinStepServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)), p.sd,
                            plan, device="cpu")
    assert server.layout == layout
    server.prime(t(p.x0), t(p.t))
    y0, y1 = (y.numpy() for y in server.step(t(p.x0), t(p.x1), t(p.t)))
    assert y0.shape == y1.shape == (B, R, R, 3)
    np.testing.assert_allclose(y0, p.y0, atol=ATOL, rtol=0)
    np.testing.assert_allclose(y1, p.y1, atol=ATOL, rtol=0)
    # the requests differ, so the rows do too
    assert np.abs(y1[0] - y1[1]).max() > 1e-2
    for b in range(B):
        want0 = single.full(t(p.x0[b:b + 1]), t(p.t[:1])).numpy()
        want1 = single.sparse(t(p.x1[b:b + 1]), t(p.t[:1])).numpy()
        np.testing.assert_allclose(y0[b:b + 1], want0, atol=ROW_ATOL, rtol=0,
                                   err_msg=f"full, request {b}")
        np.testing.assert_allclose(y1[b:b + 1], want1, atol=ROW_ATOL, rtol=0,
                                   err_msg=f"sparse, request {b}")


def _installs(server, plan) -> bool:
    """Whether the server's model holds ``plan`` as installed: a stack of
    one session whose row is ``plan``, leaf for leaf."""
    got = dict(plan_leaves(plan_rows(server.model.plan_host, 0)))
    want = dict(plan_leaves(plan))
    return got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want)


def test_prime_keeps_the_shared_plan():
    p = _pair("tiles")
    _, plan = _port_plan(p, "tiles")
    t = torch.from_numpy
    server = TwinStepServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)), p.sd,
                            plan, device="cpu")
    with pytest.raises(RuntimeError, match="prime"):
        server.step(t(p.x0), t(p.x1), t(p.t))
    server.prime(t(p.x0), t(p.t))
    assert _installs(server, plan)
    assert server.model.active_layout == "tiles"
    # a step at another batch size keeps it too, and its rows are the
    # first rows of the batch-4 step
    y0, y1 = server.step(t(p.x0[:2]), t(p.x1[:2]), t(p.t[:2]))
    assert _installs(server, plan)
    np.testing.assert_allclose(y1.numpy(), p.y1[:2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(y0.numpy(), p.y0[:2], atol=ATOL, rtol=0)
