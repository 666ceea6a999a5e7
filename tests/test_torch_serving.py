"""The port's multi-session demo runner and SessionServer against
sige_tpu's, at ``tests/test_demo.py``'s TINY, with weights bridged by
``utils/from_jax.py`` and sige_tpu's noise handed over; fp32, atol 1e-4.

  * ``MultiSessionDemoRunner`` at S = 2 with different bases and edits
    (``tests/test_demo.py:61``): resets, generates, session 0's apply and
    session 1's generate after it equal sige_tpu's vmapped runner and
    independent port ``DemoRunner``s; session 1's cache tensors are the
    same objects before and after session 0's apply; a session not yet
    reset shares the first reset's tensors;
  * ``SessionServer`` at S = 4 in the window and tile layouts
    (``tests/test_parallel.py:53, 106``): per-session masks, ``step``,
    ``step(sparse_update=True)`` and a second edit per session over the
    committed caches equal sige_tpu's server (which stacks the plans on
    pinned shapes and vmaps one program over the sessions).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.demo.runner import MultiSessionDemoRunner as JMulti
from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.parallel import SessionServer as JServer
from sige_tpu.parallel import make_mesh
from sige_torch.demo import DemoRunner, MultiSessionDemoRunner
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.parallel import SessionServer
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_demo import KW, TINY
from test_torch_sd_unet import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
R = 32


def _ids(runner, i, slot=None):
    return [id(t) for t in runner.sessions[i].state.tensors(slot)]


# --- MultiSessionDemoRunner ---------------------------------------------------


class MultiPair:
    """sige_tpu's two-session runner through reset(0), reset(1),
    generate(0), generate(1), apply(0), generate(1), generate(0) (a no-op
    edit after the apply) and a second edit of session 0."""

    def __init__(self):
        rng = np.random.default_rng(7)  # tests/test_demo.py:74-84
        self.bases = [rng.random((R, R, 3)).astype(np.float32)
                      for _ in range(2)]
        self.edits = [b.copy() for b in self.bases]
        self.edits[0][4:12, 6:14] = 0.9
        self.edits[1][18:30, 2:26] = 0.05  # a bigger edit: other shapes
        self.second = self.edits[0].copy()
        self.second[20:28, 20:28] = 0.3
        jm = JMulti(2, JConfig(**TINY), **KW)
        self.want = [jm.reset_base_image(i, self.bases[i]) for i in range(2)]
        self.noise = [np.array(jm.base_e[i]) for i in range(2)]
        self.sd = state_dict_from_flax(jax.device_get(jm.inner.model.params))
        self.want += [jm.generate(0, self.edits[0]),
                      jm.generate(1, self.edits[1]),
                      jm.generate(0, self.edits[0], sparse_update=True),
                      jm.generate(1, self.edits[1]),
                      jm.generate(0, self.edits[0]),
                      jm.generate(0, self.second)]

    def calls(self):
        """The calls above as (session, method, args) on the port."""
        e0, e1 = self.edits
        return [(0, "reset", self.bases[0]), (1, "reset", self.bases[1]),
                (0, "gen", e0), (1, "gen", e1), (0, "apply", e0),
                (1, "gen", e1), (0, "gen", e0), (0, "gen", self.second)]


@functools.lru_cache(maxsize=None)
def _multi_pair():
    return MultiPair()


@pytest.fixture(scope="module")
def multi_pair():
    return _multi_pair()


def _run(runner, i, call, image, noise, multi: bool):
    args = (i,) if multi else ()
    if call == "reset":
        return runner.reset_base_image(*args, image, noise=noise[i])
    return runner.generate(*args, image, sparse_update=call == "apply")


def test_multi_session_matches_sige_tpu_and_independent_runners(multi_pair):
    p = multi_pair
    tm = MultiSessionDemoRunner(2, DDPMUNetConfig(**TINY), params=p.sd,
                                device="cpu", **KW)
    singles = [DemoRunner(DDPMUNetConfig(**TINY), params=p.sd, device="cpu",
                          **KW) for _ in range(2)]
    for n, ((i, call, image), want) in enumerate(zip(p.calls(), p.want)):
        got = _run(tm, i, call, image, p.noise, True)
        single = _run(singles[i], i, call, image, p.noise, False)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"call {n} ({call} {i})")
        np.testing.assert_allclose(got, single, atol=ATOL, rtol=0,
                                   err_msg=f"call {n} ({call} {i})")


def test_sessions_share_by_reference_and_commit_alone(multi_pair):
    p = multi_pair
    tm = MultiSessionDemoRunner(2, DDPMUNetConfig(**TINY), params=p.sd,
                                device="cpu", **KW)
    tm.reset_base_image(0, p.bases[0], noise=p.noise[0])
    # a session not yet reset starts from the first reset's tensors ...
    assert _ids(tm, 1) == _ids(tm, 0)
    assert tm.sessions[1].state.caches is not tm.sessions[0].state.caches
    tm.reset_base_image(1, p.bases[1], noise=p.noise[1])
    # ... and its own reset replaces them in its slots alone
    assert not set(_ids(tm, 1)) & set(_ids(tm, 0))
    tm.generate(1, p.edits[1])
    before0, before1 = _ids(tm, 0), _ids(tm, 1)
    tm.generate(0, p.edits[0], sparse_update=True)
    assert _ids(tm, 1) == before1
    assert _ids(tm, 0) != before0
    with pytest.raises(IndexError):
        tm.generate(2, p.edits[0])


# --- SessionServer ------------------------------------------------------------

S = 4
# tests/test_parallel.py:106-122 (compact edits: the window layout keeps
# its windows) and :53-69 (sessions 2 and 3 spread: other plan shapes)
BOXES = {"window": [(2, 8, 4, 10), (20, 27, 18, 26), (10, 15, 22, 28),
                    (5, 13, 2, 9)],
         "tiles": [(2, 8, 4, 10), (20, 28, 18, 30), (4, 26, 6, 28),
                   (0, 6, 24, 32)]}
SECOND = [(24, 30, 24, 30), (2, 8, 2, 8), (24, 30, 2, 10), (20, 26, 12, 18)]


def _session_edits(rng, x, boxes):
    masks, out = [], x.copy()
    for i, (r0, r1, c0, c1) in enumerate(boxes):
        m = np.zeros((R, R), bool)
        m[r0:r1, c0:c1] = True
        out[i] += (rng.standard_normal((1, R, R, 3)).astype(np.float32)
                   * m[None, :, :, None])
        masks.append(downsample_mask(dilate_mask(m, 2), min_res=4))
    return out, masks


class ServerPair:
    """sige_tpu's SessionServer over four CPU devices: prime, per-session
    masks, step, step(sparse_update=True), then a second edit per
    session over the committed caches."""

    def __init__(self, layout):
        self.layout = layout
        rng = np.random.default_rng(11)
        self.x0 = rng.standard_normal((S, 1, R, R, 3)).astype(np.float32)
        self.x1, self.masks1 = _session_edits(rng, self.x0, BOXES[layout])
        self.x2, self.masks2 = _session_edits(rng, self.x1, SECOND)
        self.tb = np.zeros((S, 1), np.float32)
        j = jnp.asarray
        cfg = JConfig(**TINY)
        model = JModel(JUNet(cfg=cfg), bucket_min=1)
        model.init(jax.random.key(0), j(self.x0[0]), j(self.tb[0]))
        self.sd = state_dict_from_flax(jax.device_get(model.params))
        mesh = make_mesh(S, tp=1, devices=jax.devices("cpu")[:S])
        server = JServer(model.module, model.params, mesh=mesh, bucket_min=1,
                         layout=layout)
        server.prime(j(self.x0), j(self.tb))
        for i in range(S):
            server.set_masks(i, self.masks1[i])
        self.y = np.asarray(server.step(j(self.x1), j(self.tb)))
        self.y_upd = np.asarray(server.step(j(self.x1), j(self.tb),
                                            sparse_update=True))
        for i in range(S):
            server.set_masks(i, self.masks2[i])
        self.y2 = np.asarray(server.step(j(self.x2), j(self.tb)))


@functools.lru_cache(maxsize=None)
def _server_pair(layout):
    return ServerPair(layout)


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_session_server_matches_sige_tpu(layout):
    p = _server_pair(layout)
    server = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)), p.sd,
                           bucket_min=1, layout=layout, device="cpu")
    with pytest.raises(RuntimeError, match="prime"):
        server.set_masks(0, p.masks1[0])
    t = torch.from_numpy
    server.prime(t(p.x0), t(p.tb))
    assert server.num_sessions == S
    for i in range(S):
        server.set_masks(i, p.masks1[i])
    if layout == "window":
        assert {st.active_layout for st in server.states} == {"window"}
    y = server.step(t(p.x1), t(p.tb)).numpy()
    assert y.shape == (S, 1, R, R, 3)
    np.testing.assert_allclose(y, p.y, atol=ATOL, rtol=0)
    y_upd = server.step(t(p.x1), t(p.tb), sparse_update=True).numpy()
    np.testing.assert_allclose(y_upd, p.y_upd, atol=ATOL, rtol=0)
    np.testing.assert_allclose(y_upd, y, atol=1e-5, rtol=0)
    for i in range(S):
        server.set_masks(i, p.masks2[i])
    y2 = server.step(t(p.x2), t(p.tb)).numpy()
    np.testing.assert_allclose(y2, p.y2, atol=ATOL, rtol=0)
