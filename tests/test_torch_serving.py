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
    pinned shapes and vmaps one program over the sessions), and each
    session's row equals the port's single-session engine planned under
    the server's merged pins; the window layout keeps its windows through
    the merge, and a step is one forward at batch S * B for every S;
  * the resident plan's row installs: steps over edits in both layouts
    equal, bit for bit, those of a server that installs in full every
    step.
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
        assert server.model.active_layout == "window"
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


def _port_server(layout, S=4, seed=11):
    """The port's SessionServer and a single-session engine with the same
    seeded weights, primed and planned on S sessions' edits."""
    from sige_torch.nn import SIGEModel

    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((S, 1, R, R, 3)).astype(np.float32)
    x1, masks1 = _session_edits(rng, x0, BOXES[layout][:S])
    x2, masks2 = _session_edits(rng, x1, SECOND[:S])
    tb = np.zeros((S, 1), np.float32)
    single = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), bucket_min=1,
                       layout=layout, device="cpu")
    single.init(0)
    server = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)),
                           single.module.state_dict(), bucket_min=1,
                           layout=layout, device="cpu")
    t = torch.from_numpy
    server.prime(t(x0), t(tb))
    for i in range(S):
        server.set_masks(i, masks1[i])
    return server, single, [t(a) for a in (x0, x1, x2, tb)], masks1, masks2


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_session_rows_match_single_engine_under_server_pins(layout):
    """Each session's row of a stacked step equals the port's
    single-session engine planned with the server's merged pins
    (``_stack._caps()``: the same leaf shapes), within 1e-4, as
    ``tests/test_parallel.py:106-164`` holds sige_tpu's; also the
    committing step, and a second edit per session over the committed
    caches."""
    server, single, (x0, x1, x2, tb), masks1, masks2 = _port_server(layout)
    y = server.step(x1, tb)
    y_upd = server.step(x1, tb, sparse_update=True)
    caps1 = server._stack._caps()
    for i in range(S):
        server.set_masks(i, masks2[i])
    y2 = server.step(x2, tb)
    caps2 = server._stack._caps()
    for i in range(S):
        single.full(x0[i], tb[i])
        single.set_masks(masks1[i], capacities=caps1)
        want = single.sparse(x1[i], tb[i])
        np.testing.assert_allclose(y[i], want, atol=ATOL, rtol=0,
                                   err_msg=f"session {i}")
        np.testing.assert_allclose(
            y_upd[i], single.sparse(x1[i], tb[i], sparse_update=True),
            atol=ATOL, rtol=0, err_msg=f"session {i} commit")
        single.set_masks(masks2[i], capacities=caps2)
        np.testing.assert_allclose(y2[i], single.sparse(x2[i], tb[i]),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"session {i} second edit")


def test_window_layout_survives_the_merge():
    """Compact edits at four origins keep real windows on the shared
    pins: ``win_pins`` is not empty and the stacked plan holds ``win_in``
    leaves, one meta row per session."""
    from sige_torch.nn.planner import plan_leaves

    server, _, (_, x1, _, tb), _, _ = _port_server("window")
    stacked = server._stack.stacked()
    assert server._stack.win_pins
    metas = [a for path, a in plan_leaves(stacked) if path[-1] == "win_in"]
    assert metas and all(a.shape[0] == S for a in metas)
    server.step(x1, tb)
    assert server.model.active_layout == "window"
    assert all(a.shape[0] == S
               for _, a in plan_leaves(server.model.plan_host))


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_stacked_step_is_one_forward_whatever_s(layout):
    """A step runs the module ONCE over the S sessions' samples (batch
    S * B), for S = 1, 2 and 4: counted with a forward hook on the
    module."""
    for n in (1, 2, 4):
        server, _, (_, x1, _, tb), _, _ = _port_server(layout, S=n)
        batches = []
        hook = server.model.module.register_forward_pre_hook(
            lambda mod, args: batches.append(args[0].shape[0]))
        try:
            y = server.step(x1, tb)
            server.step(x1, tb, sparse_update=True)
        finally:
            hook.remove()
        assert batches == [n, n], (n, batches)
        assert y.shape == (n, 1, R, R, 3)


def test_session_server_runs_on_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    """Without a CUDA device the server refuses to start unless the caller
    passes ``device="cpu"``; it takes only the two layouts it can stack."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SessionServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)))
    with pytest.raises(ValueError, match="layout"):
        SessionServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)), layout="auto",
                      device="cpu")
    server = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**TINY)),
                           device="cpu")
    with pytest.raises(RuntimeError, match="prime"):
        server.step(torch.zeros(1, 1, R, R, 3), torch.zeros(1, 1))


def _pd_sessions(rng, config="tiny"):
    """The PD U-Net at one of tests/test_torch_pd.py's configs (its
    resblocks resample inside the window chain; ``attn`` adds attention at
    8 and 16 px): three sessions' (x, logsnr) and masks."""
    from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
    from test_torch_pd import CONFIGS

    x0 = rng.standard_normal((3, 1, R, R, 3)).astype(np.float32)
    x1, masks = _session_edits(rng, x0, [(8, 16, 10, 20), (0, 7, 26, 32),
                                         (18, 26, 4, 12)])
    ls = torch.full((3, 1), 1.3)
    t = torch.from_numpy
    return (lambda: SIGEPDUNet(PDUNetConfig(**CONFIGS[config])),
            (t(x0), ls), (t(x1), ls), masks)


def _gaugan_sessions(rng):
    """The fused SPADE generator at tests/test_gaugan.py's TINY (64x32):
    three sessions' one-hot label maps with a box relabelled each (one at
    the border) and the runner's mask pyramids."""
    from sige_torch.core.masks import compute_difference_mask
    from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                          SPADEGenConfig)
    from test_torch_gaugan import TINY as GTINY

    cfg = SPADEGenConfig(**GTINY)
    H, W = cfg.latent_hw[0] * 2 ** 5, cfg.crop_size
    n = cfg.semantic_nc - 1
    sems, masks = ([], []), []
    for box in [(8, 14, 16, 26), (0, 5, 54, 64), (20, 28, 30, 44)]:
        l0 = rng.integers(0, n - 1, (H, W))
        l1 = l0.copy()
        l1[box[0]:box[1], box[2]:box[3]] = n - 2
        for out, lab in zip(sems, (l0, l1)):
            one = np.zeros((1, H, W, cfg.semantic_nc), np.float32)
            one[0, np.arange(H)[:, None], np.arange(W)[None, :], lab] = 1
            out.append(one)
        mask = dilate_mask(compute_difference_mask(
            sems[0][-1][0], sems[1][-1][0], eps=1e-3), 1)
        masks.append(downsample_mask(mask, min_res=cfg.latent_hw,
                                     dilation=1))
    return (lambda: SIGEFusedSPADEGenerator(cfg),
            (torch.from_numpy(np.stack(sems[0])),),
            (torch.from_numpy(np.stack(sems[1])),), masks)


@pytest.mark.parametrize("layout", ["window", "tiles"])
@pytest.mark.parametrize("family", ["pd", "pd_attn", "gaugan"])
def test_session_server_on_other_families(family, layout):
    """The stacked step on the PD U-Net (with and without its attention
    at 8 and 16 px) and the GauGAN generator (their own window chains:
    PD's resampling resblocks, SPADE's seg branch and up2 carries): each
    session's rows, and the commit's, equal the single-session engine
    under the server's pins within 1e-4."""
    from sige_torch.nn import SIGEModel

    make, args0, args1, masks = {
        "pd": _pd_sessions,
        "pd_attn": functools.partial(_pd_sessions, config="attn"),
        "gaugan": _gaugan_sessions}[family](np.random.default_rng(4))
    single = SIGEModel(make(), bucket_min=1, layout=layout, device="cpu")
    single.init(0)
    server = SessionServer(make(), single.module.state_dict(), bucket_min=1,
                           layout=layout, device="cpu")
    server.prime(*args0)
    for i, m in enumerate(masks):
        server.set_masks(i, m)
    y = server.step(*args1)
    y_upd = server.step(*args1, sparse_update=True)
    assert server.model.active_layout == layout
    caps = server._stack._caps()
    for i, m in enumerate(masks):
        single.full(*(a[i] for a in args0))
        single.set_masks(m, capacities=caps)
        for got, upd in ((y, False), (y_upd, True)):
            want = single.sparse(*(a[i] for a in args1), sparse_update=upd)
            np.testing.assert_allclose(got[i], want, atol=ATOL, rtol=0,
                                       err_msg=f"session {i} commit {upd}")


class _FullInstallServer(SessionServer):
    """A SessionServer whose every step installs its plan in full: a
    fresh restack of the sessions' plans moved by ``upload_plan``."""

    def _install(self):
        from sige_torch.nn.planner import plan_layout, plan_rows, stack_plans

        self._stack.stacked()  # re-pins and re-forms as the server does
        host = plan_rows(stack_plans(self._stack.plans),
                         self.mesh.rows(self.num_sessions))
        self.model.set_plan(host, plan_layout(host))


@pytest.mark.parametrize("layout", ["window", "tiles"])
def test_row_installs_match_full_installs(layout):
    """Steps over edits in both layouts (every session's first edit, a
    commit, the second edits, then one session at a time moving its edit)
    give outputs bit for bit equal to a server that installs in full
    every step; the moved edits take the row path."""
    from sige_torch.nn import SIGEModel
    from sige_torch.utils import trace

    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((S, 1, R, R, 3)).astype(np.float32)
    x1, masks1 = _session_edits(rng, x0, BOXES[layout])
    x2, masks2 = _session_edits(rng, x1, SECOND)
    moves = [(n % S, _session_edits(rng, x2, [
        (r0 + d, r1 + d, c0 + d, c1 + d) for r0, r1, c0, c1 in SECOND])[1])
        for n, d in enumerate((1, -1, 2, 1, -2, 1))]
    t = torch.from_numpy
    tb = t(np.zeros((S, 1), np.float32))
    single = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**TINY)), device="cpu")
    single.init(0)
    outs, rows = [], []
    for cls in (SessionServer, _FullInstallServer):
        server = cls(SIGEFusedUNet(DDPMUNetConfig(**TINY)),
                     single.module.state_dict(), bucket_min=1,
                     layout=layout, device="cpu")
        server.prime(t(x0), tb)
        ys = []
        for i in range(S):
            server.set_masks(i, masks1[i])
        ys += [server.step(t(x1), tb),
               server.step(t(x1), tb, sparse_update=True)]
        for i in range(S):
            server.set_masks(i, masks2[i])
        ys.append(server.step(t(x2), tb))
        before = trace.counters["plan_row_installs"]
        for i, masks in moves:
            server.set_masks(i, masks[i])
            ys.append(server.step(t(x2), tb))
        rows.append(trace.counters["plan_row_installs"] - before)
        outs.append(ys)
    assert rows[0] > 0 and rows[1] == 0
    for n, (got, want) in enumerate(zip(*outs)):
        assert torch.equal(got, want), n
