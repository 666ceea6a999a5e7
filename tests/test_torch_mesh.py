"""The port's (dp, tp) mesh over ``torch.distributed`` ranks
(``sige_torch/parallel/mesh.py``) and the servers' ``mesh=``, against
sige_tpu's servers on a CPU mesh of the same shape (conftest's virtual
devices) and against the port's one-process servers.

The ranks are processes of their own (``tests/torch_mesh_worker.py``: no
JAX), joined in a gloo group through a file under ``tmp_path`` (never a
fixed port: several test workers run at once), each with a join timeout,
so a hung rank fails its test. Every rank takes the same global inputs,
runs its rows and saves what ``gather_batch`` assembled.

  * ``tests/test_parallel.py:12`` at dp = 2, tp = 2 (4 ranks): the twin
    step on four requests under one plan;
  * ``tests/test_parallel.py:53`` and ``:106`` at dp = 2 (2 ranks): four
    sessions with their own edits (spread ones that re-pin and fall back
    to tiles, compact ones that keep their windows), the step and the
    committing step.

The gathered batch equals sige_tpu's within 1e-4 and the one-process port
server's exactly, on every rank; each rank's own rows are its dp slice.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sige_tpu.core.masks import dilate_mask, downsample_mask
from sige_tpu.models.ddpm import DDPMUNetConfig as JConfig
from sige_tpu.models.ddpm import SIGEFusedUNet as JUNet
from sige_tpu.nn import SIGEModel as JModel
from sige_tpu.parallel import SessionServer as JSessions
from sige_tpu.parallel import TwinStepServer as JTwin
from sige_tpu.parallel import make_mesh as j_make_mesh
from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn import SIGEModel
from sige_torch.parallel import (Mesh, SessionServer, TwinStepServer,
                                 gather_batch, make_mesh, replicate,
                                 shard_batch, shard_cache)
from sige_torch.utils.from_jax import state_dict_from_flax
from test_torch_sd_unet import flax_params, one_torch_thread  # noqa: F401

ATOL = 1e-4
R = 32
# tests/test_parallel.py:19-21
CFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=32, sparse_resolution_threshold=32)
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
JOIN_S = 120


def _params(x, t):
    params = flax_params(JUNet(cfg=JConfig(**CFG)), x, t)
    return params, state_dict_from_flax(params)


def _spawn(world, tasks, tmp_path):
    """Run ``tasks`` on ``world`` rank processes; each rank's results."""
    job = tmp_path / "job.pt"
    torch.save(tasks, job)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(WORKER.parent.parent)] + [p for p in [
            os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "init"), str(job), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}: rc {p.returncode}\n{log}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return [np.load(tmp_path / f"rank{r}.npy", allow_pickle=True).tolist()
            for r in range(world)]


def _edited(rng, x0, boxes):
    x1, masks = x0.copy(), []
    for i, (r0, r1, c0, c1) in enumerate(boxes):
        m = np.zeros((R, R), bool)
        m[r0:r1, c0:c1] = True
        x1[i] += (rng.standard_normal(x0.shape[1:]).astype(np.float32)
                  * m[:, :, None])
        masks.append(downsample_mask(dilate_mask(m, 2), min_res=4))
    return x1, masks


def test_twin_step_server_dp_tp(tmp_path):
    """tests/test_parallel.py:12 at dp = 2, tp = 2: four requests (each
    its own image, one shared edit mask and plan) on four ranks."""
    B = 4
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((B, R, R, 3)).astype(np.float32)
    mask = np.zeros((R, R), bool)
    mask[8:16, 10:20] = True
    x1, _ = _edited(rng, x0, [(8, 16, 10, 20)] * B)
    masks = downsample_mask(dilate_mask(mask, 2), min_res=4)
    t = np.zeros((B,), np.float32)
    params, sd = _params(x0[:1], t[:1])

    jm = JModel(JUNet(cfg=JConfig(**CFG)), params, bucket_min=1)
    jm.full(jnp.asarray(x0[:1]), jnp.asarray(t[:1]))
    jm.set_masks(masks)
    jmesh = j_make_mesh(4, tp=2, devices=jax.devices("cpu")[:4])
    jserver = JTwin(jm.module, jm.params, jm.plan, mesh=jmesh)
    jserver.prime(jnp.asarray(x0), jnp.asarray(t))
    want0, want1 = map(np.asarray, jserver.step(
        jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t)))

    single = SIGEModel(SIGEFusedUNet(DDPMUNetConfig(**CFG)), bucket_min=1,
                       device="cpu")
    single.module.load_state_dict(sd)
    single.full(torch.from_numpy(x0[:1]), torch.from_numpy(t[:1]))
    plan = single.set_masks(masks)
    one = TwinStepServer(SIGEFusedUNet(DDPMUNetConfig(**CFG)), sd, plan,
                         device="cpu")
    assert one.mesh.shape == {"dp": 1, "tp": 1}
    one.prime(*map(torch.from_numpy, (x0, t)))
    y0, y1 = (y.numpy() for y in one.step(*map(torch.from_numpy,
                                                (x0, x1, t))))
    np.testing.assert_allclose(y0, want0, atol=ATOL, rtol=0)
    np.testing.assert_allclose(y1, want1, atol=ATOL, rtol=0)

    ranks = _spawn(4, [dict(kind="twin", tp=2, cfg=CFG, state=sd, plan=plan,
                            inputs=(x0, x1, t))], tmp_path)
    for r, (got,) in enumerate(ranks):
        assert (got["dp"], got["tp"]) == (2, 2)
        assert got["coords"] == (r // 2, r % 2)
        d = r // 2
        np.testing.assert_array_equal(got["rows"], y1[2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["y0"], y0, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["y1"], y1, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["y1"], want1, atol=ATOL, rtol=0)


# tests/test_parallel.py:64 (spread: re-pins, tiles at some levels) and
# :119 (compact: windows survive the merge)
SESSION_CASES = {"spread": (3, [(2, 8, 4, 10), (20, 28, 18, 30),
                                (4, 26, 6, 28), (0, 6, 24, 32)]),
                 "compact": (11, [(2, 8, 4, 10), (20, 27, 18, 26),
                                  (10, 15, 22, 28), (5, 13, 2, 9)])}


def _session_case(name):
    seed, boxes = SESSION_CASES[name]
    rng = np.random.default_rng(seed)
    S = len(boxes)
    x0 = rng.standard_normal((S, 1, R, R, 3)).astype(np.float32)
    x1, masks = _edited(rng, x0, boxes)
    return x0, x1, np.zeros((S, 1), np.float32), masks


def test_session_servers_dp2(tmp_path):
    """tests/test_parallel.py:53 and :106 at dp = 2: four sessions, two on
    each rank, window layout (the default); the step and the committing
    step."""
    jmesh = j_make_mesh(2, tp=1, devices=jax.devices("cpu")[:2])
    tasks, wants = [], []
    for name in SESSION_CASES:
        x0, x1, t, masks = _session_case(name)
        params, sd = _params(x0[0], t[0])
        jserver = JSessions(JUNet(cfg=JConfig(**CFG)), params, mesh=jmesh,
                            bucket_min=1)
        jserver.prime(jnp.asarray(x0), jnp.asarray(t))
        for i, m in enumerate(masks):
            jserver.set_masks(i, m)
        want = np.asarray(jserver.step(jnp.asarray(x1), jnp.asarray(t)))
        want_upd = np.asarray(jserver.step(jnp.asarray(x1), jnp.asarray(t),
                                           sparse_update=True))
        one = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**CFG)), sd,
                            bucket_min=1, device="cpu")
        one.prime(*map(torch.from_numpy, (x0, t)))
        for i, m in enumerate(masks):
            one.set_masks(i, m)
        y = one.step(*map(torch.from_numpy, (x1, t))).numpy()
        y_upd = one.step(*map(torch.from_numpy, (x1, t)),
                         sparse_update=True).numpy()
        np.testing.assert_allclose(y, want, atol=ATOL, rtol=0)
        tasks.append(dict(kind="sessions", tp=1, cfg=CFG, state=sd,
                          layout="window", inputs=(x0, x1, t), masks=masks))
        wants.append((name, want, want_upd, y, y_upd))
    ranks = _spawn(2, tasks, tmp_path)
    for r, results in enumerate(ranks):
        for got, (name, want, want_upd, y, y_upd) in zip(results, wants):
            msg = f"{name}, rank {r}"
            assert got["plan_sessions"] == 2, msg
            np.testing.assert_array_equal(got["rows"], y[2 * r:2 * r + 2],
                                          err_msg=msg)
            np.testing.assert_array_equal(got["y"], y, err_msg=msg)
            np.testing.assert_array_equal(got["y_upd"], y_upd, err_msg=msg)
            np.testing.assert_allclose(got["y"], want, atol=ATOL, rtol=0,
                                       err_msg=msg)
            np.testing.assert_allclose(got["y_upd"], want_upd, atol=ATOL,
                                       rtol=0, err_msg=msg)


def test_mesh_of_one_and_its_helpers():
    """Without a process group the mesh is one rank and every helper
    returns its input; on a (dp, tp) mesh shard_batch and shard_cache keep
    the rank's dp rows (and pass per-layer constants as they are);
    a session count that dp does not divide is refused."""
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.tp, mesh.dp_index, mesh.size) == (1, 1, 0, 1)
    x = torch.arange(24.0).reshape(4, 6)
    assert shard_batch(mesh, x) is x and gather_batch(mesh, x) is x
    assert replicate(mesh, {"w": x})["w"] is x
    with pytest.raises(ValueError, match="one process per card"):
        make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(group=object(), device="cpu")
    if not torch.cuda.is_available():  # one rank: the device as on one card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()

    m = Mesh(dp=2, tp=2, dp_index=1, tp_index=0, group=None,
             device=torch.device("cpu"))
    assert m.shape == {"dp": 2, "tp": 2} and m.rows(4) == slice(2, 4)
    assert torch.equal(shard_batch(m, x), x[2:])
    assert shard_batch(m, 3.0) == 3.0
    caches = {"a": [{"original": x, "const": torch.ones(6)}, {}]}
    got = shard_cache(m, caches, batch=4)
    assert torch.equal(got["a"][0]["original"], x[2:])
    assert got["a"][0]["const"] is caches["a"][0]["const"]
    assert got["a"][1] == {}
    with pytest.raises(ValueError, match="over dp=2"):
        m.rows(3)

    server = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**CFG)),
                           device="cpu")
    server.mesh = m  # dp = 2 without a group: prime refuses before a step
    with pytest.raises(ValueError, match="sessions over dp=2"):
        server.prime(torch.zeros(3, 1, R, R, 3), torch.zeros(3, 1))
    with pytest.raises(ValueError, match="beside a mesh"):
        TwinStepServer(SIGEFusedUNet(DDPMUNetConfig(**CFG)), None, {},
                       device="meta", mesh=mesh)
