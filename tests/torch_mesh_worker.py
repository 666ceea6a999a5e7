"""One rank of ``tests/test_torch_mesh.py`` and
``tests/test_torch_spatial.py``: joins a gloo process group through a
file, runs the tasks of a job file over the CPU and saves what each
returns. It imports torch and the port only (no JAX), so a rank starts
in a few seconds.

    python tests/torch_mesh_worker.py RANK WORLD INIT_FILE JOB OUT_DIR

A task is a dict with a ``kind``:

  * "twin" and "sessions": the port's servers on a (dp, tp) mesh:
    ``tp``, ``cfg`` (the DDPM U-Net's config fields), ``state`` (its
    weights: rank 0 takes them, the others get them from rank 0's
    broadcast), the global inputs, and for "twin" the shared host plan,
    for "sessions" the layout and the per-session mask pyramids; the
    rows ``gather_batch`` assembled;
  * "spatial": one model on the ("sp",) mesh of the world: ``model``
    (a key of ``MODELS``), ``cfg``, ``kwargs`` (the module's other
    arguments), ``state`` (as above), the global ``inputs``; ``spatial_apply``'s band and gathered rows and the
    collectives it ran; with ``full`` also ``spatial_full_apply``'s
    gathered output and caches (on rank 0), this rank's caches that are
    not bands, the banded keys and the meta; with ``masks`` and
    ``edited`` also, on rank 0, the sparse forward of a one-process
    model that adopted the gathered caches (the big-canvas composition);
  * "spatial_errors": the messages of the errors the sp entry points
    raise (a height not divisible by the ranks, an odd band under a
    stride-2 conv, sparse mode with a band).
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.models.gaugan import (SIGEFusedSPADEGenerator,
                                      SIGESubMobileSPADEGenerator,
                                      SPADEGenConfig, VanillaSPADEGenerator)
from sige_torch.models.pd import PDUNetConfig, SIGEPDUNet
from sige_torch.models.sd import (SDUNetConfig, SDVAEConfig, SIGEDecoder,
                                  SIGEEncoder, SIGESDUNet)
from sige_torch.nn import SIGECtx, SIGEModel
from sige_torch.nn.planner import plan_leaves
from sige_torch.parallel import (RowBand, SessionServer, TwinStepServer,
                                 gather_batch, gather_caches, gather_rows,
                                 make_mesh, make_spatial_mesh, replicate,
                                 spatial_apply, spatial_full_apply)

MODELS = {"decoder": (SDVAEConfig, SIGEDecoder),
          "encoder": (SDVAEConfig, SIGEEncoder),
          "ddpm": (DDPMUNetConfig, SIGEFusedUNet),
          "pd": (PDUNetConfig, SIGEPDUNet),
          "sd_unet": (SDUNetConfig, SIGESDUNet),
          "gaugan": (SPADEGenConfig, SIGEFusedSPADEGenerator),
          "gaugan_sub": (SPADEGenConfig, SIGESubMobileSPADEGenerator),
          "gaugan_vanilla": (SPADEGenConfig, VanillaSPADEGenerator)}


def _np(t):
    return t.detach().cpu().numpy()


def twin(task, rank):
    mesh = make_mesh(tp=task["tp"], device="cpu")
    server = TwinStepServer(SIGEFusedUNet(DDPMUNetConfig(**task["cfg"])),
                            task["state"] if rank == 0 else None,
                            task["plan"], mesh=mesh)
    x0, x1, t = (torch.from_numpy(a) for a in task["inputs"])
    server.prime(x0, t)
    y0, y1 = server.step(x0, x1, t)
    return {"rows": _np(y1), "y0": _np(gather_batch(mesh, y0)),
            "y1": _np(gather_batch(mesh, y1)), "dp": mesh.dp, "tp": mesh.tp,
            "coords": (mesh.dp_index, mesh.tp_index)}


def sessions(task, rank):
    mesh = make_mesh(tp=task["tp"], device="cpu")
    server = SessionServer(SIGEFusedUNet(DDPMUNetConfig(**task["cfg"])),
                           task["state"] if rank == 0 else None,
                           bucket_min=1, layout=task["layout"], mesh=mesh)
    x0, x1, t = (torch.from_numpy(a) for a in task["inputs"])
    server.prime(x0, t)
    for i, m in enumerate(task["masks"]):
        server.set_masks(i, m)
    y = server.step(x1, t)
    y_upd = server.step(x1, t, sparse_update=True)
    return {"rows": _np(y), "y": _np(gather_batch(mesh, y)),
            "y_upd": _np(gather_batch(mesh, y_upd)),
            # S leads every leaf of the installed plan
            "plan_sessions": int(plan_leaves(server.model.plan_host)[0][1]
                                 .shape[0]),
            "dp": mesh.dp, "tp": mesh.tp}


def make(task):
    config, cls = MODELS[task["model"]]
    return cls(config(**task["cfg"]), **task.get("kwargs", {}))


def build(task, mesh):
    """The task's module with rank 0's weights on every rank."""
    module = make(task)
    module.load_state_dict(replicate(
        mesh, task["state"] if mesh.index == 0 else module.state_dict()))
    return module


def _caches_np(caches):
    return {path: [{k: _np(t) for k, t in d.items()} for d in slots]
            for path, slots in caches.items()}


def spatial(task, rank):
    mesh = make_spatial_mesh(device="cpu")
    module = build(task, mesh)
    inputs = [torch.from_numpy(a) for a in task["inputs"]]
    y = spatial_apply(mesh, module, *inputs)
    out = {"counts": dict(mesh.counts), "rows": _np(y),
           "dense": _np(gather_rows(mesh, y)), "sp": mesh.shape["sp"]}
    if not task.get("full"):
        return out
    y, caches, meta = spatial_full_apply(mesh, module, *inputs)
    out["full"] = _np(gather_rows(mesh, y))
    out["meta"] = meta
    out["banded"] = sorted(caches.rows)
    out["consts"] = {(path, slot, k): _np(t)
                     for path, slots in caches.items()
                     for slot, d in enumerate(slots) for k, t in d.items()
                     if (path, slot, k) not in caches.rows}
    whole = gather_caches(mesh, caches, dst=0)
    if rank == 0:
        out["caches"] = _caches_np(whole)
        if task.get("masks") is not None:
            one = SIGEModel(make(task), bucket_min=1, device="cpu")
            one.module.load_state_dict(module.state_dict())
            one.adopt_full(whole, meta, *inputs)
            one.set_masks(task["masks"])
            out["sparse"] = _np(one.sparse(
                *[torch.from_numpy(a) for a in task["edited"]]))
    return out


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def spatial_errors(task, rank):
    mesh = make_spatial_mesh(device="cpu")
    module = build(task, mesh)
    x = torch.from_numpy(task["inputs"][0])
    return {"not_divisible": _message(
                lambda: spatial_apply(mesh, module, x[:, 1:])),
            "odd_band": _message(
                lambda: spatial_apply(mesh, module, x[:, :task["odd_h"]])),
            "sparse": _message(
                lambda: SIGECtx(mode="sparse", band=RowBand(mesh)))}


TASKS = {"twin": twin, "sessions": sessions, "spatial": spatial,
         "spatial_errors": spatial_errors}


def main(rank: int, world: int, init_file: str, job: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        tasks = torch.load(job, weights_only=False)
        results = [TASKS[t["kind"]](t, rank) for t in tasks]
        np.save(f"{out_dir}/rank{rank}.npy", np.array(results, object),
                allow_pickle=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
