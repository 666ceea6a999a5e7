"""One rank of ``tests/test_torch_mesh.py``: joins a gloo process group
through a file, runs the port's servers on a (dp, tp) mesh over the CPU
on the tasks of a job file, and saves what ``gather_batch`` assembled.
It imports torch and the port only (no JAX), so a rank starts in a few
seconds.

    python tests/torch_mesh_worker.py RANK WORLD INIT_FILE JOB OUT_DIR

A task is a dict: ``kind`` ("twin" or "sessions"), ``tp``, ``cfg`` (the
DDPM U-Net's config fields), ``state`` (its weights: rank 0 takes them,
the others get them from rank 0's broadcast), the global inputs, and for
"twin" the shared host plan, for "sessions" the layout and the
per-session mask pyramids.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from sige_torch.models.ddpm import DDPMUNetConfig, SIGEFusedUNet
from sige_torch.nn.engine import plan_sessions
from sige_torch.parallel import (SessionServer, TwinStepServer, gather_batch,
                                 make_mesh)


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
            "plan_sessions": plan_sessions(server.model.plan_host),
            "dp": mesh.dp, "tp": mesh.tp}


TASKS = {"twin": twin, "sessions": sessions}


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
