"""What the suite CLIs share: the ``--device`` flag, the profile of one
forward on the CPU (the runners' ``profile`` times the GPU on CUDA
events), the ``--trace`` context and the per-image log lines."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def add_device_flag(p) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")


def profile(runner, original, edited, warmup: int, iters: int,
            mode: str = "sparse"):
    """``runner.profile`` on the GPU; on the CPU the same statistics from
    the host clock around each forward, with the resident parameters,
    caches and plan (no peak memory)."""
    from ..runners.common import memory_entry

    if runner.device.type == "cuda":
        return runner.profile(original, edited, warmup=warmup, iters=iters,
                              mode=mode)
    _, x1, mask = runner.preprocess(original, edited)
    args = (x1, runner._cond()) if hasattr(runner, "_cond") else (x1,)
    fwd = getattr(runner.model, mode)
    for _ in range(warmup):
        fwd(*args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fwd(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"latency_ms": float(np.median(times)),
            "latency_p90_ms": float(np.percentile(times, 90)),
            "iters": iters, "macs_g": runner.count_macs(x1, mode) / 1e9,
            "edit_ratio": float(np.mean(mask)), "peak_mb": None,
            **memory_entry(runner.model, mode),
            "active_layout": runner.active_layout}


@contextlib.contextmanager
def trace(directory, device: torch.device):
    """A torch.profiler trace of the block, written as a Chrome trace to
    ``directory/trace.json`` (view it in chrome://tracing or Perfetto);
    nothing without a directory."""
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def profile_line(name: str, stats) -> str:
    """The reference's profile log line (diffusion/runner.py:214-246)."""
    return (f"Image {name}: Sparsity {100 * stats['edit_ratio']:.2f}%    "
            f"MACs {stats['macs_g']:.3f}G    "
            f"Avg Time {stats['latency_ms']:.3f}ms")


def tiles(model) -> str:
    """``live/capacity`` tiles of the model's current plan."""
    stats = model.stats()
    return (f"{sum(v['tiles'] for v in stats.values())}/"
            f"{sum(v['capacity'] for v in stats.values())}")
