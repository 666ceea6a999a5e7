"""The yardstick's arithmetic: peaks, the end-to-end metrics over a
window, busy time as a union of intervals, and the operations and bytes
of the kernels whose rooflines the benchmark reads.

Peaks are NVIDIA's published H100 SXM figures, dense: 495 TFLOP/s TF32 on
the tensor cores (the most a float32-accurate path can reach: a split-TF32
kernel keeps fp32 accuracy on them) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def p95_ms(step_s: Sequence[float]) -> float:
    """The 95th percentile of every step's time, in ms."""
    return float(np.percentile(np.asarray(step_s, np.float64) * 1e3, 95))


def session_steps_per_s(sessions: int, steps: int, window_s: float) -> float:
    """Session-steps completed over the whole window."""
    return sessions * steps / window_s


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end] intervals (seconds)."""
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] outside the intervals."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def flash_flops(B: int, N: int, M: int, H: int, D: int) -> float:
    """QK^T and PV: 4 B H N M D."""
    return 4.0 * B * H * N * M * D


def flash_bytes(B: int, N: int, M: int, H: int, D: int,
                bias_rows: int) -> float:
    """q and out read and written once, k and v read once, the key bias
    read once (fp32)."""
    return F32 * (2 * B * N * H * D + 2 * B * M * H * D + bias_rows * M)


def flash_bound_s(B, N, M, H, D, bias_rows) -> float:
    """The least time one attention call can take on the card."""
    return max(flash_flops(B, N, M, H, D) / PEAK_FLOPS,
               flash_bytes(B, N, M, H, D, bias_rows) / PEAK_BYTES_PER_S)


def bytes_bound_s(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S


def in_image(origins: Optional[np.ndarray], S: int, H: int, W: int,
             EH: int, EW: int, clamp: bool) -> int:
    """Pixels of S windows of EH x EW at ``origins`` ([S, 2] top-left
    corners, None: all inside) that lie inside H x W, summed."""
    if origins is None:
        return S * EH * EW
    r, c = origins[:, 0].astype(np.int64), origins[:, 1].astype(np.int64)
    if clamp:
        r = np.clip(r, 0, max(H - EH, 0))
        c = np.clip(c, 0, max(W - EW, 0))
    rows = np.clip(r + EH, 0, H) - np.clip(r, 0, H)
    cols = np.clip(c + EW, 0, W) - np.clip(c, 0, W)
    return int((rows * cols).sum())


def needed_flops(by_region: Mapping, fracs: Mapping) -> float:
    """An edit's operations: the dense layers' whole, each sparse
    region's in the share its resolution's mask covers."""
    return sum(v * (1.0 if key is None else fracs[key])
               for key, v in by_region.items())
