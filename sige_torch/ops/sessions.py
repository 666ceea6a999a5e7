"""Crop and paste with per-session window origins: the two primitives of
a forward that runs S editing sessions as one batch.

``sige_torch.parallel.SessionServer`` runs S sessions of B samples each
as one forward at batch S*B over their stacked plans; sample
``n = s*B + b`` belongs to session ``s``. Every session has its own
window origins, which arrive as device data: an int64 tensor ``[S, 2]``
of (row, col), or the planner's 4-form window meta ``[S, 4]``
``(clamped_r, clamped_c, roll_r, roll_c)`` whose virtual origin is
``clamped - roll`` (:mod:`sige_torch.ops.window`). A host pair instead
gives one constant origin to every session (an offset that is not plan
data, such as a conv's padding). Coverage and edge masks are
``[S, h, w]`` (one per session) or ``[h, w]`` (shared).

* :func:`crop_sessions` — ``[S*B, EH, EW, C]`` windows, each sample read
  at its session's (possibly negative) origin, zero outside the image,
  with an optional fused epilogue (``ops/gather.py apply_epilogue`` with
  ``[C]`` or per-sample ``[S*B, C]`` scale and shift) and the ring
  re-zeroed where ``edge`` is False;
* :func:`paste_sessions` — a copy of ``base`` in ``win``'s dtype with
  every sample's window written at its session's origin where ``cov``
  is set.

``clamp=True`` clamps an origin so the window fits in the map, as
``jax.lax.dynamic_slice`` clamps its start (``sige_tpu`` computes both
primitives in XLA, as ``dynamic_slice`` / ``dynamic_update_slice`` with a
batched start under ``vmap``: ``sige_tpu/ops/window.py:47-66, 176-218``).

On CUDA tensors the wrappers launch the hand-written kernels of
``sige_torch/csrc/window_sessions.cu`` (``crop_sessions_f32``,
``paste_sessions_f32``; fp32, and bf16 caches of
``SIGEModel(cache_dtype=torch.bfloat16)``), built with nvcc at first use
(:class:`~sige_torch.ops.cuda_lib.CudaLibrary`), and count each launch
(``crop_sessions.launches``, ``paste_sessions.launches``; of them, the
``scalar_launches`` that took the scalar instantiation); a refused
launch raises. The host work of a launch is a few integer checks:
:func:`vector_width` picks 16-byte accesses or the scalar instantiation
from the dtypes, C, strides and pointers, :func:`row_chunks` the grid (a
block per output row, rows cut into chunks when they are few). On CPU
tensors they run the plain versions (:func:`crop_sessions_plain`,
:func:`paste_sessions_plain`), each a fixed number of PyTorch ops whatever
S is: index arithmetic, ``torch.gather`` and ``torch.where``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import trace
from .cuda_lib import CSRC, CudaLibrary
from .gather import apply_epilogue, broadcast_param

SOURCE = CSRC / "window_sessions.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIBRARY = CudaLibrary(SOURCE, "sige_window_sessions", {
    "sige_crop_sessions": (
        [_I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _L, _L, _L, _L, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P], _I),
    "sige_paste_sessions": (
        [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _P, _I, _P], _I),
})
# the CUDA source's codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"identity": 0, "swish": 1, "relu": 2, "leaky": 3, "sigmoid": 4,
         "tanh": 5}


def virtual_origin(meta: torch.Tensor) -> torch.Tensor:
    """[S, 2] virtual origins of [S, 2] origins or [S, 4] 4-form metas."""
    return meta if meta.shape[-1] == 2 else meta[:, :2] - meta[:, 2:4]


def _count(org, *masks) -> int:
    """S: the leading size of a tensor origin or of a per-session mask."""
    if isinstance(org, torch.Tensor):
        return int(org.shape[0])
    for m in masks:
        if m is not None and m.ndim == 3:
            return int(m.shape[0])
    return 1


def _rows(org, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) int64 [S] of the virtual origins."""
    if isinstance(org, torch.Tensor):
        v = virtual_origin(org.to(device=device, dtype=torch.int64))
        return v[:, 0], v[:, 1]
    r, c = (torch.full((S,), int(o), dtype=torch.int64, device=device)
            for o in org[:2])
    return r, c


def _clamp(o: torch.Tensor, extent: int, limit: int) -> torch.Tensor:
    return o.clamp(max=limit - extent).clamp(min=0)


def _per_session(mask: torch.Tensor, S: int) -> torch.Tensor:
    return mask if mask.ndim == 3 else mask[None].expand(S, *mask.shape)


def _split(N: int, S: int) -> int:
    if N % S:
        raise ValueError(f"batch {N} is not a multiple of {S} sessions")
    return N // S


def _has_epilogue(scale, shift, activation: str) -> bool:
    return scale is not None or shift is not None or activation != "identity"


def crop_sessions_plain(x: torch.Tensor, org, EH: int, EW: int,
                        edge: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        activation: str = "identity",
                        activation_first: bool = False,
                        clamp: bool = False) -> torch.Tensor:
    """Plain version of :func:`crop_sessions`."""
    N, H, W, C = x.shape
    S = _count(org, edge)
    B = _split(N, S)
    dev = x.device
    r, c = _rows(org, S, dev)
    if clamp:
        r, c = _clamp(r, EH, H), _clamp(c, EW, W)
    rows = r[:, None] + torch.arange(EH, device=dev)           # [S, EH]
    cols = c[:, None] + torch.arange(EW, device=dev)           # [S, EW]
    inside = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])        # [S, EH, EW]
    flat = (rows.clamp(0, H - 1)[:, :, None] * W
            + cols.clamp(0, W - 1)[:, None, :]).reshape(S, 1, EH * EW, 1)
    win = torch.gather(x.reshape(S, B, H * W, C), 2,
                       flat.expand(S, B, EH * EW, C))
    win = torch.where(inside.reshape(S, 1, EH * EW, 1), win,
                      torch.zeros((), dtype=x.dtype, device=dev))
    return _epilogue(win.reshape(N, EH, EW, C), S, edge, scale, shift,
                     activation, activation_first)


def _epilogue(win, S, edge, scale, shift, activation, activation_first):
    """The crop's epilogue in PyTorch: ``apply_epilogue``, then zero where
    ``edge`` is False."""
    N, EH, EW, C = win.shape
    if _has_epilogue(scale, shift, activation):
        win = apply_epilogue(win, broadcast_param(scale),
                             broadcast_param(shift), activation,
                             activation_first)
    if edge is None:
        return win
    e = _per_session(edge, S).reshape(S, 1, EH, EW, 1)
    return torch.where(e, win.reshape(S, N // S, EH, EW, C),
                       torch.zeros((), dtype=win.dtype, device=win.device)
                       ).reshape(N, EH, EW, C)


def paste_sessions_plain(base: torch.Tensor, win: torch.Tensor, org,
                         cov: Optional[torch.Tensor] = None,
                         clamp: bool = False) -> torch.Tensor:
    """Plain version of :func:`paste_sessions`: every output pixel reads
    its window pixel where the window covers it (and ``cov`` is set),
    else ``base``."""
    N, H, W, C = base.shape
    WH, WW = win.shape[1:3]
    S = _count(org, cov)
    B = _split(N, S)
    dev = base.device
    r, c = _rows(org, S, dev)
    if clamp:
        r, c = _clamp(r, WH, H), _clamp(c, WW, W)
    i = torch.arange(H, device=dev)[None, :] - r[:, None]       # [S, H]
    j = torch.arange(W, device=dev)[None, :] - c[:, None]       # [S, W]
    take = (((i >= 0) & (i < WH))[:, :, None]
            & ((j >= 0) & (j < WW))[:, None, :])                # [S, H, W]
    ic, jc = i.clamp(0, WH - 1), j.clamp(0, WW - 1)
    if cov is not None:
        take = take & _per_session(cov, S)[
            torch.arange(S, device=dev)[:, None, None], ic[:, :, None],
            jc[:, None, :]]
    flat = (ic[:, :, None] * WW + jc[:, None, :]).reshape(S, 1, H * W, 1)
    src = torch.gather(win.reshape(S, B, WH * WW, C), 2,
                       flat.expand(S, B, H * W, C))
    out = torch.where(take.reshape(S, 1, H * W, 1), src,
                      base.to(win.dtype).reshape(S, B, H * W, C))
    return out.reshape(N, H, W, C)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# the kernels' launch shape: THREADS a block and UNROLL vectors a thread
# loads at once (kThreads, kUnroll in the source), and enough blocks to
# fill the card's 132 SMs TARGET_BLOCKS // 132 times over
THREADS = 128
UNROLL = 4
TARGET_BLOCKS = 132 * 8
_MAX_CHUNKS = 65535  # grid.y
_MAX_ROW = 2 ** 30  # elements of one row, and rows, in the kernels' ints


def vector_width(width: int, C: int, views=(), flat=()) -> int:
    """The elements a kernel thread moves per access: ``width`` (16 bytes
    of the output's dtype) when C is a multiple of it and every NHWC view
    in ``views`` — ``(data_ptr, element size, strides)`` — has its channels
    at stride 1 and its other strides and data pointer aligned to
    ``width`` of its own elements, and every fp32 pointer in ``flat`` (the
    epilogue params, [rows, C]) is aligned to ``width`` floats; else 1,
    the scalar instantiation of the same kernel, which takes any
    strides."""
    if width <= 1 or C % width:
        return 1
    for ptr, size, strides in views:
        if strides[3] != 1 or ptr % (width * size) \
                or any(st % width for st in strides[:3]):
            return 1
    if any(ptr % (4 * width) for ptr in flat):
        return 1
    return width


def _view(t: torch.Tensor):
    return t.data_ptr(), t.element_size(), t.stride()


def crop_vector_width(x: torch.Tensor, params=()) -> int:
    """:func:`vector_width` of a crop of ``x`` with the fp32 epilogue
    params ``params`` ([rows, C] tensors or None). The output, a fresh
    contiguous NHWC tensor, is aligned whenever C is a multiple of the
    width."""
    return vector_width(16 // x.element_size(), x.shape[3], (_view(x),),
                        [p.data_ptr() for p in params if p is not None])


def paste_vector_width(base: torch.Tensor, win: torch.Tensor) -> int:
    """:func:`vector_width` of a paste of ``win`` over ``base`` (into a
    fresh tensor of ``win``'s dtype): 16 bytes of ``win``, so a bf16 base
    under fp32 windows is read 8 bytes at a time."""
    return vector_width(16 // win.element_size(), base.shape[3],
                        (_view(base), _view(win)))


def row_chunks(rows: int, row_vectors: int) -> int:
    """The chunks each output row is cut into: the kernels' grid is
    ``(rows, chunks)``, a block per chunk of a row. Rows are cut only until
    the grid reaches TARGET_BLOCKS, and never below THREADS * UNROLL
    vectors a chunk (a thread's loads all in flight at once)."""
    if rows > _MAX_ROW or row_vectors > _MAX_ROW:
        raise ValueError(f"{rows} rows of {row_vectors} vectors: more than "
                         f"the session kernels index")
    want = -(-TARGET_BLOCKS // max(rows, 1))
    cap = -(-row_vectors // (THREADS * UNROLL))
    return max(1, min(want, cap, _MAX_CHUNKS))


def _origin_args(org, device):
    """(origin tensor or None, k, host row, host col) for the kernels."""
    if isinstance(org, torch.Tensor):
        o = org.to(device=device, dtype=torch.int64).contiguous()
        return o, int(o.shape[1]), 0, 0
    return None, 2, int(org[0]), int(org[1])


def _same_device(t: torch.Tensor, device, what: str) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, the map on {device}")


def _mask_arg(mask: Optional[torch.Tensor], S: int, shape, device):
    if mask is None:
        return None, 0
    _same_device(mask, device, "mask")
    if mask.dtype != torch.bool or tuple(mask.shape[-2:]) != tuple(shape) \
            or mask.ndim not in (2, 3) or (mask.ndim == 3
                                           and mask.shape[0] != S):
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}: expected "
                         f"bool [{S}, {shape[0]}, {shape[1]}] or "
                         f"[{shape[0]}, {shape[1]}]")
    return mask.contiguous(), int(mask.ndim == 3)


def _param_arg(p: Optional[torch.Tensor], N: int, C: int, device):
    """(fp32 [rows, C] tensor, rows) for a per-channel or per-sample
    epilogue param the kernel takes, else False."""
    if p is None:
        return None, 1
    _same_device(p, device, "epilogue param")
    q = broadcast_param(p)
    if q.dtype != torch.float32 or q.shape[1] != 1 or q.shape[2] != 1 \
            or q.shape[3] != C or q.shape[0] not in (1, N):
        return False
    return q.reshape(q.shape[0], C).contiguous(), int(q.shape[0])


def _stream(device):
    return torch._C._cuda_getCurrentRawStream(device.index)


def _crop_cuda(x, org, EH, EW, edge, scale, shift, activation,
               activation_first, clamp):
    """Launch ``crop_sessions_f32``; an epilogue the kernel does not take
    (a bf16 input, spatially varying params) runs after it in PyTorch."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _crop_cuda(x, org, EH, EW, edge, scale, shift,
                              activation, activation_first, clamp)
    with trace.span("sige.kernel.crop"):
        N, H, W, C = x.shape
        if x.dtype not in _DTYPES:
            raise TypeError(f"crop_sessions takes fp32 or bf16, got "
                            f"{x.dtype}")
        S = _count(org, edge)
        B = _split(N, S)
        epi = _has_epilogue(scale, shift, activation)
        sc = sh = (None, 1)
        if epi and x.dtype == torch.float32:
            sc = _param_arg(scale, N, C, x.device)
            sh = _param_arg(shift, N, C, x.device)
        if epi and (x.dtype != torch.float32 or sc is False or sh is False):
            win = _crop_cuda(x, org, EH, EW, None, None, None, "identity",
                             False, clamp)
            return _epilogue(win, S, edge, scale, shift, activation,
                             activation_first)
        o, k, r0, c0 = _origin_args(org, x.device)
        e, per = _mask_arg(edge, S, (EH, EW), x.device)
        out = torch.empty((N, EH, EW, C), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        vec = crop_vector_width(x, (sc[0], sh[0]))
        chunks = row_chunks(N * EH, EW * C // vec)
        err = LIBRARY.load().sige_crop_sessions(
            _DTYPES[x.dtype], vec, chunks, x.data_ptr(), out.data_ptr(),
            _ptr(o), k, r0, c0, int(clamp), N, B, H, W, C, EH, EW,
            *x.stride(), _ptr(e), per, _ptr(sc[0]), sc[1], _ptr(sh[0]),
            sh[1], _ACTS[activation], int(activation_first), int(epi),
            _stream(x.device))
        if err != 0:
            raise RuntimeError(f"crop_sessions_f32 launch failed: CUDA error "
                               f"{err}")
        crop_sessions.launches += 1
        crop_sessions.scalar_launches += int(vec == 1)
        return out


def _paste_cuda(base, win, org, cov, clamp):
    """Launch ``paste_sessions_f32``."""
    if base.device.index != torch.cuda.current_device():
        with torch.cuda.device(base.device):
            return _paste_cuda(base, win, org, cov, clamp)
    with trace.span("sige.kernel.paste"):
        _same_device(win, base.device, "window")
        N, H, W, C = base.shape
        WH, WW = win.shape[1:3]
        pair = (base.dtype, win.dtype)
        if pair not in ((torch.float32, torch.float32),
                        (torch.bfloat16, torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
            raise TypeError(f"paste_sessions takes (base, window) dtypes fp32/"
                            f"fp32, bf16/fp32 or bf16/bf16, got {pair}")
        if win.shape[0] != N or win.shape[3] != C:
            raise ValueError(f"window {tuple(win.shape)} for base "
                             f"{tuple(base.shape)}")
        S = _count(org, cov)
        B = _split(N, S)
        o, k, r0, c0 = _origin_args(org, base.device)
        cv, per = _mask_arg(cov, S, (WH, WW), base.device)
        out = torch.empty((N, H, W, C), dtype=win.dtype, device=base.device)
        if out.numel() == 0:
            return out
        vec = paste_vector_width(base, win)
        chunks = row_chunks(N * H, W * C // vec)
        err = LIBRARY.load().sige_paste_sessions(
            _DTYPES[base.dtype], _DTYPES[win.dtype], vec, chunks,
            base.data_ptr(), win.data_ptr(), out.data_ptr(), _ptr(o), k, r0,
            c0, int(clamp), N, B, H, W, C, WH, WW, *base.stride(),
            *win.stride(), _ptr(cv), per, _stream(base.device))
        if err != 0:
            raise RuntimeError(f"paste_sessions_f32 launch failed: CUDA error "
                               f"{err}")
        paste_sessions.launches += 1
        paste_sessions.scalar_launches += int(vec == 1)
        return out


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version
    (CPU tensors)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def crop_sessions(x: torch.Tensor, org, EH: int, EW: int,
                  edge: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  activation: str = "identity",
                  activation_first: bool = False,
                  clamp: bool = False) -> torch.Tensor:
    """[S*B, EH, EW, C] windows of ``x`` [S*B, H, W, C], sample ``s*B + b``
    read at session ``s``'s origin (``org``: [S, 2], a [S, 4] meta, or a
    host pair for all); pixels outside the image are zero. Then, fused,
    ``scale * v + shift`` and the activation (``activation_first``: the
    other order; params [C], [S*B, C] or NHWC-broadcastable) and zero where
    ``edge`` ([S, EH, EW] or [EH, EW]) is False."""
    if _route(x, "crop_sessions"):
        return _crop_cuda(x, org, EH, EW, edge, scale, shift, activation,
                          activation_first, clamp)
    return crop_sessions_plain(x, org, EH, EW, edge, scale, shift,
                               activation, activation_first, clamp)


def paste_sessions(base: torch.Tensor, win: torch.Tensor, org,
                   cov: Optional[torch.Tensor] = None,
                   clamp: bool = False) -> torch.Tensor:
    """A copy of ``base`` [S*B, H, W, C] in ``win``'s dtype with ``win``
    [S*B, WH, WW, C] written at each session's origin (``org`` as for
    :func:`crop_sessions`), where ``cov`` ([S, WH, WW] or [WH, WW]) is
    set when given."""
    if _route(base, "paste_sessions"):
        return _paste_cuda(base, win, org, cov, clamp)
    return paste_sessions_plain(base, win, org, cov, clamp)


crop_sessions.launches = crop_sessions.scalar_launches = 0
paste_sessions.launches = paste_sessions.scalar_launches = 0


def cov_where(cov: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """``torch.where`` over NHWC ``a`` / ``b`` with a coverage mask
    [S, h, w] (S sessions, samples ``s*B + b``)."""
    S = cov.shape[0]

    def split(t):
        return t.unflatten(0, (S, -1)) if t.ndim == 4 else t

    return torch.where(cov[:, None, :, :, None], split(a),
                       split(b)).flatten(0, 1)
