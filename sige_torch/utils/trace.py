"""Spans and counters of the port, on the profiler's clock.

Spans are ``torch.profiler`` ranges named ``sige.<layer>.<name>`` around
the work at the port's layer boundaries:

* ``sige.serving.set_masks``: ``SessionServer.set_masks`` (one session's
  plan);
* ``sige.serving.step``: ``SessionServer.step``, holding
  ``sige.serving.install`` (``SessionServer._install``: the stacked plan
  on the card and in the model), which holds ``sige.serving.stack``
  (``PlanStack.stacked``: the rows written in place, or a full restack
  with any re-pin, re-form and rebuild) and ``sige.serving.upload``
  (``ResidentPlan.update``: the rows written into the staging buffer and
  the copy, or a new layout's buffers); then ``sige.engine.sparse``
  (``SIGEModel.sparse``: the forward's enqueue);
* ``sige.op.<kind>``: each SIGE op's sparse-mode ``forward`` (``gather``,
  ``scatter``, ``scatter_gather``, ``block_residual``, ``conv``, ``norm``:
  the folded norms), the window-resident chain steps of the blocks
  (``chain``), and every call of the attention entries ``mha`` /
  ``masked_mha`` (``attention``);
* ``sige.op.transformer``: each SD spatial transformer's sparse-mode
  ``forward`` (``models/sd/unet.py SIGESpatialTransformer``), on the
  window chain, off it and in the dense middle, holding the
  ``sige.op.chain`` (its window chain), ``attention`` and other op spans
  inside it;
* ``sige.kernel.flash``, ``sige.kernel.crop``, ``sige.kernel.paste``: the
  host work of one launch of a hand-written kernel through ctypes.

A span is live exactly while a ``torch.profiler`` records (any profiler:
``torch.profiler.profile``, a CLI's ``--trace``), so the spans share the
device trace's clock and every idle stretch of the device can be put down
to the innermost span open across it. With no profiler, :func:`span`
returns one shared no-op context manager: no allocation, no
:data:`record_function` and no string formatting.

A span is a host operation range (``_RecordFunctionFast``, category
``cpu_op``), not a user annotation (``torch.profiler.record_function``):
the profiler mirrors every user annotation onto the device's timeline as
a range over the kernels launched inside it, which a reader of the trace
would take for device work. It also takes about a tenth of a user
annotation's host time while recording (about 1 us against 11 us).

Counters are plain integers, always on, in :data:`counters`:

* ``edits``: ``PlanStack.set`` calls (each plans one session's edit);
* ``plans_built``: every plan ``PlanStack`` builds (the edit's own, the
  rebuilds of a re-pin and of the switch to the 4-form window metas);
* ``plan_row_installs``: ``ResidentPlan.update`` calls that moved rows
  written in place (the edited sessions' rows, one copy);
* ``plan_full_installs``: ``ResidentPlan.update`` calls that built a
  layout anew (the first, and those after a re-pin or the switch to the
  4-form window metas);
* ``conv_new_shapes``: convolutions inside the engine's ``fp32_scope``
  whose key (input shape and memory format, weight shape, stride,
  padding, groups, dtype) is new to the process; on CUDA in cuDNN's
  benchmark mode each is one timing of cuDNN's algorithms;
* ``transformer_chain_blocks``: transformer blocks a sparse-mode forward
  ran on the window chain's masked stale-K/V path;
* ``transformer_dense_blocks``: transformer blocks a sparse-mode forward
  ran any other way (the dense middle, the non-chain sparse path).

:func:`snapshot` returns them beside the kernel wrappers' launch counters
(``flash_mha.launches`` and the others, which stay where they are), so a
reader finds every counter in one dict.
"""

from __future__ import annotations

from typing import Dict

import torch

_recording = torch._C._autograd._profiler_enabled
record_function = torch._C._profiler._RecordFunctionFast


class _Off:
    """The no-op context manager every span is while no profiler
    records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


OFF = _Off()


def span(name: str):
    """A host range named ``name`` while a profiler records, else
    :data:`OFF`."""
    if _recording():
        return record_function(name)
    return OFF


counters: Dict[str, int] = {"edits": 0, "plans_built": 0,
                            "plan_row_installs": 0, "plan_full_installs": 0,
                            "conv_new_shapes": 0,
                            "transformer_chain_blocks": 0,
                            "transformer_dense_blocks": 0}

#: Depth of the engine's ``fp32_scope`` (``nn/engine.py``): convolutions
#: count toward ``conv_new_shapes`` only inside it.
engine_scopes = 0

_conv_keys = set()


def conv_key(key) -> None:
    """Count a convolution whose key the process has not seen."""
    if key not in _conv_keys:
        _conv_keys.add(key)
        counters["conv_new_shapes"] += 1


def snapshot() -> Dict[str, int]:
    """Every counter of the port now: :data:`counters` and the kernel
    wrappers' launch counters."""
    from ..ops.flash import flash_mha
    from ..ops.sessions import crop_sessions, paste_sessions

    return {**counters,
            "flash_launches": flash_mha.launches,
            "flash_tc_launches": flash_mha.tc_launches,
            "flash_combine_launches": flash_mha.combine_launches,
            "crop_launches": crop_sessions.launches,
            "crop_scalar_launches": crop_sessions.scalar_launches,
            "paste_launches": paste_sessions.launches,
            "paste_scalar_launches": paste_sessions.scalar_launches}
