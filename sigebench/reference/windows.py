"""Where the window layout recomputes: the canonical windows.

In the window layout a sparse conv recomputes its tiles' outputs (the
rule of :func:`.common.coverage`) only inside one bucketed window per
output resolution, which every gather at that resolution shares: the
mask's bounding box at that resolution on a mod-16 lattice (mod 4 below
64 px), grown so that each window covers half of the next finer one plus
a one-pixel halo, resolutions whose window would cover more than 3/4 of
the canvas left to the tile layout. Sessions that run stacked share
window extents: each extent is pinned to the largest any session has
needed since the server was primed, and the windowed resolutions to
those every session could window when the pins were first set.

This module works those windows out again from the masks and the order
in which they were set, with the rules of ``sige_tpu``'s planner
(``sige_tpu/nn/planner.py`` and ``sige_tpu/parallel/serving.py``
PlanStack, which the program follows). It reads nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

IntPair = Tuple[int, int]
Window = Tuple[int, int, int, int]  # r0, c0, WH, WW

MAX_COVER = 0.75


def _fit(lo: int, hi: int, limit: int, mult: int,
         min_size: int = 0) -> Tuple[int, int]:
    """[lo, hi) bucketed to a size of -2 mod ``mult`` (at least
    ``min_size``, at most ``limit``), its start nudged so that a 3x3
    conv's halo stays inside the canvas where it can."""
    size = min(max(-(-(hi - lo + 2) // mult) * mult - 2, min_size), limit)
    s_min = max(hi - size, 0)
    s_max = min(int(lo), limit - size)
    start = s_max
    if s_min <= s_max and size + 2 <= limit:
        h_min, h_max = max(s_min, 1), min(s_max, limit - size - 1)
        if h_min <= h_max:
            start = h_max
    return max(start, 0), size


def _bounds(mask: np.ndarray, mult: int) -> List[int]:
    H, W = mask.shape
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0:
        return [0, min(mult, H), 0, min(mult, W)]
    return [int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1]


def _mult(res: IntPair) -> int:
    return 16 if min(res) >= 64 else 4


def canonical_windows(masks: Mapping[IntPair, np.ndarray],
                      consumed: Iterable[IntPair],
                      pins: Optional[Mapping[IntPair, IntPair]] = None
                      ) -> Dict[IntPair, Window]:
    """{res: (r0, c0, WH, WW)} for one mask pyramid: over the
    resolutions some sparse conv outputs (``consumed``), or with
    ``pins`` ({res: (WH, WW)}) over the pinned ones, each window at least
    its pin."""
    consumed = set(consumed)
    reses = sorted(r for r in masks if r in consumed
                   and (pins is None or r in pins))
    lo = {r: _bounds(np.asarray(masks[r], bool), _mult(r)) for r in reses}
    if pins is None:
        def cover(r):
            b = lo[r]
            _, wh = _fit(b[0], b[1], r[0], _mult(r))
            _, ww = _fit(b[2], b[3], r[1], _mult(r))
            return wh * ww / float(r[0] * r[1])
        reses = [r for r in reses if cover(r) <= MAX_COVER]
        lo = {r: lo[r] for r in reses}

    def fit(r):
        b = lo[r]
        pin = pins.get(r, (0, 0)) if pins else (0, 0)
        r0, wh = _fit(b[0], b[1], r[0], _mult(r), pin[0])
        c0, ww = _fit(b[2], b[3], r[1], _mult(r), pin[1])
        return (r0, c0, wh, ww)

    while True:
        fitted = {r: fit(r) for r in reses}
        changed = False
        for r in reses:
            dbl = (2 * r[0], 2 * r[1])
            if dbl in fitted:
                r0, c0, wh, ww = fitted[dbl]
                b = lo[r]
                want = [min(b[0], max(r0 // 2 - 1, 0)),
                        max(b[1], min(-(-(r0 + wh) // 2) + 1, r[0])),
                        min(b[2], max(c0 // 2 - 1, 0)),
                        max(b[3], min(-(-(c0 + ww) // 2) + 1, r[1]))]
                if want != b:
                    lo[r] = want
                    changed = True
        if not changed:
            break
    return {r: fit(r) for r in reses}


class SessionWindows:
    """The windows of S stacked sessions as edits are set one by one:
    :meth:`set` when a session's mask changes, :meth:`current` before a
    step. Pins start unset (each session's own windows, then their
    common resolutions), then only grow."""

    def __init__(self, num_sessions: int, consumed: Iterable[IntPair]):
        self.consumed = set(consumed)
        self.masks: List[Optional[Mapping]] = [None] * num_sessions
        self.windows: List[Optional[Dict]] = [None] * num_sessions
        self.pins: Optional[Dict[IntPair, IntPair]] = None
        self._settled = False

    def set(self, i: int, masks: Mapping[IntPair, np.ndarray]) -> None:
        self.masks[i] = masks
        self.windows[i] = canonical_windows(masks, self.consumed, self.pins)
        self._settled = False

    def _extents(self, i):
        return {r: (w[2], w[3]) for r, w in self.windows[i].items()}

    def current(self) -> List[Dict[IntPair, Window]]:
        """Every session's windows as the next step runs them."""
        if self._settled:
            return self.windows
        if any(w is None for w in self.windows):
            raise RuntimeError("a session has no mask")
        for _ in range(16):
            ext = [self._extents(i) for i in range(len(self.windows))]
            if len(ext) == 1 or (self.pins is not None
                                 and all(e == ext[0] for e in ext[1:])):
                self._settled = True
                return self.windows
            if self.pins is None and all(e == ext[0] for e in ext[1:]):
                # the program's stack would then stack without pins, which
                # this replay does not follow: traffic starts with unequal
                # edits
                raise ValueError("the first edits of the sessions give "
                                 "equal windows")
            common = set(ext[0])
            for e in ext[1:]:
                common &= set(e)
            self.pins = {r: (max(e[r][0] for e in ext),
                             max(e[r][1] for e in ext)) for r in common}
            for i, m in enumerate(self.masks):
                if self._extents(i) != self.pins:
                    self.windows[i] = canonical_windows(m, self.consumed,
                                                        self.pins)
        raise RuntimeError("session windows did not settle")
