"""The window replay for stacked sessions whose first edits give equal
window extents.

:class:`.windows.SessionWindows` refuses such sessions, since the
program's stack might then run them unpinned. ``PlanStack`` stacks
without pins only when every leaf shape of the sessions' plans agrees:
the window extents and also each gather's tile capacity and each cropped
box. Sessions with different edits give plans that differ in those
shapes, so the program's first stack fails and ``_repin()`` pins the
extents with the capacities. :class:`PinnedWindows` replays that: equal
first extents are pinned at once, and from there on it is the accepted
replay. A replay that departs from the program's windows puts the
recomputed regions elsewhere than the program does, and the check reads
the outputs as not correct.
"""

from __future__ import annotations

from typing import Dict, List

from .windows import IntPair, SessionWindows, Window


class PinnedWindows(SessionWindows):
    """:class:`SessionWindows` that pins equal first extents at once."""

    def current(self) -> List[Dict[IntPair, Window]]:
        if (self.pins is None and len(self.windows) > 1
                and all(w is not None for w in self.windows)):
            ext = [self._extents(i) for i in range(len(self.windows))]
            if all(e == ext[0] for e in ext[1:]):
                self.pins = dict(ext[0])
        return super().current()
