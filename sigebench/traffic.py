"""The one traffic generator: a mix's data file in, seeded edits and their
schedule out.

A mix (``sigebench/traffic/<name>.json``) gives:

* ``model``: the part of the configuration the sessions drive;
* ``sessions`` S and ``layout`` ("window" or "tiles");
* ``pool``: edits drawn per session at set-up, sent in a cycle;
* ``squares`` [lo, hi]: squares per edit (a cycle over the pool), and
  ``area`` [lo, hi]: the area of each square as a share of the image (the
  pool's areas spread evenly over the range; the pool's edits in an order
  drawn from the seed); ``gap``: the squares of one edit lie on a
  diagonal, this share of the image apart, so every draw of an edit
  spans the same box;
* ``border_session``: the session whose squares touch the top border;
* ``period`` and ``stagger``: session i sends its next edit at the steps
  k >= 1 with (k - i * stagger) mod period == 0;
* ``trace_steps``: steps under the profiler in a traced run;
* ``compared_steps``: how many steps of the window the reference checks,
  drawn from the seed (every session's output of each).

Every seed gives the same sizes and arrivals in another order and at
other places, so the work of a run does not depend on its seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Tuple

import numpy as np

KEYS = {"model", "sessions", "layout", "pool", "squares", "area", "gap",
        "border_session", "period", "stagger", "trace_steps",
        "compared_steps"}


@dataclasses.dataclass
class Traffic:
    """The edits of every session: ``masks[i][e]`` the bool [R, R] image
    mask of session i's e-th edit; the schedule as :meth:`arrivals`."""

    mix: Mapping
    masks: List[List[np.ndarray]]

    @property
    def sessions(self) -> int:
        return int(self.mix["sessions"])

    @property
    def pool(self) -> int:
        return int(self.mix["pool"])

    def arrivals(self, k: int) -> List[int]:
        """The sessions that send a new edit before window step ``k``."""
        if k < 1:
            return []
        period, stagger = int(self.mix["period"]), int(self.mix["stagger"])
        return [i for i in range(self.sessions)
                if (k - i * stagger) % period == 0]


def check_mix(mix: Mapping) -> None:
    missing, extra = KEYS - set(mix), set(mix) - KEYS
    if missing or extra:
        raise ValueError(f"traffic keys: missing {sorted(missing)}, unknown "
                         f"{sorted(extra)}")
    if mix["layout"] not in ("window", "tiles"):
        raise ValueError(f"layout {mix['layout']!r}")
    if not 0 <= int(mix["border_session"]) < int(mix["sessions"]):
        raise ValueError("border_session is not a session")


def _place(rng, R: int, sides: List[int], gap: int, border: bool
           ) -> List[Tuple[int, int]]:
    """Top-left corners for squares of ``sides`` inside R x R: the squares
    on a diagonal, each ``gap`` beyond the previous one's corner (so
    every draw of an edit covers the same span), the diagonal's direction
    and the group's place drawn; the group on the top border when
    ``border``."""
    step = max(sides) + gap
    span = step * (len(sides) - 1) + max(sides)
    if span > R:
        raise ValueError(f"squares {sides} with gap {gap} exceed {R} px")
    r0 = 0 if border else int(rng.integers(0, R - span + 1))
    c0 = int(rng.integers(0, R - span + 1))
    flip = bool(rng.integers(0, 2))
    return [(r0 + j * step,
             c0 + ((len(sides) - 1 - j) if flip else j) * step)
            for j in range(len(sides))]


def generate(mix: Mapping, R: int, seed: int, attempt: int = 0) -> Traffic:
    """Every session's pool of edit masks at image side ``R`` (another
    draw for each ``attempt``)."""
    check_mix(mix)
    rng = np.random.default_rng([int(seed), 0x5E55, attempt])
    S, pool = int(mix["sessions"]), int(mix["pool"])
    lo_n, hi_n = (int(v) for v in mix["squares"])
    counts = [lo_n + e % (hi_n - lo_n + 1) for e in range(pool)]
    areas = np.linspace(float(mix["area"][0]), float(mix["area"][1]), pool)
    masks = []
    for i in range(S):
        order = rng.permutation(pool)
        # sessions 0 and 1 start at the two ends of the range, so their
        # first edits differ in size
        if i in (0, 1):
            want = 0 if i == 0 else pool - 1
            j = int(np.flatnonzero(order == want)[0])
            order[[0, j]] = order[[j, 0]]
        border = i == int(mix["border_session"])
        entries = []
        for e in range(pool):
            n = counts[order[e]]
            sides = [max(2, int(round((areas[order[e]] * R * R) ** 0.5)))
                     for _ in range(n)]
            m = np.zeros((R, R), bool)
            gap = int(round(float(mix["gap"]) * R))
            for (r, c), s in zip(_place(rng, R, sides, gap, border), sides):
                m[r:r + s, c:c + s] = True
            entries.append(m)
        masks.append(entries)
    return Traffic(mix, masks)


def timesteps(seq: List[int], sessions: int, seed: int) -> List[int]:
    """One timestep per session drawn from ``seq``."""
    rng = np.random.default_rng([int(seed), 0x7157])
    return [int(v) for v in rng.choice(seq, size=sessions)]
