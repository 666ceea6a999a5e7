"""The seeded traffic: the same seed gives the same edits and schedule,
another seed others, and every seed the same sizes."""

import json
from pathlib import Path

import numpy as np
import pytest

from sigebench.traffic import generate

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_edits_other_seed_others(name):
    mix = _mix(name)
    a, b = generate(mix, 256, 2**31 + 5), generate(mix, 256, 2**31 + 5)
    c = generate(mix, 256, 2**31 + 6)
    same = all(np.array_equal(x, y) for ra, rb in zip(a.masks, b.masks)
               for x, y in zip(ra, rb))
    other = any(not np.array_equal(x, y) for ra, rc in zip(a.masks, c.masks)
                for x, y in zip(ra, rc))
    assert same and other
    assert [a.arrivals(k) for k in range(60)] == \
        [c.arrivals(k) for k in range(60)]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_draws_the_same_sizes(name):
    mix = _mix(name)
    sizes = [sorted(int(m.sum()) for row in generate(mix, 256, s).masks
                    for m in row) for s in (1, 2, 3)]
    assert sizes[0] == sizes[1] == sizes[2]


def test_schedule_staggers_sessions():
    mix = _mix("window_s8")
    t = generate(mix, 256, 7)
    sends = {i: [k for k in range(1, 80) if i in t.arrivals(k)]
             for i in range(8)}
    assert sends[0] == [25, 50, 75]
    assert sends[1] == [3, 28, 53, 78]
    assert t.arrivals(0) == []


def test_border_session_touches_the_top_and_every_draw_spans_alike():
    mix = _mix("tiles_s8")
    t = generate(mix, 256, 11)
    assert all(m[0].any() for m in t.masks[mix["border_session"]])
    for row in t.masks:
        for m in row:
            area = m.mean()
            lo, hi = mix["area"]
            n_lo, n_hi = mix["squares"]
            assert n_lo * lo * 0.9 <= area <= n_hi * hi * 1.1

    def boxes(seed):
        out = []
        for row in generate(mix, 256, seed).masks:
            for m in row:
                r, c = m.any(1).nonzero()[0], m.any(0).nonzero()[0]
                out.append((r[-1] - r[0], c[-1] - c[0]))
        return sorted(out)
    assert boxes(1) == boxes(2)


def test_first_edits_of_sessions_zero_and_one_span_the_range():
    mix = _mix("window_s8")
    t = generate(mix, 256, 3)
    assert t.masks[0][0].sum() < t.masks[1][0].sum()
    assert t.masks[0][0].sum() == min(m.sum() for m in t.masks[0])
    assert t.masks[1][0].sum() == max(m.sum() for m in t.masks[1])
