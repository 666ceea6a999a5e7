"""The 95th percentile of every window step's time, in ms: the
end-to-end ``step_ms_p95``, read as a per-layer metric (as
``step_ms_p95.<part>``) in cells whose host-paced tails spread too widely
to carry it end to end."""

from sigebench.metrics import p95_ms


def read(rec):
    if not rec.step_s:
        return None
    return p95_ms(rec.step_s)
