"""Device-idle ms a traced step inside the port's ``sige.engine.sparse``
spans (the enqueue of the sparse forward): each idle gap of the device
intersected with those spans, so the card waiting on the forward's
Python."""


def read(rec):
    t = rec.trace
    if t is None or "sige.engine.sparse" not in t.spans:
        return None
    return 1e3 * t.forward_idle_s / rec.trace_steps
