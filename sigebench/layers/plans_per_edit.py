"""Plans the port built per edit over the timed window: its
``plans_built`` counter over its ``edits`` counter (1.0: no re-pin and no
4-form rebuild built a plan beyond the edits' own)."""


def read(rec):
    c = rec.counters
    if not c or not c.get("edits"):
        return None
    return c["plans_built"] / c["edits"]
