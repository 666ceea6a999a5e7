"""Host ms a traced step inside ``sige.serving.install`` (the port's span
around ``SessionServer._install``: restacking the sessions' plans, any
re-pin or rebuild, and the upload of the changed leaves)."""


def read(rec):
    spans = getattr(rec.trace, "spans", None)
    if not spans or "sige.serving.install" not in spans:
        return None
    return 1e3 * spans["sige.serving.install"][1] / rec.trace_steps
