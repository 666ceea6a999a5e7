"""Host ms a traced step inside ``sige.serving.install`` (the port's span
around ``SessionServer._install``: writing the edited sessions' rows of
the stacked plan, any re-pin or rebuild, and the plan's copy to the
device)."""


def read(rec):
    if rec.trace is None or "sige.serving.install" not in rec.trace.spans:
        return None
    return 1e3 * rec.trace.spans["sige.serving.install"][1] / rec.trace_steps
