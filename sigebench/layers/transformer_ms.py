"""Host ms a traced step inside the port's ``sige.op.transformer`` spans
(each SD spatial transformer's sparse-mode forward: the window chain's
masked stale-K/V blocks, the non-chain path and the dense middle)."""


def read(rec):
    if rec.trace is None or "sige.op.transformer" not in rec.trace.spans:
        return None
    return 1e3 * rec.trace.spans["sige.op.transformer"][1] / rec.trace_steps
