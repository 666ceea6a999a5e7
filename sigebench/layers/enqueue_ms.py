"""Host ms from a ``SessionServer.step`` call to its return, before the
synchronise (installing the plan and enqueueing the sparse forward), the
mean over the window's steps."""


def read(rec):
    if not rec.enqueue_s:
        return None
    return 1e3 * sum(rec.enqueue_s) / len(rec.enqueue_s)
