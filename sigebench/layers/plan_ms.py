"""Host ms of one ``SessionServer.set_masks`` call (planning one session's
edit), the mean over the window's calls."""


def read(rec):
    if not rec.plan_s:
        return None
    return 1e3 * sum(rec.plan_s) / len(rec.plan_s)
