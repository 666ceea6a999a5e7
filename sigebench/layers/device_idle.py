"""The traced window's share with no operation on the device, in %: one
less the union of the device's operation intervals over the window."""


def read(rec):
    t = rec.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
