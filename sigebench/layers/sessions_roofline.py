"""The session kernels' share of their roofline, in %: the bytes each
``crop_sessions_f32`` and ``paste_sessions_f32`` call must move, once in
and once out, at 3.35 TB/s, over their device time in the traced steps."""

from ..metrics import bytes_bound_s


def read(rec):
    t = rec.trace
    if t is None or not t.session_s or not t.session_bytes:
        return None
    return 100.0 * bytes_bound_s(t.session_bytes) / t.session_s
