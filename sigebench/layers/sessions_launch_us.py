"""Host us of one launch of a session kernel: the mean length of the
port's ``sige.kernel.crop`` and ``sige.kernel.paste`` spans (the host
work of one ``crop_sessions_f32`` or ``paste_sessions_f32`` launch
through ctypes) in the traced steps."""

NAMES = ("sige.kernel.crop", "sige.kernel.paste")


def read(rec):
    spans = {} if rec.trace is None else rec.trace.spans
    rows = [spans[n] for n in NAMES if n in spans]
    calls = sum(r[0] for r in rows)
    if not calls:
        return None
    return 1e6 * sum(r[1] for r in rows) / calls
