"""Device ms per traced step of the flash kernels (``flash_fwd_f32`` and
``flash_combine_f32``), from the profiler."""


def read(rec):
    t = rec.trace
    if t is None or not t.flash_s:
        return None
    return 1e3 * t.flash_s / rec.trace_steps
