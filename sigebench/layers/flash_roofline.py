"""The flash kernels' share of their roofline, in %: each call's least
time (the larger of 4 B H N M D operations at 495 TFLOP/s and q, k, v,
out and the key bias moved once at 3.35 TB/s), summed over the traced
calls, over the device time of ``flash_fwd_f32`` and
``flash_combine_f32``."""


def read(rec):
    t = rec.trace
    if t is None or not t.flash_s or not t.flash_bound_s:
        return None
    return 100.0 * t.flash_bound_s / t.flash_s
