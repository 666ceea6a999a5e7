"""The operations the window's edits need (each layer's at the share of
its resolution the session's mask covers; the dense layers' whole) over
the window's wall time at the card's 495 TFLOP/s TF32 peak, in %."""

from ..metrics import PEAK_FLOPS


def read(rec):
    if rec.flops is None or not rec.window_s:
        return None
    return 100.0 * rec.needed_flops() / (rec.window_s * PEAK_FLOPS)
