"""Device ms per traced step of the kernels that PyTorch's convolution
ops launch (cuDNN and cuBLAS), from the profiler."""


def read(rec):
    t = rec.trace
    if t is None or not t.conv_s:
        return None
    return 1e3 * t.conv_s / rec.trace_steps
