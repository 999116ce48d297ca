"""The share of the traced window in which no device activity ran, in %."""


def read(trace):
    if not trace.window_s or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
