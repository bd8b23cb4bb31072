"""Share of the traced window's wall time in which no device operation
ran."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
