"""Device operations (kernels, copies, fills) in the traced window, over
the batches handed to the library in it."""


def read(trace):
    if not trace.batches or not trace.device_ops:
        return None
    return len(trace.device_ops) / trace.batches
