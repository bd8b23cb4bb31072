"""Device time of the operations launched inside the harness's
``portbench.compute`` ranges, over the computes."""


def read(trace):
    ops = trace.launched_inside("portbench.compute")
    if not trace.computes or not ops:
        return None
    return trace.device_seconds(ops) * 1e3 / trace.computes
