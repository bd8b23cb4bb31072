"""Device time of the operations launched inside the harness's
``portbench.update`` ranges, over the update calls."""


def read(trace):
    ops = trace.launched_inside("portbench.update")
    if not trace.updates or not ops:
        return None
    return trace.device_seconds(ops) * 1e3 / trace.updates
