"""Runtime calls that make the host wait for the device (stream, device
and event synchronisations, synchronous copies) inside the harness's
``portbench.update`` ranges, over the update calls."""

from portbench.profile import BLOCKING


def read(trace):
    if not trace.updates or not trace.runtime:
        return None
    waits = [e for e in trace.inside(trace.runtime, "portbench.update") if e.name in BLOCKING]
    return len(waits) / trace.updates
