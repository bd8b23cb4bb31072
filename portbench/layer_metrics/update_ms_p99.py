"""The 99th percentile of the host's wall time of one batch's update
calls (every group's ``MetricCollection.update``), over every batch of
the run's measured, untraced window."""

import math


def read(trace):
    values = sorted(trace.update_s)
    if not values:
        return None
    return values[max(0, math.ceil(0.99 * len(values)) - 1)] * 1e3
