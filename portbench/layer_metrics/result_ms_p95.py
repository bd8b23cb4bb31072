"""The 95th percentile of the host's wall time from a ``compute()`` call
to every value of the suite on the host, over every compute of the
run's measured, untraced window."""

import math


def read(trace):
    values = sorted(trace.result_s)
    if not values:
        return None
    return values[max(0, math.ceil(0.95 * len(values)) - 1)] * 1e3
