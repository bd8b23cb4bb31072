"""Share of the spans stretch's window (``portbench/spans.py``) in which
the card was idle and the host's main thread was in a ``check.*`` or
``readback.*`` span under a member's update, by interval overlap."""

from portbench import spans


def read(trace):
    return spans.idle_pct(trace, "check")
