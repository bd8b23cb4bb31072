"""Share of the spans stretch's window (``portbench/spans.py``) in which
the card was idle and the host's main thread was inside a member's
update span and in no ``check.*`` or ``readback.*`` span, by interval
overlap."""

from portbench import spans


def read(trace):
    return spans.idle_pct(trace, "update")
