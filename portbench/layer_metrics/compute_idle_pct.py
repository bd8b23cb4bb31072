"""Share of the spans stretch's window (``portbench/spans.py``) in which
the card was idle and the host's main thread was inside a program
compute span (a ``*.compute`` span or a ``compute.*`` stage), by
interval overlap."""

from portbench import spans


def read(trace):
    return spans.idle_pct(trace, "compute")
