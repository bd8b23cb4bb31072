"""The port's read backs (device values brought to the host, counted by
the program at each site: ``_stats.readback``) over the batches of the
spans stretch (``portbench/spans.py``).

The run fails where a blocking runtime call inside a ``portbench.update``
range or a program compute span lies outside every ``readback.*`` span:
a read back the counter does not see.  Standard error names the
innermost program span around each."""

import sys

from portbench import spans


def value(st):
    return sum(st.readbacks.values()) / st.batches


def read(trace):
    st = spans.for_run(trace)
    if st is None or not st.batches:
        return None
    missed = spans.uncounted(st)
    if missed:
        for e, where in missed[:20]:
            print(f"portbench: uncounted read back: {e.name} in {where}", file=sys.stderr)
        raise RuntimeError(f"{len(missed)} blocking calls outside every readback.* span")
    return value(st)
