"""The benchmark of ``torcheval_tpu_torch`` on an NVIDIA GPU.

Run one cell of ``BENCHMARK.json`` once, in a new process, from the root
of a checkout::

    python -m portbench --workload imagenet1k.eager --seed 7 --seconds 20 --trace 0

The harness is driven by data.  A cell names a configuration
(``configs/<config>.json``: the deployment's sizes and input generator)
and a traffic mix (``traffic/<mix>.json``: which loop drives the library
and its parameters); ``cells/<cell>.json`` holds the cell's metric suite
and the limits of its comparison with the plain reference; each per-layer
metric is a reader of its own (``layer_metrics/<metric>.py``).  The code
these name is found by name too: a loop in ``loops/<loop>.py``, an input
generator in ``inputs/<kind>.py``, the reference of a metric class in
``reference/members/<Class>.py``.  Adding a cell, a configuration, a mix,
a metric, a loop, a generator or a reference adds files and entries and
edits none.  Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
