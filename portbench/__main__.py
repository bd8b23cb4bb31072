"""``python -m portbench``: one run of one cell (see ``portbench/run.py``)."""

import time

STARTED = time.perf_counter()  # before torch loads: set-up counts from here

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], started=STARTED))
