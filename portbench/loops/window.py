"""A training job's monitor: a stream of batches cycled in order from a
pool, one ``update`` a batch, a ``compute()`` every ``compute_every``
batches, the windows never reset.  Set-up fills the windows with
``prefill_updates`` batches, computing on the same cadence."""

from __future__ import annotations

import time

from portbench.loops import Mark, Record, no_mark, split
from portbench.suite import Suite, to_host


class Loop:
    def __init__(self, config, traffic, suite_spec, data, device) -> None:
        self.suite = Suite(suite_spec["suite"], device)
        self.pool = split(data, int(config[traffic["batch"]]))
        self.every = int(traffic["compute_every"])
        self.prefill = int(traffic["prefill_updates"])
        self.updates = 0

    @staticmethod
    def samples(config, traffic) -> int:
        return int(traffic["pool_batches"]) * int(config[traffic["batch"]])

    @staticmethod
    def positions(traffic, computes: int):
        """The positions of the first ``computes`` answers after set-up."""
        every = int(traffic["compute_every"])
        first = -(-int(traffic["prefill_updates"]) // every) * every + every
        return [first + k * every for k in range(computes)]

    def warm(self) -> None:
        rec = Record()
        while self.updates < self.prefill:
            self.unit(rec, no_mark)

    def unit(self, rec: Record, mark: Mark) -> None:
        samples = 0
        for _ in range(self.every):
            batch = self.pool[self.updates % len(self.pool)]
            t0 = time.perf_counter()
            with mark("portbench.update"):
                self.suite.update(batch)
            rec.update_s.append(time.perf_counter() - t0)
            self.updates += 1
            samples += next(iter(batch.values())).shape[0]
        t0 = time.perf_counter()
        with mark("portbench.compute"):
            values = to_host(self.suite.compute())
        rec.result_s.append(time.perf_counter() - t0)
        rec.answer(self.updates, values)
        rec.samples += samples
        rec.batches += self.every
        rec.computes += 1

    def free(self) -> None:
        del self.suite, self.pool
