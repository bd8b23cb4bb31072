"""Closed loop of whole passes over the configuration's evaluation set:
``reset()``, one ``update`` a batch, one ``compute()``."""

from __future__ import annotations

import time

from portbench.loops import Mark, Record, no_mark, split
from portbench.suite import Suite, to_host


class Loop:
    def __init__(self, config, traffic, suite_spec, data, device) -> None:
        self.suite = Suite(suite_spec["suite"], device)
        self.batches = split(data, int(config[traffic["batch"]]))
        self.n = sum(next(iter(b.values())).shape[0] for b in self.batches)

    @staticmethod
    def samples(config, traffic) -> int:
        return int(config["num_samples"])

    @staticmethod
    def positions(traffic, computes: int):
        """Every answer is a whole pass."""
        return [None]

    def warm(self) -> None:
        self.unit(Record(), no_mark)

    def unit(self, rec: Record, mark: Mark) -> None:
        self.suite.reset()
        for batch in self.batches:
            t0 = time.perf_counter()
            with mark("portbench.update"):
                self.suite.update(batch)
            rec.update_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with mark("portbench.compute"):
            values = to_host(self.suite.compute())
        rec.result_s.append(time.perf_counter() - t0)
        rec.answer(None, values)
        rec.samples += self.n
        rec.batches += len(self.batches)
        rec.computes += 1

    def free(self) -> None:
        del self.suite
