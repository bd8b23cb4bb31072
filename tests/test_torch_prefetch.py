"""The port's Prefetcher (``torcheval_tpu_torch/engine/prefetch.py``):
ordering, bounded run-ahead, error relay and shutdown, mirroring
``tests/engine/test_prefetch.py`` case for case, plus the fault site and
the stall events of the JAX module."""

import threading
import time

import numpy as np
import pytest
import torch

from torcheval_tpu_torch.engine.prefetch import DEFAULT_DEPTH, Prefetcher
from torcheval_tpu_torch.resilience import FaultPlan, InjectedFault
from torcheval_tpu_torch.telemetry import events as port_events

from tests.test_torch_telemetry import reset_all


@pytest.fixture(autouse=True)
def _isolated():
    reset_all()
    yield
    reset_all()


def _identity(x):
    return x


@pytest.mark.parametrize(
    "stage, want",
    [(_identity, list(range(50))), (lambda x: x * 2, [x * 2 for x in range(50)])],
    ids=["order-and-completeness", "stage-applied-to-every-item"],
)
def test_order_and_stage(stage, want):
    assert list(Prefetcher(range(50), stage=stage)) == want


def test_default_stage_puts_arrays_on_the_device():
    got = list(Prefetcher([(np.ones(3), torch.zeros(2)), np.arange(4)], device="cpu"))
    assert len(got) == 2 and isinstance(got[0], tuple)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in (*got[0], got[1]))
    assert DEFAULT_DEPTH == 2


def test_bounded_run_ahead():
    # The producer may hold at most depth queued items plus one in
    # stage(); a slow consumer must apply backpressure.
    depth = 2
    staged = []
    lock = threading.Lock()

    def counting_stage(x):
        with lock:
            staged.append(x)
        return x

    pf = Prefetcher(range(30), stage=counting_stage, depth=depth)
    consumed = 0
    try:
        for _ in pf:
            consumed += 1
            time.sleep(0.005)
            with lock:
                ahead = len(staged) - consumed
            assert ahead <= depth + 1
    finally:
        pf.close()
    assert consumed == 30


def test_source_error_relayed_in_order():
    def source():
        yield 1
        yield 2
        raise ValueError("stream went bad")

    pf = Prefetcher(source(), stage=_identity)
    try:
        it = iter(pf)
        assert next(it) == 1 and next(it) == 2
        with pytest.raises(ValueError, match="stream went bad"):
            next(it)
        # Errored prefetchers are terminal and joined.
        with pytest.raises(StopIteration):
            next(it)
        assert not pf._thread.is_alive()
    finally:
        pf.close()


def test_stage_error_relayed_after_one_retry():
    calls = []

    def bad_stage(x):
        calls.append(x)
        if x == 3:
            raise RuntimeError("staging exploded")
        return x

    pf = Prefetcher(range(10), stage=bad_stage)
    got = []
    try:
        with pytest.raises(RuntimeError, match="staging exploded"):
            for item in pf:
                got.append(item)
    finally:
        pf.close()
    assert got == [0, 1, 2] and calls.count(3) == 2  # one bounded retry


def test_close_mid_stream_joins_producer():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = Prefetcher(endless(), stage=_identity, depth=2)
    it = iter(pf)
    assert next(it) == 0 and next(it) == 1
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    pf.close()  # idempotent


def test_exhaustion_joins_producer():
    pf = Prefetcher(range(5), stage=_identity)
    assert list(pf) == list(range(5))
    assert not pf._thread.is_alive()


def test_rejects_bad_depth():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(range(3), stage=_identity, depth=0)


def test_produce_fault_site_relays_the_fault():
    with FaultPlan([{"site": "prefetch.produce", "after": 2, "count": 1}]):
        pf = Prefetcher(range(10), stage=_identity)
        got = []
        try:
            with pytest.raises(InjectedFault):
                for item in pf:
                    got.append(item)
        finally:
            pf.close()
    assert got == [0, 1]


def test_stall_is_recorded_when_the_consumer_waits():
    port_events.enable()

    def slow():
        for i in range(3):
            time.sleep(0.02)
            yield i

    assert list(Prefetcher(slow(), stage=_identity)) == [0, 1, 2]
    stalls = port_events.events("prefetch_stall")
    assert stalls and all(e.seconds > 0 for e in stalls)
    assert port_events.aggregates()["spans"][("Evaluator", "prefetch_wait")]["calls"] == 4
