"""Metric-class test harness (the port of
``torcheval_tpu/utils/test_utils/metric_class_tester.py``).

``run_class_implementation_tests`` checks, for one metric:

* its declared state names match the registry;
* a pickle round trip and hashability;
* a ``state_dict`` / ``load_state_dict`` round trip;
* sequential updates compute the expected result, and compute is
  idempotent;
* ``merge_state``: the updates are dealt to ``num_processes`` clones,
  merged and compared with the expected result, with the
  merge-before-update and merge-with-empty variants; the sources are
  unchanged by the merge, and the metric still updates after it;
* a merge across devices (``device`` and the CPU) when they differ;
* a real multi-rank sync: ``num_processes`` ranks of a
  :class:`~torcheval_tpu_torch.distributed.LocalWorld`, each updating its
  share, with ``sync_and_compute`` checked on rank 0 and with
  ``recipient_rank="all"``.

The metric under test lives on ``device`` (the CPU by default, so tests
run without a GPU); pass ``device="cuda"`` to run the same checks on the
card.
"""

import pickle
import unittest
from copy import deepcopy
from typing import Any, Dict, List, Sequence, Set

import numpy as np
import torch

from torcheval_tpu_torch.distributed import LocalWorld
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.toolkit import clone_metric, sync_and_compute

BATCH_SIZE = 16
# merge_state() is tested on 4 simulated ranks, each updating twice.
NUM_TOTAL_UPDATES = 8
NUM_PROCESSES = 4


class MetricClassTester(unittest.TestCase):
    def run_class_implementation_tests(
        self,
        metric: Metric,
        state_names: Set[str],
        update_kwargs: Dict[str, Any],
        compute_result: Any,
        merge_and_compute_result: Any = None,
        num_total_updates: int = NUM_TOTAL_UPDATES,
        num_processes: int = NUM_PROCESSES,
        test_merge_with_one_update: bool = True,
        atol: float = 1e-8,
        rtol: float = 1e-5,
        test_sync: bool = True,
        device: Any = "cpu",
    ) -> None:
        self.assertTrue(update_kwargs)
        self.assertTrue(state_names)
        self.assertTrue(
            all(len(v) == num_total_updates for v in update_kwargs.values()),
            "The outer size of each update argument should equal the number of updates",
        )
        self.assertGreater(num_total_updates, 1)
        self.assertGreater(num_processes, 1)
        self.assertEqual(num_total_updates % num_processes, 0)

        if merge_and_compute_result is None:
            merge_and_compute_result = compute_result

        self._metric = metric.to(device)
        self._device = torch.device(device)
        self._state_names = state_names
        self._update_kwargs = update_kwargs
        self._compute_result = compute_result
        self._merge_and_compute_result = merge_and_compute_result
        self._num_total_updates = num_total_updates
        self._num_processes = num_processes
        self._atol = atol
        self._rtol = rtol

        self._test_init()
        self._test_update_and_compute()
        self._test_merge_state(test_merge_with_one_update)
        if test_sync:
            self._test_sync_and_compute()

    # ------------------------------------------------------------- sub-tests
    def _test_metric_picklable_hashable(self, metric: Metric) -> None:
        loaded_metric = pickle.loads(pickle.dumps(metric))
        self.assertEqual(loaded_metric.device, metric.device)
        self.assert_state_unchanged(self._state_names, loaded_metric, metric)
        self.assertTrue(hash(metric))

    def _test_state_dict_load_state_dict(self, metric: Metric) -> None:
        test_metric = deepcopy(metric).reset()
        test_metric.load_state_dict(metric.state_dict())
        self.assert_state_unchanged(self._state_names, test_metric, metric)

    def _test_init(self) -> None:
        metric = self._metric
        self.assertEqual(set(metric._state_name_to_default.keys()), self._state_names)
        self._test_metric_picklable_hashable(metric)
        self._test_state_dict_load_state_dict(metric)

    def _update_args(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self._update_kwargs.items()}

    def _test_update_and_compute(self) -> None:
        result = None
        test_metric = deepcopy(self._metric)
        for i in range(self._num_total_updates):
            result = test_metric.update(**self._update_args(i)).compute()

        final_computation_result = test_metric.compute()
        assert_result_close(
            final_computation_result, self._compute_result, atol=self._atol, rtol=self._rtol
        )
        # compute is idempotent
        assert_result_close(final_computation_result, result)
        self._test_metric_picklable_hashable(test_metric)
        self._test_state_dict_load_state_dict(test_metric)

    def _test_merge_state(self, test_merge_with_one_update: bool) -> None:
        num_processes = self._num_processes
        test_metrics: List[Metric] = [deepcopy(self._metric) for _ in range(num_processes)]

        if test_merge_with_one_update:
            first_update_param = self._update_args(0)
            m0 = deepcopy(test_metrics[0])
            result_before_merge = m0.update(**first_update_param).compute()

            # merge (with a fresh metric) before update
            m0, m1 = deepcopy(test_metrics[0]), deepcopy(test_metrics[1])
            m0.merge_state([m1])
            assert_result_close(result_before_merge, m0.update(**first_update_param).compute())

            # update metric 0, then merge a fresh metric 1
            m0, m1 = deepcopy(test_metrics[0]), deepcopy(test_metrics[1])
            m0.update(**first_update_param)
            m0.merge_state([m1])
            assert_result_close(result_before_merge, m0.compute())

            # update metric 1, then fresh metric 0 merges it
            m0, m1 = deepcopy(test_metrics[0]), deepcopy(test_metrics[1])
            m1.update(**first_update_param)
            m0.merge_state([m1])
            assert_result_close(result_before_merge, m0.compute())

        # deal the updates to the simulated ranks, merge, compute
        per_rank = self._num_total_updates // num_processes
        for i in range(num_processes):
            for j in range(per_rank):
                test_metrics[i].update(**self._update_args(i * per_rank + j)).compute()
        test_metrics_unmerged = [deepcopy(m) for m in test_metrics]
        final_computation_result = test_metrics[0].merge_state(test_metrics[1:]).compute()
        assert_result_close(
            final_computation_result,
            self._merge_and_compute_result,
            atol=self._atol,
            rtol=self._rtol,
        )
        # the sources are unchanged by the merge
        for i in range(1, num_processes):
            self.assert_state_unchanged(
                self._state_names, test_metrics_unmerged[i], test_metrics[i]
            )
        # compute is idempotent after the merge
        assert_result_close(final_computation_result, test_metrics[0].compute())
        self._test_metric_picklable_hashable(test_metrics[0])
        self._test_state_dict_load_state_dict(test_metrics[0])

        # a merge across devices: ranks alternate between `device` and the CPU
        cpu = torch.device("cpu")
        if self._device != cpu:
            cross = [
                deepcopy(self._metric).to(self._device if i % 2 == 0 else cpu)
                for i in range(num_processes)
            ]
            for i in range(num_processes):
                for j in range(per_rank):
                    cross[i].update(**self._update_args(i * per_rank + j))
            assert_result_close(
                cross[0].merge_state(cross[1:]).compute(),
                self._merge_and_compute_result,
                atol=self._atol,
                rtol=self._rtol,
            )

        # the metric still updates after a merge
        test_metrics[0].update(**self._update_args(0)).compute()

    def _test_sync_and_compute(self) -> None:
        """Multi-rank sync over a LocalWorld, for ``recipient_rank`` 0 and
        ``"all"``."""
        spec_metric = self._metric
        per_rank = self._num_total_updates // self._num_processes
        for recipient_rank in (0, "all"):
            world = LocalWorld(self._num_processes)

            def rank_fn(group, rank):
                metric = clone_metric(spec_metric)
                for i in range(per_rank):
                    metric.update(**self._update_args(rank * per_rank + i)).compute()
                return sync_and_compute(metric, process_group=group, recipient_rank=recipient_rank)

            results = world.run(rank_fn)
            recipients = range(self._num_processes) if recipient_rank == "all" else [0]
            for r in range(self._num_processes):
                if r in recipients:
                    assert_result_close(
                        results[r],
                        self._merge_and_compute_result,
                        atol=self._atol,
                        rtol=self._rtol,
                    )
                else:
                    self.assertIsNone(results[r])

    def assert_state_unchanged(
        self, state_names: Set[str], metric1: Metric, metric2: Metric
    ) -> None:
        for state in state_names:
            assert_result_close(getattr(metric1, state), getattr(metric2, state))


def _as_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_result_close(
    result: Any,
    expected_result: Any,
    atol: float = 1e-8,
    rtol: float = 1e-5,
) -> None:
    """Recursive comparator over tensors / arrays / numbers, sequences and
    dicts."""
    tc = unittest.TestCase()
    numeric = (torch.Tensor, np.ndarray, np.generic, float, int)
    if isinstance(result, numeric) and isinstance(expected_result, numeric):
        np.testing.assert_allclose(
            _as_numpy(result), _as_numpy(expected_result), atol=atol, rtol=rtol, equal_nan=True
        )
    elif isinstance(result, dict):
        tc.assertTrue(isinstance(expected_result, dict))
        tc.assertEqual(set(result.keys()), set(expected_result.keys()))
        for k in result:
            assert_result_close(result[k], expected_result[k], atol, rtol)
    elif isinstance(result, Sequence):
        tc.assertTrue(isinstance(expected_result, Sequence))
        tc.assertEqual(len(result), len(expected_result))
        for element, expected_element in zip(result, expected_result):
            assert_result_close(element, expected_element, atol, rtol)
    else:
        raise ValueError(f"Compute result comparison is not supported for {type(result)}.")
