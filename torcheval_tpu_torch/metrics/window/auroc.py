"""WindowedBinaryAUROC (the port of
``torcheval_tpu/metrics/window/auroc.py``; parity with the reference
``torcheval/metrics/window/auroc.py``).

AUROC over the last ``max_num_samples`` samples.  State is a
pre-allocated ``(num_tasks, max_num_samples)`` ring buffer pair; the ring
bookkeeping is host ints, shared with the other windowed metrics through
:class:`~torcheval_tpu_torch.metrics._buffer.RingWindowMixin`.

* Insertion: a batch of ``n < W`` columns is written in place at the ring
  cursor as one slice copy, or two where it wraps past the end, so each
  column is written once (the JAX package scatters to
  ``(start + arange(n)) % W``; the layout is the same).  A batch of
  ``n >= W`` keeps its last ``W`` samples and resets the cursor.
* The valid-prefix length is tracked explicitly (``_num_valid``) instead
  of the reference's zero-suffix guess (``window/auroc.py:158-164``).
* Merge concatenates the valid samples of each window and **grows**
  ``max_num_samples`` to the summed window size (reference
  ``window/auroc.py:166-207``).  AUROC is order-invariant, so copying the
  (possibly rotated) valid region without unrotating it is exact.
* Compute is the exact binary AUROC of
  :mod:`~torcheval_tpu_torch.metrics.functional.classification.auroc`:
  the rank-sum kernel when one side of every row is rare, else a sort and
  the AUC-scan kernel.
"""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._buffer import RingWindowMixin
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_compute,
    _binary_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric


def _ring_insert(buf: torch.Tensor, batch: torch.Tensor, start: int) -> None:
    """Write ``batch`` (``n < W`` columns) into ``buf`` at ring position
    ``start``, in place: the columns up to the end of the ring, then the
    rest from its front."""
    w, n = buf.shape[1], batch.shape[1]
    head = min(n, w - start)
    buf[:, start : start + head] = batch[:, :head]
    if head < n:
        buf[:, : n - head] = batch[:, head:]


class WindowedBinaryAUROC(RingWindowMixin, Metric[torch.Tensor]):
    """The windowed version of BinaryAUROC: computed from the input and
    target of the last ``max_num_samples`` samples
    (reference ``window/auroc.py:23-54``)."""

    _window_states = ("inputs", "targets")
    _window_counters = ("total_samples",)

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        max_num_samples: int = 100,
        device=None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        if max_num_samples < 1:
            raise ValueError(
                "`max_num_samples` value should be greater than and equal to 1, "
                f"but received {max_num_samples}. "
            )
        self.num_tasks = num_tasks
        self._init_window(max_num_samples)
        self.total_samples = 0
        self._add_state("inputs", torch.zeros((num_tasks, max_num_samples)))
        self._add_state("targets", torch.zeros((num_tasks, max_num_samples)))

    @property
    def max_num_samples(self) -> int:
        """Window capacity (grows on merge, reference attribute name)."""
        return self._window_capacity

    def update(self, input, target) -> "WindowedBinaryAUROC":
        """Insert a batch of predictions/labels into the ring buffer
        (reference ``window/auroc.py:85-144``)."""
        input, target = on_device(self.device, input, target)
        _binary_auroc_update_input_check(input, target, self.num_tasks)
        if input.dim() == 1:
            input = input.reshape(1, -1)
            target = target.reshape(1, -1)
        n = input.shape[1]
        w = self.max_num_samples
        if n >= w:
            # Oversized batch: the window is exactly its last w samples.
            self.inputs.copy_(input[:, -w:])
            self.targets.copy_(target[:, -w:])
            self.next_inserted = 0
            self._num_valid = w
        else:
            _ring_insert(self.inputs, input, self.next_inserted)
            _ring_insert(self.targets, target, self.next_inserted)
            self._window_advance(n)
        self.total_samples += n
        return self

    def compute(self) -> torch.Tensor:
        """AUROC of the current window; an empty tensor before any update
        (reference ``window/auroc.py:146-164``)."""
        if self._num_valid == 0:
            return torch.zeros(0, device=self.device)
        inputs = self.inputs[:, : self._num_valid]
        targets = self.targets[:, : self._num_valid]
        if self.num_tasks == 1:
            inputs, targets = inputs[0], targets[0]
        return _binary_auroc_compute(inputs, targets)

    def merge_state(
        self, metrics: Iterable["WindowedBinaryAUROC"]
    ) -> "WindowedBinaryAUROC":
        """Concatenate each window's valid samples into an enlarged window
        whose size is the sum of all window sizes
        (reference ``window/auroc.py:166-207``)."""
        metrics = list(metrics)
        self._window_merge(metrics)
        for m in metrics:
            self.total_samples += m.total_samples
        return self

    def reset(self) -> "WindowedBinaryAUROC":
        """Reset states AND the host ring bookkeeping, including the window
        size a previous merge may have grown (divergence: the reference
        base-class reset leaves all of these stale)."""
        super().reset()
        self._window_reset()
        self.total_samples = 0
        return self
