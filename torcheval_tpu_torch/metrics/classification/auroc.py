"""AUROC metrics — the port of
``torcheval_tpu/metrics/classification/auroc.py`` in buffer mode (parity
with the reference ``torcheval/metrics/classification/auroc.py``).

Sample-buffer states (``inputs``/``targets`` lists); merge concatenates;
``_prepare_for_merge_state`` pre-concatenates to one tensor per state for
the sync wire (reference ``auroc.py:89-92,130-134``).  The rank-sketch
state (``sketch=True``) comes with the sketch tier in a later slice of
the port."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._buffer import (
    merge_concat_buffers,
    prepare_concat_buffers,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_compute,
    _binary_auroc_update_input_check,
    _multiclass_auroc_compute,
    _multiclass_auroc_param_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops.fused_auc import has_fused


def _no_sketch(sketch: Optional[bool]) -> None:
    if sketch:
        raise NotImplementedError(
            "sketch=True (the rank-sketch state) is not ported yet: it comes "
            "with the sketch-tier slice of torcheval_tpu_torch "
            "(metrics/_rank_state.py, ops/rank_sketch.py). Use the exact "
            "sample buffers (sketch=False)."
        )


class BinaryAUROC(Metric[torch.Tensor]):
    """Binary AUROC with multi-task support and the ``use_fused``
    approximate-kernel opt-in (the reference's ``use_fbgemm`` analog,
    reference ``auroc.py:27-48``)."""

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        device=None,
        use_fused: Optional[bool] = False,
        sketch: Optional[bool] = None,
    ) -> None:
        _no_sketch(sketch)
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        if use_fused and not has_fused():
            raise ValueError(
                "`use_fused` requires the fused AUC kernel to be available."
            )
        self.num_tasks = num_tasks
        self.use_fused = use_fused
        self._add_state("inputs", [])
        self._add_state("targets", [])

    def update(self, input, target) -> "BinaryAUROC":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _binary_auroc_update_input_check(input, target, self.num_tasks)
        self.inputs.append(input.to(self.device))
        self.targets.append(target.to(self.device))
        return self

    def compute(self) -> torch.Tensor:
        """AUROC per task; an empty tensor before any update."""
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        return _binary_auroc_compute(
            torch.cat(self.inputs, dim=-1),
            torch.cat(self.targets, dim=-1),
            self.use_fused,
        )

    def merge_state(self, metrics: Iterable["BinaryAUROC"]) -> "BinaryAUROC":
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=-1)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "inputs", "targets", dim=-1)


class MulticlassAUROC(Metric[torch.Tensor]):
    """One-vs-rest multiclass AUROC (reference ``auroc.py:93-229``)."""

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        device=None,
        sketch: Optional[bool] = None,
    ) -> None:
        _no_sketch(sketch)
        super().__init__(device=device)
        _multiclass_auroc_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        self._add_state("inputs", [])
        self._add_state("targets", [])

    def update(self, input, target) -> "MulticlassAUROC":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multiclass_auroc_update_input_check(input, target, self.num_classes)
        self.inputs.append(input.to(self.device))
        self.targets.append(target.to(self.device))
        return self

    def compute(self) -> torch.Tensor:
        """AUROC (macro scalar or per-class); an empty tensor before any
        update."""
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        return _multiclass_auroc_compute(
            torch.cat(self.inputs, dim=0),
            torch.cat(self.targets, dim=0),
            self.num_classes,
            self.average,
        )

    def merge_state(self, metrics: Iterable["MulticlassAUROC"]) -> "MulticlassAUROC":
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=0)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "inputs", "targets", dim=0)
