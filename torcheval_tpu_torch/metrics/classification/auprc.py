"""AUPRC metrics — the port of
``torcheval_tpu/metrics/classification/auprc.py``.

Average precision over buffered samples, the same buffer-state design as
the AUROC classes: ``inputs``/``targets`` lists, concat merge, pre-concat
for the sync wire.  ``BinaryAUPRC(sketch=True)`` keeps the rank-sketch
counts instead (:mod:`torcheval_tpu_torch.metrics._rank_state`)."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._buffer import (
    merge_concat_buffers,
    prepare_concat_buffers,
)
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics._rank_state import (
    _rank_binary_kernel,
    install_rank_states,
    rank_accumulate,
    rank_merge_state,
    rank_sketch_state,
)
from torcheval_tpu_torch.metrics.classification.auroc import _MASK_NEEDS_SKETCH
from torcheval_tpu_torch.metrics.functional.classification.auprc import (
    _binary_auprc_compute,
    _multiclass_auprc_compute,
    _multiclass_auprc_param_check,
    _multilabel_auprc_compute,
    _multilabel_auprc_param_check,
    _multilabel_auprc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
    _binned_auprc_from_counts,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops._flags import rank_sketch_enabled


def _empty_average(average: Optional[str], rows: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((), device=device) if average == "macro" else torch.zeros(rows, device=device)


class BinaryAUPRC(Metric[torch.Tensor]):
    """Binary average precision with multi-task support (buffered, exact).

    ``sketch=True`` (default: ``TORCHEVAL_TPU_TORCH_RANK_SKETCH``, else
    off) replaces the sample buffers with the mergeable rank-sketch counts
    over ``sketch_bins`` edges (default 512)."""

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        device=None,
        sketch: Optional[bool] = None,
        sketch_bins: Optional[int] = None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        self._sketch_mode = rank_sketch_enabled() if sketch is None else bool(sketch)
        if self._sketch_mode:
            install_rank_states(self, num_tasks, sketch_bins)
        else:
            self._add_state("inputs", [])
            self._add_state("targets", [])

    def update(self, input, target, *, mask=None) -> "BinaryAUPRC":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _binary_auroc_update_input_check(input, target, self.num_tasks)
        if self._sketch_mode:
            input, target, mask = on_device(self.device, input, target, mask)
            rank_accumulate(self, _rank_binary_kernel, input, target, mask=mask)
            return self
        if mask is not None:
            raise ValueError(_MASK_NEEDS_SKETCH)
        self.inputs.append(input.to(self.device))
        self.targets.append(target.to(self.device))
        return self

    def compute(self) -> torch.Tensor:
        """Average precision per task; an empty tensor before any update."""
        if self._sketch_mode:
            if int(self.num_total.sum()) == 0:
                return torch.zeros(0, device=self.device)
            score = _binned_auprc_from_counts(
                self.num_tp, self.num_fp, self.num_pos, self.num_total
            )
            return score[0] if self.num_tasks == 1 else score
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        input = torch.cat(self.inputs, dim=-1)
        if input.shape[-1] == 0:  # only zero-length updates buffered
            return torch.zeros(input.shape[:-1], device=self.device)
        return _binary_auprc_compute(input, torch.cat(self.targets, dim=-1))

    def merge_state(self, metrics: Iterable["BinaryAUPRC"]) -> "BinaryAUPRC":
        if self._sketch_mode:
            rank_merge_state(self, metrics)
            return self
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=-1)
        return self

    def _prepare_for_merge_state(self) -> None:
        if self._sketch_mode:
            return  # the counts are flat tensors on the sync wire already
        prepare_concat_buffers(self, "inputs", "targets", dim=-1)

    def sketch_state(self, kind: str = "exact", **options):
        """An O(bins) mergeable summary of the sample buffers, the kinds and
        bounds of :meth:`BinaryAUROC.sketch_state`."""
        if self._sketch_mode:
            return rank_sketch_state(self, "binary_auprc", kind, **options)
        from torcheval_tpu_torch.metrics._sketch import sketch_from_buffers

        return sketch_from_buffers(self, "binary_auprc", kind, **options)


class MulticlassAUPRC(Metric[torch.Tensor]):
    """One-vs-rest average precision with macro/None averaging."""

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        device=None,
    ) -> None:
        super().__init__(device=device)
        _multiclass_auprc_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        self._add_state("inputs", [])
        self._add_state("targets", [])

    def update(self, input, target) -> "MulticlassAUPRC":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multiclass_auroc_update_input_check(input, target, self.num_classes)
        self.inputs.append(input.to(self.device))
        self.targets.append(target.to(self.device))
        return self

    def compute(self) -> torch.Tensor:
        """Macro or per-class average precision; an empty tensor before any
        update."""
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        input = torch.cat(self.inputs, dim=0)
        if input.shape[0] == 0:  # only zero-length updates buffered
            return _empty_average(self.average, self.num_classes, self.device)
        return _multiclass_auprc_compute(
            input, torch.cat(self.targets, dim=0), self.num_classes, self.average
        )

    def merge_state(self, metrics: Iterable["MulticlassAUPRC"]) -> "MulticlassAUPRC":
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=0)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "inputs", "targets", dim=0)


class MultilabelAUPRC(Metric[torch.Tensor]):
    """Per-label average precision over a 0/1 label matrix, macro/None
    averaging."""

    def __init__(
        self,
        *,
        num_labels: int,
        average: Optional[str] = "macro",
        device=None,
    ) -> None:
        super().__init__(device=device)
        _multilabel_auprc_param_check(num_labels, average)
        self.num_labels = num_labels
        self.average = average
        self._add_state("inputs", [])
        self._add_state("targets", [])

    def update(self, input, target) -> "MultilabelAUPRC":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multilabel_auprc_update_input_check(input, target, self.num_labels)
        self.inputs.append(input.to(self.device))
        self.targets.append(target.to(self.device))
        return self

    def compute(self) -> torch.Tensor:
        """Macro or per-label average precision; an empty tensor before any
        update."""
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        input = torch.cat(self.inputs, dim=0)
        if input.shape[0] == 0:  # only zero-length updates buffered
            return _empty_average(self.average, self.num_labels, self.device)
        return _multilabel_auprc_compute(
            input, torch.cat(self.targets, dim=0), self.average
        )

    def merge_state(self, metrics: Iterable["MultilabelAUPRC"]) -> "MultilabelAUPRC":
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=0)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "inputs", "targets", dim=0)
