"""Binned AUROC / AUPRC metrics — the port of
``torcheval_tpu/metrics/classification/binned_auc.py``: fixed-threshold
counter states.

Unlike the exact AUROC/AUPRC classes (unbounded sample buffers, concat
merge), these keep O(rows × thresholds) int32 count states: add-mergeable
and constant in memory over the stream.  Every class shares one state
machine (``_BinnedCountsBase``); the binary/multiclass/multilabel input
flavors each specialize it once, and the AUROC/AUPRC twins differ only in
their ``_score_fn``.  Every update takes ``mask=`` and folds it exactly
(masked samples add nothing)."""

from typing import Iterable, List, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
    _binned_auc_average_param_check,
    _binned_auprc_from_counts,
    _binned_auroc_from_counts,
    _binned_counts_rows,
    _binned_curves_from_counts,
    _multiclass_binned_auc_validate,
    _multiclass_binned_counts_kernel,
    _multilabel_binned_counts_kernel,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    Threshold,
    _binned_precision_recall_curve_param_check,
    _create_threshold_tensor,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric

_COUNTS = ("num_tp", "num_fp", "num_pos", "num_total")


def _binary_binned_counts_kernel(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor, mask=None
):
    if input.dim() == 1:
        input, target = input[None], target[None]
    return _binned_counts_rows(input, target == 1, threshold, mask=mask)


class _BinnedCountsBase(Metric):
    """Shared state machine: ``threshold`` + the four add-mergeable int32
    count arrays over (rows, thresholds).  ``_score_fn`` (set per concrete
    class) maps the counts to the per-row AUROC/AUPRC scores."""

    # Every concrete update() below takes mask=, folded exactly.
    _supports_mask = True
    _score_fn = None

    def __init__(self, num_rows: int, threshold, device=None) -> None:
        super().__init__(device=device)
        threshold = _create_threshold_tensor(threshold, self.device)
        _binned_precision_recall_curve_param_check(threshold)
        self._add_state("threshold", threshold)
        num_t = threshold.shape[0]
        self._add_state("num_tp", torch.zeros((num_rows, num_t), dtype=torch.int32))
        self._add_state("num_fp", torch.zeros((num_rows, num_t), dtype=torch.int32))
        self._add_state("num_pos", torch.zeros(num_rows, dtype=torch.int32))
        self._add_state("num_total", torch.zeros(num_rows, dtype=torch.int32))

    def _accumulate(self, kernel, input, target, statics=(), mask=None) -> None:
        self.num_tp, self.num_fp, self.num_pos, self.num_total = accumulate(
            kernel,
            (self.num_tp, self.num_fp, self.num_pos, self.num_total),
            input,
            target,
            self.threshold,
            statics=statics,
            mask=mask,
        )

    def _row_scores(self) -> torch.Tensor:
        return type(self)._score_fn(
            self.num_tp, self.num_fp, self.num_pos, self.num_total
        )

    def merge_state(self, metrics: Iterable["_BinnedCountsBase"]):
        merge_add(self, metrics, *_COUNTS)
        return self


class _BinaryBinnedAUC(_BinnedCountsBase):
    """Binary flavor: rows = tasks; compute returns ``(score, thresholds)``
    with the scalar squeezed for ``num_tasks == 1``."""

    def __init__(self, num_tasks: int, threshold, device=None) -> None:
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        super().__init__(num_tasks, threshold, device)

    def update(self, input, target, *, mask=None):
        input, target, mask = on_device(self.device, input, target, mask)
        _binary_auroc_update_input_check(input, target, self.num_tasks)
        self._accumulate(_binary_binned_counts_kernel, input, target, mask=mask)
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        score = self._row_scores()
        return (score[0] if self.num_tasks == 1 else score), self.threshold


class _MulticlassBinnedAUC(_BinnedCountsBase):
    """Multiclass flavor: rows = one-vs-rest classes, macro/None average."""

    def __init__(
        self, num_classes: int, average: Optional[str], threshold, device=None
    ) -> None:
        _binned_auc_average_param_check(num_classes, average, "num_classes")
        self.num_classes = num_classes
        self.average = average
        super().__init__(num_classes, threshold, device)

    def update(self, input, target, *, mask=None):
        input, target, mask = on_device(self.device, input, target, mask)
        _multiclass_binned_auc_validate(input, target, self.num_classes)
        self._accumulate(
            _multiclass_binned_counts_kernel,
            input,
            target,
            statics=(self.num_classes,),
            mask=mask,
        )
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        score = self._row_scores()
        return (score.mean() if self.average == "macro" else score), self.threshold


class _MultilabelBinned(_BinnedCountsBase):
    """Multilabel flavor: rows = label columns of a 0/1 target matrix."""

    def __init__(self, num_labels: int, threshold, device=None) -> None:
        if num_labels < 2:
            raise ValueError("`num_labels` has to be at least 2.")
        self.num_labels = num_labels
        super().__init__(num_labels, threshold, device)

    def update(self, input, target, *, mask=None):
        input, target, mask = on_device(self.device, input, target, mask)
        _multilabel_precision_recall_curve_update_input_check(
            input, target, self.num_labels
        )
        self._accumulate(_multilabel_binned_counts_kernel, input, target, mask=mask)
        return self


class BinaryBinnedAUROC(_BinaryBinnedAUC):
    """Binned AUROC with multi-task support; compute returns
    ``(auroc, thresholds)``."""

    _score_fn = staticmethod(_binned_auroc_from_counts)

    def __init__(
        self, *, num_tasks: int = 1, threshold: Threshold = 200, device=None
    ) -> None:
        super().__init__(num_tasks, threshold, device)


class BinaryBinnedAUPRC(_BinaryBinnedAUC):
    """Binned average precision with multi-task support; compute returns
    ``(auprc, thresholds)``."""

    _score_fn = staticmethod(_binned_auprc_from_counts)

    def __init__(
        self, *, num_tasks: int = 1, threshold: Threshold = 100, device=None
    ) -> None:
        super().__init__(num_tasks, threshold, device)


class MulticlassBinnedAUROC(_MulticlassBinnedAUC):
    """One-vs-rest binned AUROC with macro/None averaging."""

    _score_fn = staticmethod(_binned_auroc_from_counts)

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        threshold: Threshold = 200,
        device=None,
    ) -> None:
        super().__init__(num_classes, average, threshold, device)


class MulticlassBinnedAUPRC(_MulticlassBinnedAUC):
    """One-vs-rest binned average precision with macro/None averaging."""

    _score_fn = staticmethod(_binned_auprc_from_counts)

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        threshold: Threshold = 100,
        device=None,
    ) -> None:
        super().__init__(num_classes, average, threshold, device)


class MultilabelBinnedAUPRC(_MultilabelBinned):
    """Per-label binned average precision with macro/None averaging."""

    _score_fn = staticmethod(_binned_auprc_from_counts)

    def __init__(
        self,
        *,
        num_labels: int,
        average: Optional[str] = "macro",
        threshold: Threshold = 100,
        device=None,
    ) -> None:
        # num_labels itself is validated once, by _MultilabelBinned.
        _binned_auc_average_param_check(None, average, "num_labels")
        self.average = average
        super().__init__(num_labels, threshold, device)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        score = self._row_scores()
        return (score.mean() if self.average == "macro" else score), self.threshold


class MultilabelBinnedPrecisionRecallCurve(_MultilabelBinned):
    """Per-label binned PR curves; compute returns
    ``(precisions, recalls, thresholds)`` with per-label lists."""

    def __init__(
        self, *, num_labels: int, threshold: Threshold = 100, device=None
    ) -> None:
        super().__init__(num_labels, threshold, device)

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        return _binned_curves_from_counts(
            self.num_tp, self.num_fp, self.num_pos, self.threshold
        )
