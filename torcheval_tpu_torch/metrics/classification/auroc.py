"""AUROC metrics — the port of
``torcheval_tpu/metrics/classification/auroc.py`` (parity with the
reference ``torcheval/metrics/classification/auroc.py``).

Sample-buffer states (``inputs``/``targets`` lists); merge concatenates;
``_prepare_for_merge_state`` pre-concatenates to one tensor per state for
the sync wire (reference ``auroc.py:89-92,130-134``).

``sketch=True`` (or ``TORCHEVAL_TPU_TORCH_RANK_SKETCH=1``) swaps the
buffers for the fixed-size mergeable rank sketch
(:mod:`torcheval_tpu_torch.metrics._rank_state`): one-pass updates
through ``binned_count.cu`` on the card, O(bins) merge payloads, AUROC
within 1/(bins-1)."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._buffer import (
    merge_concat_buffers,
    prepare_concat_buffers,
)
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics._rank_state import (
    _rank_binary_kernel,
    _rank_multiclass_kernel,
    install_rank_states,
    rank_accumulate,
    rank_merge_state,
    rank_sketch_state,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_compute,
    _binary_auroc_update_input_check,
    _multiclass_auroc_compute,
    _multiclass_auroc_param_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
    _binned_auroc_from_counts,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops._flags import rank_sketch_enabled
from torcheval_tpu_torch.ops.fused_auc import has_fused
from torcheval_tpu_torch.telemetry import events as _telemetry

def _concat(inputs, targets, dim: int):
    """The sample buffers, each concatenated along ``dim``."""
    return torch.cat(inputs, dim=dim), torch.cat(targets, dim=dim)


_MASK_NEEDS_SKETCH = (
    "mask= requires the rank-sketch state (sketch=True); the exact sample "
    "buffers do not fold masked updates."
)


class BinaryAUROC(Metric[torch.Tensor]):
    """Binary AUROC with multi-task support and the ``use_fused``
    approximate-kernel opt-in (the reference's ``use_fbgemm`` analog,
    reference ``auroc.py:27-48``).

    ``sketch=True`` (default: ``TORCHEVAL_TPU_TORCH_RANK_SKETCH``, else
    off) replaces the sample buffers with the mergeable rank-sketch counts
    over ``sketch_bins`` edges (default 512)."""

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        device=None,
        use_fused: Optional[bool] = False,
        sketch: Optional[bool] = None,
        sketch_bins: Optional[int] = None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self._sketch_mode = rank_sketch_enabled() if sketch is None else bool(sketch)
        if self._sketch_mode and use_fused:
            raise ValueError(
                "`use_fused` applies to the exact buffered compute; it cannot be "
                "combined with the rank-sketch state (sketch=True)."
            )
        if use_fused and not has_fused():
            raise ValueError(
                "`use_fused` requires the fused AUC kernel to be available."
            )
        self.num_tasks = num_tasks
        self.use_fused = use_fused
        if self._sketch_mode:
            install_rank_states(self, num_tasks, sketch_bins)
        else:
            self._add_state("inputs", [])
            self._add_state("targets", [])

    def update(self, input, target, *, mask=None) -> "BinaryAUROC":
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
        """AUROC per task; an empty tensor before any update."""
        if self._sketch_mode:
            if int(self.num_total.sum()) == 0:
                return torch.zeros(0, device=self.device)
            score = _binned_auroc_from_counts(
                self.num_tp, self.num_fp, self.num_pos, self.num_total
            )
            return score[0] if self.num_tasks == 1 else score
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        if _telemetry.ANNOTATE:
            with _telemetry.span("compute.concat"):
                inputs, targets = _concat(self.inputs, self.targets, -1)
        else:
            inputs, targets = _concat(self.inputs, self.targets, -1)
        return _binary_auroc_compute(inputs, targets, self.use_fused)

    def merge_state(self, metrics: Iterable["BinaryAUROC"]) -> "BinaryAUROC":
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
        """An O(bins) mergeable summary: ``"reservoir"`` (``capacity=``,
        error O(1/sqrt(capacity))), ``"histogram"`` (``bins=``, O(1/bins)),
        ``"count"`` (``width=`` / ``depth=``, a bin's count within
        n/sqrt(width)), ``"rank"`` (``bins=``, rank error <= 1/(bins-1), the
        native payload of a ``sketch=True`` metric), or the lossless
        ``"exact"`` (:mod:`torcheval_tpu_torch.metrics._sketch`)."""
        if self._sketch_mode:
            return rank_sketch_state(self, "binary_auroc", kind, **options)
        from torcheval_tpu_torch.metrics._sketch import sketch_from_buffers

        return sketch_from_buffers(self, "binary_auroc", kind, **options)


class MulticlassAUROC(Metric[torch.Tensor]):
    """One-vs-rest multiclass AUROC (reference ``auroc.py:93-229``).

    ``sketch=True`` (default: ``TORCHEVAL_TPU_TORCH_RANK_SKETCH``, else
    off) replaces the sample buffers with per-class rank-sketch counts;
    each class's score is then the binned trapezoid within 1/(bins-1)."""

    def __init__(
        self,
        *,
        num_classes: int,
        average: Optional[str] = "macro",
        device=None,
        sketch: Optional[bool] = None,
        sketch_bins: Optional[int] = None,
    ) -> None:
        super().__init__(device=device)
        _multiclass_auroc_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        self._sketch_mode = rank_sketch_enabled() if sketch is None else bool(sketch)
        if self._sketch_mode:
            install_rank_states(self, num_classes, sketch_bins)
        else:
            self._add_state("inputs", [])
            self._add_state("targets", [])

    def update(self, input, target, *, mask=None) -> "MulticlassAUROC":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multiclass_auroc_update_input_check(input, target, self.num_classes)
        if self._sketch_mode:
            input, target, mask = on_device(self.device, input, target, mask)
            rank_accumulate(
                self, _rank_multiclass_kernel, input, target,
                statics=(self.num_classes,), mask=mask,
            )
            return self
        if mask is not None:
            raise ValueError(_MASK_NEEDS_SKETCH)
        self.inputs.append(input.to(self.device))
        self.targets.append(target.to(self.device))
        return self

    def compute(self) -> torch.Tensor:
        """AUROC (macro scalar or per-class); an empty tensor before any
        update."""
        if self._sketch_mode:
            if int(self.num_total.sum()) == 0:
                return torch.zeros(0, device=self.device)
            score = _binned_auroc_from_counts(
                self.num_tp, self.num_fp, self.num_pos, self.num_total
            )
            return score.mean() if self.average == "macro" else score
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        if _telemetry.ANNOTATE:
            with _telemetry.span("compute.concat"):
                inputs, targets = _concat(self.inputs, self.targets, 0)
        else:
            inputs, targets = _concat(self.inputs, self.targets, 0)
        return _multiclass_auroc_compute(inputs, targets, self.num_classes, self.average)

    def merge_state(self, metrics: Iterable["MulticlassAUROC"]) -> "MulticlassAUROC":
        if self._sketch_mode:
            rank_merge_state(self, metrics)
            return self
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=0)
        return self

    def _prepare_for_merge_state(self) -> None:
        if self._sketch_mode:
            return
        prepare_concat_buffers(self, "inputs", "targets", dim=0)

    def sketch_state(self, kind: str = "exact", **options):
        """A mergeable summary: a ``sketch=True`` metric ships its
        O(classes x bins) rank counts (``"rank"``); buffer mode supports
        only the lossless ``"exact"`` (the compressed sample kinds are
        binary-only)."""
        if self._sketch_mode:
            return rank_sketch_state(self, "multiclass_auroc", kind, **options)
        return super().sketch_state(kind, **options)
