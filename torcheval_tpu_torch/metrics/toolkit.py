"""Distributed sync toolkit (the port of ``torcheval_tpu/metrics/toolkit.py``,
flat topology): ``sync_and_compute``, ``get_synced_state_dict``,
``get_synced_metric``, ``clone_metric(s)``, ``reset_metrics`` and
``to_device``, with the reference's semantics.

Every rank's metric is pickled through a
:class:`~torcheval_tpu_torch.distributed.CollectiveGroup` (its states
travel through the CPU and come back on the metric's own device) and
merged into a clone of rank 0's in rank order.  ``recipient_rank=i`` is a
true gather: the other ranks enter the collective and return ``None``
without holding their peers' states; ``recipient_rank="all"`` all-gathers,
and every rank merges the same list into the same result.

The single-metric entry points also take a
:class:`~torcheval_tpu_torch.metrics.MetricCollection`, which gathers and
merges as one object (``sync_and_compute`` returns its result dict).  The
iterable entry points (``reset_metrics``, ``to_device``,
``clone_metrics``) take iterables of metrics: a collection iterates its
member names, so call its own ``reset()`` / ``to()`` instead.

``sketch=`` (``"reservoir"`` / ``"histogram"`` / ``"count"``, or
``"rank"`` for a ``sketch=True`` curve metric) ships each rank's O(bins)
sketch (``metrics/_sketch.py``) through the same flat collective instead
of its states; the recipient merges them in rank order and returns the
merged sketch's value.

``topology="tree"`` / ``"ring"`` run the elastic hierarchical merge
(:func:`torcheval_tpu_torch.parallel.fleet_merge.fleet_merge`) and return
a :class:`~torcheval_tpu_torch.parallel.fleet_merge.MergeOutcome` on every
rank.  A group with no point-to-point channel and more than one rank warns
and takes the flat path, as the JAX package does.
"""

from __future__ import annotations

import logging
import warnings
from copy import deepcopy
from typing import Any, Dict, Iterable, List, Literal, Optional, TypeVar, Union

from torcheval_tpu_torch.distributed import CollectiveGroup, default_group
from torcheval_tpu_torch.metrics.metric import Metric, canonicalize_device

log: logging.Logger = logging.getLogger(__name__)

_TMetrics = TypeVar("_TMetrics", bound=Iterable[Metric])


def sync_and_compute(
    metric: Metric,
    process_group: Optional[CollectiveGroup] = None,
    recipient_rank: Union[int, Literal["all"]] = 0,
    *,
    topology: Literal["flat", "tree", "ring"] = "flat",
    sketch: Optional[str] = None,
    sketch_options: Optional[Dict[str, Any]] = None,
    merge_policy: Optional[Any] = None,
    membership: Optional[Any] = None,
) -> Optional[Any]:
    """Sync metric states and return ``compute()`` of the synced metric on
    the recipient rank(s); ``None`` on the others.  With ``sketch=`` (a
    kind of ``metric.sketch_state``, options in ``sketch_options``), each
    rank ships its sketch instead and the recipient returns the merged
    sketch's ``compute()``.

    ``topology="tree"`` / ``"ring"`` run the fleet merge instead (rooted
    at ``recipient_rank``, at rank 0 for ``"all"``, with ``merge_policy``
    and ``membership``) and return its ``MergeOutcome`` on every rank:
    ``outcome.value`` on the recipient(s), ``outcome.partial`` /
    ``world_effective`` / ``lost_ranks`` for lost ranks.  On a clean run
    the value is bit-identical to the flat one."""
    if topology not in ("flat", "tree", "ring"):
        raise ValueError(f"topology must be 'flat', 'tree' or 'ring', got {topology!r}")
    group = process_group if process_group is not None else default_group()
    if topology != "flat":
        if group.world_size > 1 and not group.supports_p2p:
            warnings.warn(
                f"collective group {type(group).__name__} has no "
                "point-to-point transport; falling back to topology='flat'",
                RuntimeWarning,
                stacklevel=2,
            )
        else:
            from torcheval_tpu_torch.parallel.fleet_merge import fleet_merge

            return fleet_merge(
                metric,
                group,
                topology=topology,
                sketch=sketch,
                sketch_options=sketch_options,
                dst=0 if recipient_rank == "all" else recipient_rank,
                recipient=recipient_rank,
                policy=merge_policy,
                membership=membership,
            )
    if sketch is not None and sketch != "exact":
        return _flat_sketch_compute(metric, group, recipient_rank, sketch, sketch_options)
    synced_metric = get_synced_metric(metric, group, recipient_rank)
    return synced_metric.compute() if synced_metric is not None else None


def _flat_sketch_compute(
    metric: Metric,
    group: CollectiveGroup,
    recipient_rank: Union[int, Literal["all"]],
    kind: str,
    sketch_options: Optional[Dict[str, Any]],
) -> Optional[Any]:
    """The flat sketch sync: every rank builds its O(bins) sketch (a
    reservoir salted with the rank, so the ranks' key streams differ),
    the sketches ride the object collective, and the recipient merges
    them in rank order and computes."""
    if not (isinstance(recipient_rank, int) or recipient_rank == "all"):
        raise ValueError(
            "recipient_rank accepts a rank index or the string 'all'; "
            f"got {recipient_rank!r}."
        )
    world_size = group.world_size
    opts = dict(sketch_options or {})
    if kind == "reservoir":
        opts.setdefault("salt", group.rank if world_size > 1 else 0)
    local = metric.sketch_state(kind, **opts)
    if world_size == 1:
        return local.compute()
    if world_size == -1:
        log.warning(
            "collective group reports world size -1 (this process appears to be "
            "outside the group); sync_and_compute() yields None."
        )
        return None
    if recipient_rank == "all":
        gathered = group.all_gather_object(local)
    else:
        gathered = group.gather_object(local, dst=recipient_rank)
    if gathered is None:
        return None
    base = gathered[0]
    for other in gathered[1:]:
        base.merge(other)
    return base.compute()


def get_synced_state_dict(
    metric: Metric,
    process_group: Optional[CollectiveGroup] = None,
    recipient_rank: Union[int, Literal["all"]] = 0,
) -> Dict[str, Any]:
    """State dict of the synced metric on the recipient rank(s); ``{}`` on
    the others."""
    synced_metric = get_synced_metric(metric, process_group, recipient_rank)
    return synced_metric.state_dict() if synced_metric is not None else {}


def clone_metric(metric: Metric) -> Metric:
    """A new metric with its own copy of every state."""
    return deepcopy(metric)


def clone_metrics(metrics: _TMetrics) -> List[Metric]:
    """:func:`clone_metric` of each metric."""
    return [clone_metric(metric) for metric in metrics]


def get_synced_metric(
    metric: Metric,
    process_group: Optional[CollectiveGroup] = None,
    recipient_rank: Union[int, Literal["all"]] = 0,
) -> Optional[Metric]:
    """Gather every rank's metric, merge them in rank order into a clone of
    rank 0's on ``metric``'s device, and return it on the recipient
    rank(s); ``None`` on the others.  The caller's metric is unchanged."""
    if not (isinstance(recipient_rank, int) or recipient_rank == "all"):
        raise ValueError(
            "recipient_rank accepts a rank index or the string 'all'; "
            f"got {recipient_rank!r}."
        )
    group = process_group if process_group is not None else default_group()
    world_size = group.world_size
    if isinstance(recipient_rank, int) and world_size > 1 and not 0 <= recipient_rank < world_size:
        raise ValueError(
            f"``recipient_rank`` must be a rank in [0, {world_size}), got {recipient_rank}."
        )
    if world_size == 1:
        log.warning(
            "single-process collective group: there are no peer states to merge, "
            "so get_synced_metric() hands back the metric unchanged."
        )
        return metric
    if world_size == -1:
        log.warning(
            "collective group reports world size -1 (this process appears to be "
            "outside the group); get_synced_metric() yields None."
        )
        return None
    if world_size <= 1:
        raise RuntimeError(
            f"cannot sync metric states over a collective group of reported size {world_size}."
        )
    metric._prepare_for_merge_state()
    if recipient_rank == "all":
        gathered = group.all_gather_object(metric)
    else:
        gathered = group.gather_object(metric, dst=recipient_rank)
    if gathered is None:
        return None
    return clone_metric(gathered[0]).to(metric.device).merge_state(gathered[1:])


def reset_metrics(metrics: _TMetrics) -> _TMetrics:
    """Reset each metric; returns the input."""
    for metric in metrics:
        metric.reset()
    return metrics


def to_device(metrics: _TMetrics, device, *args: Any, **kwargs: Any) -> _TMetrics:
    """Move each metric to ``device``; returns the input."""
    device = canonicalize_device(device)
    for metric in metrics:
        metric.to(device, *args, **kwargs)
    return metrics


__all__ = (
    "clone_metric",
    "clone_metrics",
    "get_synced_metric",
    "get_synced_state_dict",
    "reset_metrics",
    "sync_and_compute",
    "to_device",
)
