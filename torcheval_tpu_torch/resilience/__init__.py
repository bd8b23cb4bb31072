"""Fault tolerance for streaming evals: durable checkpoint/resume,
collective retry/timeout/backoff, and deterministic fault injection (the
port of ``torcheval_tpu/resilience``).

- :mod:`.checkpoint`: :class:`CheckpointManager`, atomic (tmp + fsync +
  rename, SHA-256 manifest) generations of a collection's
  ``state_dict()`` plus a stream cursor, in the JAX package's layout.
- :mod:`.retry`: :class:`RetryPolicy` / :class:`ResilientGroup`,
  backoff-retried object collectives with a hard deadline, a typed
  :class:`CollectiveTimeoutError`, and an optional ``degrade="local"``
  single-host fallback.
- :mod:`.faults`: :class:`FaultPlan`, seeded, site-named fault injection
  behind the same one-branch guards as the telemetry bus.
- :mod:`.membership`: :class:`MembershipView`, live-rank tracking for the
  hierarchical fleet merge (``parallel/fleet_merge.py``).
"""

from torcheval_tpu_torch.resilience import checkpoint, faults, membership, retry
from torcheval_tpu_torch.resilience.checkpoint import Checkpoint, CheckpointManager
from torcheval_tpu_torch.resilience.faults import (
    DroppedRank,
    FaultPlan,
    FaultRule,
    InjectedFault,
)
from torcheval_tpu_torch.resilience.membership import MembershipView
from torcheval_tpu_torch.resilience.retry import (
    CollectiveTimeoutError,
    ResilientGroup,
    RetryPolicy,
)

__all__ = [
    "Checkpoint",
    "CheckpointManager",
    "CollectiveTimeoutError",
    "DroppedRank",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "MembershipView",
    "ResilientGroup",
    "RetryPolicy",
    "checkpoint",
    "faults",
    "membership",
    "retry",
]
