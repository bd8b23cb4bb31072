"""Multi-tenant eval serving: coalesced sessions under admission control
(the port of ``torcheval_tpu/serve``, its single-host plane).

The serve layer turns the sliced-collection machinery into a long-running,
overload-safe service: many tenants' metric suites coalesce by signature
onto shared sliced collections (:mod:`~torcheval_tpu_torch.serve.registry`;
on a GPU one ``mega.cu`` launch a dispatch), bursts are absorbed by bounded
queues with typed shed outcomes (:mod:`~torcheval_tpu_torch.serve.admission`),
and a poison tenant is quarantined (rolled back, purged, reported) without
perturbing its neighbours (:mod:`~torcheval_tpu_torch.serve.service`).
Idle sessions spill to checkpoints and resume transparently.  When the
per-tenant ledger is on (:mod:`~torcheval_tpu_torch.serve.metering`),
:func:`rebalance_hints` reads it back as typed placement signals.

Example::

    from torcheval_tpu_torch.metrics import MulticlassAccuracy
    from torcheval_tpu_torch.serve import EvalService

    svc = EvalService(group_width=8)
    svc.open("tenant-a", {"acc": MulticlassAccuracy(num_classes=100)})
    svc.submit("tenant-a", scores, target)   # Admitted / Shed / Rejected
    svc.pump()
    svc.results("tenant-a")

Not here yet: the distributed tier (``ServeCluster``, ``HashRing``,
``Placement``, ``PlacementOutcome``; ``serve/cluster.py`` and
``serve/placement.py``), ROADMAP queue 1 step 8.  Asking for one of those
names raises ``NotImplementedError``.
"""

from typing import Any

from torcheval_tpu_torch.serve import metering
from torcheval_tpu_torch.serve.admission import (
    POLICIES,
    Admitted,
    AdmissionController,
    Rejected,
    Shed,
)
from torcheval_tpu_torch.serve.metering import (
    RebalanceHints,
    TenantSignal,
    rebalance_hints,
)
from torcheval_tpu_torch.serve.registry import (
    DEFAULT_GROUP_WIDTH,
    Session,
    SessionRegistry,
    TenantGroup,
    signature_of,
)
from torcheval_tpu_torch.serve.service import DrainResult, EvalService

# The multi-host names of the JAX package, with the module each lives in.
_NEXT_SLICE = {
    "ServeCluster": "serve/cluster.py",
    "HashRing": "serve/placement.py",
    "Placement": "serve/placement.py",
    "PlacementOutcome": "serve/placement.py",
}


def __getattr__(name: str) -> Any:
    if name in _NEXT_SLICE:
        raise NotImplementedError(
            f"torcheval_tpu_torch.serve.{name} lives in {_NEXT_SLICE[name]}, the "
            "multi-host serve plane, which the port does not have yet (ROADMAP "
            "queue 1 step 8)."
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Admitted",
    "AdmissionController",
    "DEFAULT_GROUP_WIDTH",
    "DrainResult",
    "EvalService",
    "POLICIES",
    "RebalanceHints",
    "Rejected",
    "Session",
    "SessionRegistry",
    "Shed",
    "TenantGroup",
    "TenantSignal",
    "metering",
    "rebalance_hints",
    "signature_of",
]
