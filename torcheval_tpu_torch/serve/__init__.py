"""Multi-tenant eval serving: coalesced sessions under admission control
(the port of ``torcheval_tpu/serve``).

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

The distributed tier (:mod:`~torcheval_tpu_torch.serve.cluster` +
:mod:`~torcheval_tpu_torch.serve.placement`) shards tenants across hosts
on a consistent-hash ring, routes batches p2p with backpressure, migrates
sessions live through the checkpoint path, and repairs the ring around
dead hosts: every action a typed :class:`PlacementOutcome`.

Example::

    from torcheval_tpu_torch.metrics import MulticlassAccuracy
    from torcheval_tpu_torch.serve import EvalService

    svc = EvalService(group_width=8)
    svc.open("tenant-a", {"acc": MulticlassAccuracy(num_classes=100)})
    svc.submit("tenant-a", scores, target)   # Admitted / Shed / Rejected
    svc.pump()
    svc.results("tenant-a")

A cluster over the ranks of one process (one ``ServeCluster`` a rank of a
``LocalWorld``, or of a ``TorchProcessGroup`` across processes), stepped
from the caller's loop::

    world = LocalWorld(2)
    clusters = [ServeCluster(world.group(r), spill_dir=d) for r in range(2)]
    for c in clusters:
        c.open("tenant-a", lambda: {"acc": MulticlassAccuracy(num_classes=100)})
    clusters[0].submit("tenant-a", scores, target)   # local or routed
    for c in clusters:
        c.step()
"""

from torcheval_tpu_torch.serve import metering
from torcheval_tpu_torch.serve.admission import (
    POLICIES,
    Admitted,
    AdmissionController,
    Rejected,
    Shed,
)
from torcheval_tpu_torch.serve.cluster import ServeCluster
from torcheval_tpu_torch.serve.metering import (
    RebalanceHints,
    TenantSignal,
    rebalance_hints,
)
from torcheval_tpu_torch.serve.placement import (
    HashRing,
    Placement,
    PlacementOutcome,
)
from torcheval_tpu_torch.serve.registry import (
    DEFAULT_GROUP_WIDTH,
    Session,
    SessionRegistry,
    TenantGroup,
    signature_of,
)
from torcheval_tpu_torch.serve.service import DrainResult, EvalService

__all__ = [
    "Admitted",
    "AdmissionController",
    "DEFAULT_GROUP_WIDTH",
    "DrainResult",
    "EvalService",
    "HashRing",
    "POLICIES",
    "Placement",
    "PlacementOutcome",
    "RebalanceHints",
    "Rejected",
    "ServeCluster",
    "Session",
    "SessionRegistry",
    "Shed",
    "TenantGroup",
    "TenantSignal",
    "metering",
    "rebalance_hints",
    "signature_of",
]
