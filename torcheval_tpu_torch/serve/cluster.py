"""ServeCluster: the distributed serve plane (the port of
``torcheval_tpu/serve/cluster.py``).

One :class:`ServeCluster` per host turns the single-host
:class:`~torcheval_tpu_torch.serve.service.EvalService` into a sharded
fleet:

* **Placement**: tenants land on hosts via the consistent-hash ring in
  :mod:`~torcheval_tpu_torch.serve.placement` (deterministic and
  membership-keyed: every host computes the same owner from the same
  alive set + migration overrides, no coordination round).
* **Routing**: ``submit()`` on a non-owner host frames the batch
  (:func:`~torcheval_tpu_torch.distributed.pack_frames`: length-prefixed
  arrays, the JAX package's wire format; tensors on the card are pulled
  to the host) and ships it to the owner over the group's p2p channel
  under the ``serve/`` tag namespace.  Acks are batched per peer and
  carry the owner's applied/durable cursors plus its
  :class:`~torcheval_tpu_torch.serve.admission.AdmissionController`
  queue-depth/shed signals: the sender sheds locally once its route
  window fills or the owner reports shedding (backpressure, typed, no
  exception).  The owner puts each unpacked frame on its tenant group's
  device with one copy and dispatches it through the service: on a GPU
  one ``mega.cu`` launch a dispatch, as for a local submit.
* **Exactly-once application**: every tenant's batches carry a
  monotone sequence number; the owner applies them in order, and its
  cursor is the session's dispatched-batch count, the same number the
  checkpoint manifest stores.  After any handoff the new owner resumes
  at cursor *c* and skips re-sent batches below *c*: duplicates are
  impossible by construction, and the applied stream is bit-exact.
* **Live migration**: a two-phase handoff: the owner spills through
  ``CheckpointManager.namespace(tenant)`` (host numpy), streams the
  checkpoint bytes + manifest p2p
  (:meth:`~torcheval_tpu_torch.resilience.checkpoint.CheckpointManager.export_latest`
  / :meth:`~torcheval_tpu_torch.resilience.checkpoint.CheckpointManager.import_blob`;
  a torn transfer is sha256-quarantined, never resumed), the target
  resumes onto its own device and acks, and the placement override
  (versioned, max-wins) bumps the ring epoch.  A stale owner is fenced
  by the override version and by the cursor in the manifest.
* **Failover**: hosts gossip their placement state on every heartbeat
  and ack; a peer silent past the death timeout is excised
  (:class:`~torcheval_tpu_torch.resilience.membership.MembershipView`)
  and the ring repairs around it.  A dead host's tenants resume from
  their durable spill namespace where one validates; sessions never
  spilled are reported ``lost``: a typed
  :class:`~torcheval_tpu_torch.serve.placement.PlacementOutcome`, never
  an exception escaping the cluster API.
* **Rebalancing**: a rebalancer thread consumes
  :func:`~torcheval_tpu_torch.serve.metering.rebalance_hints` (hot/cold
  skew, shed rate, spill churn) and live-migrates the hottest local
  tenant toward the least-loaded survivor.

Fault sites (``resilience/faults.py``): ``serve.route`` fires per
placement decision (submit and owner-side apply) and ``serve.migrate``
per migration phase (``spill`` / ``stream`` / ``resume``); an
``action="drop_rank"`` rule makes this host vanish mid-dispatch or
mid-migration.

Tenant registration is symmetric: every host calls :meth:`open` with
the same metric *factory* (factories never cross the wire: they are
not picklable in general), so any host can resume any tenant after a
migration or repair.  One logical submitter per tenant is assumed (the
sequence numbers are per client stream).

Devices: a tenant's states live on its factory's metrics' device (``cuda``
by default, ``device="cpu"`` on a host without a GPU).  A local
:meth:`ServeCluster.results` returns tensors on the owner's device; a
remote one crosses the wire pickled, and the group's pickling moves
tensors to the CPU, so it returns CPU tensors (compare bits with
``.cpu()``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.distributed import (
    CollectiveGroup,
    PeerTimeoutError,
    pack_frames,
    serve_tag,
    unpack_frames,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.resilience.checkpoint import (
    CheckpointBlob,
    CheckpointManager,
)
from torcheval_tpu_torch.resilience.faults import DroppedRank, InjectedFault
from torcheval_tpu_torch.resilience.membership import MembershipView
from torcheval_tpu_torch.telemetry import events as _telemetry

import torcheval_tpu_torch.serve.metering as _metering
from torcheval_tpu_torch.serve.admission import Admitted, Shed
from torcheval_tpu_torch.serve.placement import Placement, PlacementOutcome
from torcheval_tpu_torch.serve.registry import (
    ACTIVE,
    CLOSED,
    QUARANTINED,
    SPILLED,
)
from torcheval_tpu_torch.serve.service import EvalService

MetricFactory = Callable[[], Mapping[str, Metric]]

# Missed heartbeats before a silent peer is declared dead.
_DEATH_MISSES = 5

# Per-peer non-blocking poll budget (seconds) while draining the inbox.
_POLL_S = 0.0

# Default wait budget for a blocking migration / remote results call.
_DEFAULT_WAIT_S = 10.0


def _placed(
    args: tuple, kwargs: Dict[str, Any], device: torch.device
) -> tuple:
    """A routed batch's unpacked frames on the owner's ``device``: one
    copy a frame (host to device on a GPU).  ``torch.tensor`` copies, so
    no tensor aliases the read-only views over the wire payload."""
    return (
        tuple(torch.tensor(a, device=device) for a in args),
        {k: torch.tensor(v, device=device) for k, v in kwargs.items()},
    )


def _note_owner(tenant: str, owner: int) -> None:
    """Record the tenant's owning host in the attribution table (lazy:
    ``telemetry.tenants`` sits in the observe layer above serve; only
    placement changes land here, never the per-batch path)."""
    from torcheval_tpu_torch.telemetry import tenants as _tenants

    _tenants.note_owner(tenant, str(owner))


class _ClientStream:
    """Sender-side state for one tenant routed to a remote owner."""

    __slots__ = (
        "next_seq",
        "frames",
        "applied",
        "durable",
        "owner",
        "remote_depth",
        "remote_shedding",
        "failed",
        "resend",
    )

    def __init__(self, owner: int) -> None:
        self.next_seq = 0
        # seq -> framed payload, retained until the owner reports the
        # state DURABLE past it (an applied-but-unspilled batch must be
        # re-drivable after the owner dies).
        self.frames: Dict[int, bytes] = {}
        self.applied = -1  # owner's applied-through cursor
        self.durable = -1  # owner's spilled-through cursor
        self.owner = owner
        self.remote_depth = 0
        self.remote_shedding = False
        self.failed = ""  # "lost" | "quarantined" | "rejected" | ""
        self.resend = False


class _OwnerStream:
    """Receiver-side state for one tenant this host owns."""

    __slots__ = ("buffer", "clients", "durable", "shedding")

    def __init__(self) -> None:
        # Out-of-order / backpressured arrivals parked until applicable.
        self.buffer: Dict[int, bytes] = {}
        self.clients: set = set()
        self.durable = -1
        self.shedding = False


class ServeCluster:
    """A sharded multi-tenant serve plane over one p2p-capable group.

    Drive it synchronously (:meth:`step` from your own loop — the chaos
    suite's deterministic mode) or with :meth:`start` /:meth:`stop`
    background router + rebalancer threads.  Every public method
    returns a typed :class:`PlacementOutcome`; no exception escapes.
    """

    def __init__(
        self,
        group: CollectiveGroup,
        *,
        spill_dir: str,
        vnodes: Optional[int] = None,
        route_window: Optional[int] = None,
        heartbeat_s: Optional[float] = None,
        death_timeout_s: Optional[float] = None,
        group_width: int = 8,
        admission: Optional[Any] = None,
        max_resident: Optional[int] = None,
    ) -> None:
        if not group.supports_p2p:
            raise ValueError(
                "ServeCluster needs a p2p-capable group "
                "(LocalGroup or TorchProcessGroup)"
            )
        self._group = group
        self._rank = group.rank
        self._world = group.world_size
        self._vnodes = (
            int(vnodes)
            if vnodes is not None
            else _flags.get_int("SERVE_VNODES")
        )
        self._route_window = (
            int(route_window)
            if route_window is not None
            else _flags.get_int("SERVE_ROUTE_WINDOW")
        )
        self._heartbeat_s = (
            float(heartbeat_s)
            if heartbeat_s is not None
            else _flags.get_int("SERVE_HEARTBEAT_MS") / 1e3
        )
        self._death_timeout_s = (
            float(death_timeout_s)
            if death_timeout_s is not None
            else _DEATH_MISSES * self._heartbeat_s
        )
        self._spill_dir = str(spill_dir)
        # The cluster's own handle on the durable tenant store — the
        # same directory the service spills into, reused for p2p
        # export/import and failover recovery checks.
        self._store = CheckpointManager(self._spill_dir)
        self._service = EvalService(
            group_width=group_width,
            admission=admission,
            spill_dir=self._spill_dir,
            max_resident=max_resident,
        )
        self._membership = MembershipView(self._world, self._rank)
        self._placement = Placement(self._world, vnodes=self._vnodes)
        self._lock = threading.RLock()
        self._factories: Dict[str, MetricFactory] = {}
        self._streams: Dict[str, _ClientStream] = {}
        self._apply: Dict[str, _OwnerStream] = {}
        self._lost: set = set()
        self._send_seq = [0] * self._world
        self._recv_seq = [0] * self._world
        self._last_heard: Dict[int, float] = {}
        self._last_hb = 0.0
        self._dead_self = False
        # peer -> {tenant: ack entry}; flushed once per step.
        self._pending_acks: Dict[int, Dict[str, Dict[str, Any]]] = {}
        # tenant -> in-flight migration bookkeeping (this host = source).
        self._migrating: Dict[str, Dict[str, Any]] = {}
        self._migration_s: List[float] = []
        self._results_replies: Dict[int, Dict[str, Any]] = {}
        # rids with a live waiter; replies for any other rid (waiter
        # timed out / redirected away) are dropped on arrival so the
        # reply dict cannot grow without bound.
        self._results_waiting: set = set()
        self._next_rid = 0
        self._counts: Dict[str, int] = {
            "routed": 0,
            "local": 0,
            "shed_window": 0,
            "shed_remote": 0,
            "shed_migrating": 0,
            "migrations": 0,
            "migrations_aborted": 0,
            "repairs": 0,
            "recovered": 0,
            "lost": 0,
            "redirects": 0,
        }
        self._router: Optional[threading.Thread] = None
        self._rebalancer: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()

    # ------------------------------------------------------------ helpers
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def service(self) -> EvalService:
        return self._service

    @property
    def placement(self) -> Placement:
        return self._placement

    @property
    def epoch(self) -> int:
        return self._placement.epoch

    def _outcome(
        self, tenant: str, action: str, owner: int = -1, **kw: Any
    ) -> PlacementOutcome:
        return PlacementOutcome(
            tenant=tenant,
            action=action,
            owner=owner,
            epoch=self._placement.epoch,
            **kw,
        )

    def _send(self, dst: int, msg: Dict[str, Any]) -> None:
        if self._dead_self or dst == self._rank:
            return
        if not self._membership.is_alive(dst):
            return
        seq = self._send_seq[dst]
        self._send_seq[dst] += 1
        # tpulint: disable=TPU007 -- fire-and-forget put (KV store / local mailbox): completes on this host, never waits on the peer
        self._group.send_object(
            msg, dst, serve_tag(f"m/{self._rank}/{dst}/{seq}")
        )

    def _gossip_payload(self) -> Dict[str, Any]:
        snap = self._placement.snapshot()
        return {
            "epoch": self._placement.epoch,
            "dead": snap["dead"],
            "ovr": snap["ovr"],
        }

    def _merge_gossip(self, msg: Mapping[str, Any]) -> None:
        dead = msg.get("dead") or ()
        for rank in dead:
            if int(rank) == self._rank:
                # The fleet thinks we are dead; believe it (a zombie
                # owner double-applying is worse than a clean exit).
                self.kill()
                return
        newly = [
            int(r) for r in dead if self._membership.is_alive(int(r))
        ]
        self._membership.merge_gossip(newly, reason="serve gossip")
        changed = self._placement.merge(dead, msg.get("ovr"))
        for rank in newly:
            self._repair(rank)
        if changed:
            self._reroute_streams()

    # ----------------------------------------------------------- sessions
    def open(
        self, tenant: str, factory: MetricFactory
    ) -> PlacementOutcome:
        """Register ``tenant`` fleet-wide.  Call on EVERY host with the
        same factory; the host the ring assigns opens the session
        locally, the rest just remember the factory so they can resume
        the tenant after a migration or repair."""
        # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
        if self._dead_self:
            return self._outcome(tenant, "dead")
        with self._lock:
            self._factories[tenant] = factory
            owner = self._placement.owner_of(tenant)
            if owner < 0:
                return self._outcome(
                    tenant, "dead", detail="no live hosts"
                )
            _note_owner(tenant, owner)
            if owner == self._rank:
                try:
                    if self._service.session(tenant) is None:
                        self._service.open(tenant, factory())
                except RuntimeError as exc:
                    return self._outcome(
                        tenant, "rejected", owner, detail=str(exc)
                    )
                return self._outcome(tenant, "local", owner)
            return self._outcome(tenant, "routed", owner)

    def close(self, tenant: str) -> PlacementOutcome:
        """Close ``tenant`` wherever it lives (local close, or a routed
        close message to the owner)."""
        # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
        if self._dead_self:
            return self._outcome(tenant, "dead")
        with self._lock:
            self._factories.pop(tenant, None)
            owner = self._placement.owner_of(tenant)
            if owner < 0:
                return self._outcome(
                    tenant, "dead", detail="no live hosts"
                )
            if owner == self._rank:
                try:
                    self._service.close(tenant)
                except KeyError:
                    return self._outcome(
                        tenant, "rejected", owner, detail="unknown-tenant"
                    )
                self._apply.pop(tenant, None)
                return self._outcome(tenant, "local", owner)
            self._send(owner, {"type": "cls", "t": tenant})
            self._streams.pop(tenant, None)
            return self._outcome(tenant, "routed", owner)

    # ----------------------------------------------------------- submit
    def submit(
        self, tenant: str, *args: Any, **kwargs: Any
    ) -> PlacementOutcome:
        """Offer one batch.  Local tenants go straight to the service;
        remote tenants are framed and routed to their owner, gated by
        the route window and the owner's backpressure signals."""
        # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
        if self._dead_self:
            return self._outcome(tenant, "dead")
        try:
            if _faults.ENABLED:
                _faults.fire(
                    "serve.route",
                    tenant=tenant,
                    rank=self._rank,
                    role="submit",
                )
        except DroppedRank:
            self.kill()
            return self._outcome(tenant, "dead", detail="dropped")
        except InjectedFault as exc:
            return self._outcome(tenant, "shed", detail=str(exc))
        with self._lock:
            if tenant in self._lost:
                return self._outcome(
                    tenant, "lost", detail="unspilled on dead host"
                )
            owner = self._placement.owner_of(tenant)
            if owner < 0:
                return self._outcome(
                    tenant, "dead", detail="no live hosts"
                )
            if owner == self._rank:
                if tenant in self._migrating:
                    # A two-phase handoff is in flight: the spill
                    # cursor already streamed to the target, and the
                    # commit evicts this seat WITHOUT re-spilling — a
                    # locally admitted batch would vanish.  Routed
                    # submits survive via client-side frame retention;
                    # local ones have no retention, so shed typed
                    # until the handoff commits or aborts.
                    self._counts["shed_migrating"] += 1
                    return self._outcome(
                        tenant, "shed", owner, detail="migrating"
                    )
                return self._submit_local(tenant, args, kwargs)
            stream = self._streams.get(tenant)
            if stream is None:
                stream = self._streams[tenant] = _ClientStream(owner)
            if stream.failed:
                return self._outcome(
                    tenant, "rejected", owner, detail=stream.failed
                )
            inflight = stream.next_seq - 1 - stream.applied
            if inflight >= self._route_window:
                self._counts["shed_window"] += 1
                return self._outcome(
                    tenant, "shed", owner, detail="route-window"
                )
            if stream.remote_shedding:
                self._counts["shed_remote"] += 1
                # One shot per signal: the next ack refreshes it.
                stream.remote_shedding = False
                return self._outcome(
                    tenant, "shed", owner, detail="remote-shed"
                )
            payload = pack_frames(args, kwargs)
            seq = stream.next_seq
            stream.next_seq += 1
            stream.frames[seq] = payload
            stream.owner = owner
            self._send(
                owner,
                {"type": "sub", "t": tenant, "q": seq, "f": payload},
            )
            self._counts["routed"] += 1
            if _telemetry.ENABLED:
                _telemetry.record_placement(
                    "route",
                    tenant,
                    src=self._rank,
                    dst=owner,
                    epoch=self._placement.epoch,
                )
            return self._outcome(tenant, "routed", owner)

    def _submit_local(
        self, tenant: str, args: tuple, kwargs: Dict[str, Any]
    ) -> PlacementOutcome:
        # Caller holds the lock.
        try:
            out = self._service.submit(tenant, *args, **kwargs)
        except DroppedRank:
            self.kill()
            return self._outcome(tenant, "dead", detail="dropped")
        except InjectedFault as exc:
            return self._outcome(
                tenant, "shed", self._rank, detail=str(exc)
            )
        self._counts["local"] += 1
        if isinstance(out, Admitted):
            return self._outcome(tenant, "local", self._rank, value=out)
        if isinstance(out, Shed):
            return self._outcome(
                tenant, "shed", self._rank, detail=out.reason, value=out
            )
        return self._outcome(
            tenant, "rejected", self._rank, detail=out.reason, value=out
        )

    # ----------------------------------------------------------- results
    def results(
        self, tenant: str, *, timeout_s: float = _DEFAULT_WAIT_S
    ) -> PlacementOutcome:
        """``compute()`` for ``tenant`` wherever it lives.  Remote
        owners are queried over p2p (the call drives :meth:`step` while
        it waits).  ``value`` carries the metric dict on success: tensors
        on the owner's device when this host owns the tenant, CPU tensors
        when the reply crossed the wire (the group pickles through the
        CPU)."""
        # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
        if self._dead_self:
            return self._outcome(tenant, "dead")
        with self._lock:
            if tenant in self._lost:
                return self._outcome(
                    tenant, "lost", detail="unspilled on dead host"
                )
            owner = self._placement.owner_of(tenant)
            if owner < 0:
                return self._outcome(
                    tenant, "dead", detail="no live hosts"
                )
            if owner == self._rank:
                return self._local_results(tenant, owner)
            rid = self._next_rid
            self._next_rid += 1
            self._results_waiting.add(rid)
            self._send(owner, {"type": "res", "t": tenant, "rid": rid})
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                self.step()
                with self._lock:
                    reply = self._results_replies.pop(rid, None)
                    if reply is not None:
                        if reply.get("ok"):
                            return self._outcome(
                                tenant, "local", owner, value=reply["val"]
                            )
                        return self._outcome(
                            tenant,
                            reply.get("action", "rejected"),
                            owner,
                            detail=reply.get("detail", ""),
                        )
                    if tenant in self._lost:
                        return self._outcome(
                            tenant, "lost", detail="owner died"
                        )
                    new_owner = self._placement.owner_of(tenant)
                # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
                if self._dead_self:
                    return self._outcome(tenant, "dead")
                if new_owner != owner:
                    return self.results(
                        tenant,
                        timeout_s=max(0.0, deadline - time.monotonic()),
                    )
                time.sleep(0.001)
            return self._outcome(tenant, "timeout", owner)
        finally:
            # Every exit path (reply consumed, timeout, redirect
            # recursion, host death) retires the rid so a late reply
            # is dropped at the door instead of leaking.
            with self._lock:
                self._results_waiting.discard(rid)
                self._results_replies.pop(rid, None)

    def _local_results(self, tenant: str, owner: int) -> PlacementOutcome:
        try:
            value = self._service.results(tenant)
        except KeyError:
            return self._outcome(
                tenant, "rejected", owner, detail="unknown-tenant"
            )
        except RuntimeError as exc:
            return self._outcome(
                tenant, "rejected", owner, detail=str(exc)
            )
        return self._outcome(tenant, "local", owner, value=value)

    # ---------------------------------------------------------- migration
    def migrate(
        self,
        tenant: str,
        target: int,
        *,
        wait: bool = True,
        timeout_s: float = _DEFAULT_WAIT_S,
    ) -> PlacementOutcome:
        """Two-phase live handoff of ``tenant`` to ``target``: spill →
        stream bytes p2p → target resumes and acks → override commits
        and the epoch bumps.  The source keeps serving until commit;
        an aborted handoff (target died, torn transfer, injected
        fault) leaves the tenant bit-exact at the source."""
        # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
        if self._dead_self:
            return self._outcome(tenant, "dead")
        t0 = time.monotonic()
        with self._lock:
            if (
                target == self._rank
                or not self._membership.is_alive(target)
            ):
                return self._outcome(
                    tenant, "aborted", detail="bad target"
                )
            if self._placement.owner_of(tenant) != self._rank:
                return self._outcome(
                    tenant,
                    "aborted",
                    self._placement.owner_of(tenant),
                    detail="not owner",
                )
            if tenant in self._migrating:
                return self._outcome(
                    tenant, "aborted", detail="migration in flight"
                )
            session = self._service.session(tenant)
            if session is None or session.state in (QUARANTINED, CLOSED):
                return self._outcome(
                    tenant, "aborted", detail="no migratable session"
                )
            try:
                if _faults.ENABLED:
                    _faults.fire(
                        "serve.migrate",
                        tenant=tenant,
                        phase="spill",
                        rank=self._rank,
                        target=target,
                    )
                # Flush whatever is queued, then checkpoint: the spill
                # cursor IS the handoff cursor.
                self._service.pump()
                if session.state != SPILLED:
                    self._service.spill(tenant)
                if _faults.ENABLED:
                    _faults.fire(
                        "serve.migrate",
                        tenant=tenant,
                        phase="stream",
                        rank=self._rank,
                        target=target,
                    )
            except DroppedRank:
                self.kill()
                return self._outcome(tenant, "dead", detail="dropped")
            except (InjectedFault, RuntimeError) as exc:
                self._counts["migrations_aborted"] += 1
                return self._outcome(tenant, "aborted", detail=str(exc))
            blob = self._store.namespace(tenant).export_latest()
            if blob is None:
                self._counts["migrations_aborted"] += 1
                return self._outcome(
                    tenant, "aborted", detail="nothing durable to stream"
                )
            version = self._placement.override_version(tenant) + 1
            stream = self._apply.get(tenant)
            if stream is not None:
                stream.durable = max(
                    stream.durable,
                    int(blob.manifest["cursor"].get("batches_seen", 0))
                    - 1,
                )
            self._send(
                target,
                {
                    "type": "mig",
                    "t": tenant,
                    "g": blob.generation,
                    "m": blob.manifest,
                    "p": blob.payload,
                    "v": version,
                },
            )
            self._migrating[tenant] = {
                "target": target,
                "version": version,
                "t0": t0,
                "deadline": t0 + timeout_s,
                # The handoff cursor: the target resumes exactly here,
                # so the commit can seed this host's client stream at
                # a sequence the target's duplicate fence accepts.
                "cursor": int(
                    blob.manifest["cursor"].get("batches_seen", 0)
                ),
            }
        if not wait:
            return self._outcome(
                tenant, "routed", target, detail="migration started"
            )
        while True:
            self.step()
            with self._lock:
                if self._dead_self:
                    return self._outcome(tenant, "dead")
                entry = self._migrating.get(tenant)
                if entry is None:
                    if self._placement.owner_of(tenant) == target:
                        return self._outcome(tenant, "migrated", target)
                    return self._outcome(
                        tenant, "aborted", detail="handoff rejected"
                    )
                if time.monotonic() > entry["deadline"]:
                    self._abort_migration(tenant, "timeout")
                    return self._outcome(
                        tenant, "aborted", detail="timeout"
                    )
            time.sleep(0.001)

    def _abort_migration(self, tenant: str, why: str) -> None:
        # Caller holds the lock.  The source spilled before streaming,
        # so the session resumes bit-exact on next touch — nothing to
        # roll back.
        self._migrating.pop(tenant, None)
        self._counts["migrations_aborted"] += 1
        if _telemetry.ENABLED:
            _telemetry.record_degraded(
                "serve.migrate",
                f"tenant {tenant!r} handoff aborted: {why}",
                "migration_aborted",
            )

    # --------------------------------------------------------- rebalancer
    def rebalance_once(
        self, *, min_gap: int = 2
    ) -> List[PlacementOutcome]:
        """One rebalance pass: consume ``serve.rebalance_hints()`` and
        live-migrate the hottest local tenant (device-seconds, then
        queue depth, then shed rate, then spill churn) to the
        least-loaded survivor when the owned-tenant census is skewed by
        at least ``min_gap``."""
        # tpulint: disable=TPU006 -- _dead_self is a monotonic kill flag: the lock-free read is the zombie fence on the no-lock fast path
        if self._dead_self:
            return []
        hints = _metering.rebalance_hints()
        with self._lock:
            alive = self._placement.alive
            if len(alive) < 2:
                return []
            census = {r: 0 for r in alive}
            for tenant in self._factories:
                if tenant in self._lost:
                    continue
                owner = self._placement.owner_of(tenant)
                if owner in census:
                    census[owner] += 1
            coldest = min(
                (r for r in alive if r != self._rank),
                key=lambda r: (census[r], r),
            )
            if census[self._rank] - census[coldest] < min_gap:
                return []
            mine = [
                s
                for s in hints.tenants
                if s.tenant in self._factories
                and s.tenant not in self._lost
                and s.tenant not in self._migrating
                and self._placement.owner_of(s.tenant) == self._rank
                and self._service.session(s.tenant) is not None
            ]
            if not mine:
                return []
            hottest = max(
                mine,
                key=lambda s: (
                    s.device_seconds,
                    s.queue_depth,
                    s.shed_rate,
                    s.spill_churn,
                ),
            )
        return [self.migrate(hottest.tenant, coldest)]

    # -------------------------------------------------------------- step
    def step(self) -> int:
        """Drive the router once: drain the inbox, re-drive parked
        frames, pump the local service, flush batched acks, heartbeat,
        and check for dead peers.  Returns the number of messages
        handled.  Safe from any thread; a ``drop_rank`` fault kills
        this host typed, never raising."""
        # tpulint: disable=TPU006 -- caller holds _lock (documented contract of _poll_inbox)
        if self._dead_self:
            return 0
        try:
            with self._lock:
                handled = self._poll_inbox()
                if self._dead_self:
                    return handled
                self._retry_buffered()
                if self._service.pump():
                    # Local dispatch advanced remote tenants' cursors;
                    # refresh their acks.
                    for tenant, stream in self._apply.items():
                        for client in stream.clients:
                            self._queue_ack(client, tenant)
                self._checkpoint_routed()
                self._flush_acks()
                self._resend_marked()
                now = time.monotonic()
                if now - self._last_hb >= self._heartbeat_s:
                    self._last_hb = now
                    hb = {"type": "hb", **self._gossip_payload()}
                    for peer in self._placement.alive:
                        if peer != self._rank:
                            self._send(peer, hb)
                self._check_deaths(now)
            return handled
        except DroppedRank:
            self.kill()
            return 0

    def _poll_inbox(self) -> int:
        # Caller holds the lock (recv with timeout=0 never blocks, so
        # holding it across the drain is fine and keeps the per-peer
        # receive cursors race-free under router + waiter threads).
        handled = 0
        for peer in range(self._world):
            if peer == self._rank or not self._membership.is_alive(peer):
                continue
            while True:
                tag = serve_tag(
                    f"m/{peer}/{self._rank}/{self._recv_seq[peer]}"
                )
                try:
                    # tpulint: disable=TPU007 -- bounded: timeout=_POLL_S (0.0) makes this a non-blocking poll, never an unbounded wait
                    msg = self._group.recv_object(
                        peer, tag, timeout=_POLL_S
                    )
                except PeerTimeoutError:
                    break
                self._recv_seq[peer] += 1
                self._last_heard[peer] = time.monotonic()
                self._handle(msg, peer)
                handled += 1
                if self._dead_self:
                    return handled
        return handled

    def _handle(self, msg: Dict[str, Any], src: int) -> None:
        kind = msg.get("type")
        if kind == "sub":
            self._handle_submit(msg, src)
        elif kind == "ack":
            self._handle_ack(msg, src)
        elif kind == "hb":
            self._merge_gossip(msg)
        elif kind == "mig":
            self._handle_migrate(msg, src)
        elif kind == "migack":
            self._handle_migrate_ack(msg, src)
        elif kind == "res":
            self._handle_results_request(msg, src)
        elif kind == "resr":
            rid = int(msg["rid"])
            if rid in self._results_waiting:
                self._results_replies[rid] = msg
        elif kind == "cls":
            tenant = msg.get("t", "")
            if self._service.session(tenant) is not None:
                try:
                    self._service.close(tenant)
                except (KeyError, RuntimeError):
                    pass
            self._apply.pop(tenant, None)

    # ------------------------------------------------------ owner side
    def _handle_submit(self, msg: Dict[str, Any], src: int) -> None:
        tenant = msg["t"]
        seq = int(msg["q"])
        if tenant in self._lost:
            self._queue_ack(src, tenant, status="lost")
            return
        owner = self._placement.owner_of(tenant)
        if owner != self._rank:
            self._counts["redirects"] += 1
            self._queue_ack(src, tenant, status="redirect", owner=owner)
            return
        stream = self._apply.get(tenant)
        if stream is None:
            stream = self._apply[tenant] = _OwnerStream()
        stream.clients.add(src)
        stream.buffer[seq] = msg["f"]
        try:
            if _faults.ENABLED:
                # DroppedRank propagates to step(): a host dying
                # mid-dispatch, with batches in its inbox.
                _faults.fire(
                    "serve.route",
                    tenant=tenant,
                    rank=self._rank,
                    role="apply",
                )
        except DroppedRank:
            raise
        except InjectedFault:
            # Frame stays parked; the retry sweep re-drives it.
            return
        self._queue_ack(src, tenant, status=self._apply_buffered(tenant))

    def _apply_buffered(self, tenant: str) -> str:
        """Apply the tenant's parked frames strictly in sequence order
        against the session's batch cursor.  Returns the ack status."""
        stream = self._apply[tenant]
        session = self._service.session(tenant)
        if session is None:
            factory = self._factories.get(tenant)
            if factory is None:
                return "rejected"
            try:
                if (
                    self._store.namespace(tenant).export_latest()
                    is not None
                ):
                    self._service.adopt_spilled(tenant, factory())
                else:
                    self._service.open(tenant, factory())
            except RuntimeError:
                return "rejected"
        if self._service.session(tenant).state == QUARANTINED:
            return "quarantined"
        try:
            session = self._service.resume(tenant)
        except (KeyError, RuntimeError):
            return "rejected"
        # Drop re-sent frames the resumed cursor already covers — the
        # duplicate fence after any handoff or failover.
        for seq in [s for s in stream.buffer if s < session.batches]:
            stream.buffer.pop(seq)
        device = session.group.collection.device
        while session.batches in stream.buffer:
            expected = session.batches
            payload = stream.buffer.pop(expected)
            args, kwargs = _placed(*unpack_frames(payload), device)
            try:
                out = self._service.submit(tenant, *args, **kwargs)
            except DroppedRank:
                raise
            except InjectedFault:
                stream.buffer[expected] = payload
                stream.shedding = True
                return "ok"
            if isinstance(out, Admitted):
                self._service.pump()
                if session.state == QUARANTINED:
                    return "quarantined"
                if session.batches != expected + 1:
                    # Not dispatched this round (shed at pop / tenant
                    # gone): park the frame and retry next step.
                    stream.buffer[expected] = payload
                    stream.shedding = True
                    return "ok"
            elif isinstance(out, Shed):
                stream.buffer[expected] = payload
                stream.shedding = True
                return "ok"
            else:  # Rejected
                return "rejected"
        if not stream.buffer:
            stream.shedding = False
        return "ok"

    def _checkpoint_routed(self) -> None:
        # Caller holds the lock.  Senders retain every routed frame
        # until the durable cursor passes it, and the service only
        # spills on idle pressure or drain — a long-lived routed
        # tenant would pin the sender's memory forever.  Bound the
        # retention: once a route window's worth of applied-but-
        # unspilled batches accumulates, checkpoint the tenant so the
        # next ack carries an advanced durable cursor and clients
        # release their frames.  (The next routed frame transparently
        # resumes the session through the normal spill path.)
        for tenant, stream in self._apply.items():
            if not stream.clients or tenant in self._migrating:
                continue
            session = self._service.session(tenant)
            if session is None or session.state != ACTIVE:
                continue
            if session.batches - 1 - stream.durable < self._route_window:
                continue
            try:
                self._service.spill(tenant)
            except (KeyError, RuntimeError):
                continue
            stream.durable = max(stream.durable, session.batches - 1)
            for client in stream.clients:
                self._queue_ack(client, tenant)

    def _retry_buffered(self) -> None:
        # Frames parked by backpressure or injected routing faults get
        # re-driven once per step.
        for tenant in list(self._apply):
            stream = self._apply.get(tenant)
            if stream is None or not stream.buffer:
                continue
            if self._placement.owner_of(tenant) != self._rank:
                continue
            status = self._apply_buffered(tenant)
            for client in list(stream.clients):
                self._queue_ack(client, tenant, status=status)

    def _queue_ack(
        self,
        dst: int,
        tenant: str,
        status: str = "ok",
        owner: int = -1,
    ) -> None:
        entry: Dict[str, Any] = {"t": tenant, "s": status}
        if status == "redirect":
            entry["o"] = owner
        session = self._service.session(tenant)
        if session is not None:
            entry["a"] = session.batches - 1
        stream = self._apply.get(tenant)
        if stream is not None:
            if session is not None and session.state == SPILLED:
                # The service checkpointed this tenant (idle spill,
                # drain, explicit spill): the manifest cursor covers
                # every dispatched batch, so the durable cursor
                # advances and senders can release retained frames.
                stream.durable = max(
                    stream.durable, session.batches - 1
                )
            entry["d"] = stream.durable
            # The owner's AdmissionController backpressure signals ride
            # every ack back to the sender.
            entry["sh"] = stream.shedding
        entry["qd"] = self._service._admission.depth(tenant)
        self._pending_acks.setdefault(dst, {})[tenant] = entry

    def _flush_acks(self) -> None:
        if not self._pending_acks:
            return
        gossip = self._gossip_payload()
        for dst, entries in self._pending_acks.items():
            if not self._membership.is_alive(dst):
                continue
            self._send(
                dst,
                {"type": "ack", "e": list(entries.values()), **gossip},
            )
        self._pending_acks.clear()

    # ------------------------------------------------------ client side
    def _handle_ack(self, msg: Dict[str, Any], src: int) -> None:
        for entry in msg.get("e", ()):
            tenant = entry["t"]
            stream = self._streams.get(tenant)
            if stream is None:
                continue
            status = entry.get("s", "ok")
            if status == "lost":
                stream.failed = "lost"
                self._lost.add(tenant)
                continue
            if status in ("quarantined", "rejected"):
                stream.failed = status
                continue
            if status == "redirect":
                new_owner = int(entry.get("o", -1))
                if new_owner >= 0 and new_owner != stream.owner:
                    if new_owner == self._rank:
                        self._adopt_local_stream(tenant, stream)
                    else:
                        self._redirect_stream(tenant, stream, new_owner)
                continue
            if "a" in entry:
                stream.applied = max(stream.applied, int(entry["a"]))
            if "d" in entry:
                stream.durable = max(stream.durable, int(entry["d"]))
                for seq in [
                    s for s in stream.frames if s <= stream.durable
                ]:
                    stream.frames.pop(seq)
            stream.remote_depth = int(entry.get("qd", 0))
            stream.remote_shedding = bool(entry.get("sh", False))
        self._merge_gossip(msg)

    def _redirect_stream(
        self, tenant: str, stream: _ClientStream, new_owner: int
    ) -> None:
        stream.owner = new_owner
        # Conservative cursor reset: the new owner resumed from the
        # durable spill; everything after it is re-driven from the
        # retained frames (the owner's cursor fence drops what its
        # checkpoint already covers).
        stream.applied = stream.durable
        stream.resend = True

    def _adopt_local_stream(
        self, tenant: str, stream: _ClientStream
    ) -> None:
        """The ring moved a tenant WE were routing onto this host: hand
        the retained frames to the owner-side buffer (same duplicate
        fence) and apply them locally."""
        self._streams.pop(tenant, None)
        if tenant in self._lost or stream.failed:
            return
        ostream = self._apply.setdefault(tenant, _OwnerStream())
        for seq, payload in stream.frames.items():
            ostream.buffer.setdefault(seq, payload)
        self._apply_buffered(tenant)

    def _reroute_streams(self) -> None:
        for tenant, stream in list(self._streams.items()):
            if stream.failed:
                continue
            owner = self._placement.owner_of(tenant)
            if owner == self._rank:
                self._adopt_local_stream(tenant, stream)
            elif owner >= 0 and owner != stream.owner:
                self._redirect_stream(tenant, stream, owner)

    def _resend_marked(self) -> None:
        for tenant, stream in self._streams.items():
            if not stream.resend or stream.failed:
                continue
            stream.resend = False
            for seq in sorted(stream.frames):
                self._send(
                    stream.owner,
                    {
                        "type": "sub",
                        "t": tenant,
                        "q": seq,
                        "f": stream.frames[seq],
                    },
                )

    # ------------------------------------------------- migration (wire)
    def _handle_migrate(self, msg: Dict[str, Any], src: int) -> None:
        tenant = msg["t"]
        version = int(msg["v"])
        reply = {"type": "migack", "t": tenant, "v": version, "ok": False}
        try:
            if _faults.ENABLED:
                # A target dying mid-migration: the blob arrived but
                # the resume never happens — the source aborts and the
                # tenant stays bit-exact at the source.
                _faults.fire(
                    "serve.migrate",
                    tenant=tenant,
                    phase="resume",
                    rank=self._rank,
                    target=self._rank,
                )
        except DroppedRank:
            raise
        except InjectedFault as exc:
            reply["why"] = str(exc)
            self._send(src, reply)
            return
        if self._placement.override_version(tenant) >= version:
            reply["why"] = "stale"
            self._send(src, reply)
            return
        factory = self._factories.get(tenant)
        if factory is None:
            reply["why"] = "unknown tenant"
            self._send(src, reply)
            return
        blob = CheckpointBlob(
            generation=int(msg["g"]),
            manifest=dict(msg["m"]),
            payload=msg["p"],
        )
        t0 = time.monotonic()
        if not self._store.namespace(tenant).import_blob(blob):
            # Torn transfer: quarantined by import_blob; never resumed.
            reply["why"] = "torn transfer"
            self._send(src, reply)
            return
        session = self._service.session(tenant)
        if session is None:
            try:
                self._service.adopt_spilled(tenant, factory())
            except RuntimeError as exc:
                reply["why"] = str(exc)
                self._send(src, reply)
                return
        try:
            session = self._service.resume(tenant)
        except (KeyError, RuntimeError) as exc:
            reply["why"] = str(exc)
            self._send(src, reply)
            return
        self._placement.note_migration(tenant, self._rank, version)
        _note_owner(tenant, self._rank)
        stream = self._apply.setdefault(tenant, _OwnerStream())
        stream.durable = max(stream.durable, session.batches - 1)
        self._streams.pop(tenant, None)
        if _telemetry.ENABLED:
            _telemetry.record_placement(
                "migrate",
                tenant,
                src=src,
                dst=self._rank,
                epoch=self._placement.epoch,
                generation=int(msg["g"]),
                seconds=time.monotonic() - t0,
            )
        reply["ok"] = True
        self._send(src, reply)

    def _handle_migrate_ack(self, msg: Dict[str, Any], src: int) -> None:
        tenant = msg["t"]
        entry = self._migrating.get(tenant)
        if (
            entry is None
            or src != entry["target"]
            or int(msg.get("v", -1)) != entry["version"]
        ):
            # A stale ack (an earlier timed-out attempt, or a peer
            # that was never this migration's target) must not touch
            # the in-flight handoff's bookkeeping.
            return
        self._migrating.pop(tenant, None)
        if not msg.get("ok"):
            self._abort_migration(tenant, msg.get("why", "nack"))
            return
        self._placement.note_migration(
            tenant, entry["target"], entry["version"]
        )
        _note_owner(tenant, entry["target"])
        try:
            self._service.evict(tenant)
        except KeyError:
            pass
        self._apply.pop(tenant, None)
        if tenant not in self._streams:
            # This host's own submits now route to the target.  The
            # sequence numbers must line up with the target's resumed
            # batch cursor (its duplicate fence drops anything below
            # it), and the source knows that cursor exactly — it is
            # the spill cursor it streamed in phase one.
            stream = self._streams[tenant] = _ClientStream(
                entry["target"]
            )
            cursor = int(entry.get("cursor", 0))
            stream.next_seq = cursor
            stream.applied = cursor - 1
            stream.durable = cursor - 1
        self._counts["migrations"] += 1
        self._migration_s.append(time.monotonic() - entry["t0"])

    # ------------------------------------------------------ results wire
    def _handle_results_request(
        self, msg: Dict[str, Any], src: int
    ) -> None:
        tenant = msg["t"]
        rid = int(msg["rid"])
        reply: Dict[str, Any] = {"type": "resr", "rid": rid, "ok": False}
        if tenant in self._lost:
            reply["action"] = "lost"
        elif self._placement.owner_of(tenant) != self._rank:
            reply["action"] = "rejected"
            reply["detail"] = "not owner"
        else:
            out = self._local_results(tenant, self._rank)
            if out.action == "local":
                reply["ok"] = True
                reply["val"] = out.value
            else:
                reply["action"] = out.action
                reply["detail"] = out.detail
        self._send(src, reply)

    # ------------------------------------------------------ failure paths
    def _check_deaths(self, now: float) -> None:
        for peer in range(self._world):
            if peer == self._rank or not self._membership.is_alive(peer):
                continue
            first = self._last_heard.setdefault(peer, now)
            if now - first <= self._death_timeout_s:
                continue
            self._membership.excise(
                peer,
                f"serve heartbeat: silent {now - first:.3f}s",
            )
            self._placement.exclude(peer)
            self._repair(peer)
            self._reroute_streams()

    def _repair(self, dead: int) -> None:
        """Ring repair after ``dead`` was excised: adopt every tenant
        the survivors' ring now assigns HERE, resuming from the durable
        spill namespace when one validates and reporting the rest
        lost.  Surviving tenants' placements are untouched (the
        consistent-hash guarantee)."""
        self._counts["repairs"] += 1
        epoch = self._placement.epoch
        if _telemetry.ENABLED:
            _telemetry.record_placement(
                "repair", "", src=dead, dst=self._rank, epoch=epoch
            )
        # In-flight migrations addressed at the dead host abort (the
        # source spilled first, so the tenant resumes here bit-exact).
        for tenant in [
            t
            for t, e in self._migrating.items()
            if e["target"] == dead
        ]:
            self._abort_migration(tenant, f"target {dead} died")
        for tenant, factory in self._factories.items():
            if tenant in self._lost:
                continue
            if self._placement.owner_of(tenant) != self._rank:
                continue
            if self._service.session(tenant) is not None:
                continue
            _note_owner(tenant, self._rank)
            blob = self._store.namespace(tenant).export_latest()
            if blob is not None:
                try:
                    self._service.adopt_spilled(tenant, factory())
                except RuntimeError:
                    continue
                stream = self._apply.setdefault(tenant, _OwnerStream())
                stream.durable = max(
                    stream.durable,
                    int(blob.manifest["cursor"].get("batches_seen", 0))
                    - 1,
                )
                self._counts["recovered"] += 1
                if _telemetry.ENABLED:
                    _telemetry.record_placement(
                        "recovered",
                        tenant,
                        src=dead,
                        dst=self._rank,
                        epoch=epoch,
                        generation=blob.generation,
                    )
            else:
                # Never spilled before its host died: the only state
                # the repair cannot reconstruct.
                self._lost.add(tenant)
                self._counts["lost"] += 1
                if _telemetry.ENABLED:
                    _telemetry.record_placement(
                        "lost",
                        tenant,
                        src=dead,
                        dst=self._rank,
                        epoch=epoch,
                    )

    def kill(self) -> None:
        """Declare THIS host dead (chaos hook / zombie fencing): stop
        responding entirely.  Peers excise it after the death timeout
        and repair the ring around it."""
        # tpulint: disable=TPU006 -- kill() must never block on the router's lock; a bool store is atomic and monotonic
        self._dead_self = True
        self._stop_flag.set()

    @property
    def is_dead(self) -> bool:
        # tpulint: disable=TPU006 -- single racy bool read, same contract as every hook site's plain attribute read
        return self._dead_self

    # ------------------------------------------------------------ threads
    def start(
        self, *, rebalance_interval_s: Optional[float] = None
    ) -> "ServeCluster":
        """Start the background router thread (and, when an interval is
        given, the rebalancer thread consuming ``rebalance_hints()``).
        Idempotent."""
        with self._lock:
            if self._router is not None:
                return self
            self._stop_flag.clear()
            self._router = threading.Thread(
                target=self._router_loop,
                name=f"torcheval-tpu-torch-serve-router-{self._rank}",
                daemon=True,
            )
            self._router.start()
            if rebalance_interval_s is not None:
                self._rebalancer = threading.Thread(
                    target=self._rebalancer_loop,
                    args=(float(rebalance_interval_s),),
                    name=f"torcheval-tpu-torch-serve-rebalance-{self._rank}",
                    daemon=True,
                )
                self._rebalancer.start()
        return self

    def _router_loop(self) -> None:
        while not self._stop_flag.is_set():
            if self.step() == 0:
                time.sleep(min(0.002, self._heartbeat_s / 4))

    def _rebalancer_loop(self, interval_s: float) -> None:
        while not self._stop_flag.wait(timeout=interval_s):
            self.rebalance_once()

    def stop(self) -> None:
        """Stop and join the background threads (idempotent)."""
        self._stop_flag.set()
        for thread in (self._router, self._rebalancer):
            if thread is not None:
                thread.join(timeout=5.0)
        self._router = None
        self._rebalancer = None

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Host-side cluster counters (valid with telemetry off)."""
        with self._lock:
            lat = sorted(self._migration_s)
            p99 = (
                lat[max(0, int(len(lat) * 0.99) - 1)] if lat else 0.0
            )
            return {
                "rank": self._rank,
                "epoch": self._placement.epoch,
                "fingerprint": self._placement.fingerprint(),
                "alive": list(self._placement.alive),
                "dead": list(self._placement.dead),
                "lost": sorted(self._lost),
                "owned": sorted(
                    t
                    for t in self._factories
                    if self._placement.owner_of(t) == self._rank
                    and t not in self._lost
                ),
                "migration_p99_s": p99,
                "migration_count": len(lat),
                "counts": dict(self._counts),
                "service": self._service.stats(),
            }
