"""Object collectives for metric sync (the port's slice of
``torcheval_tpu/distributed.py``).

* :class:`CollectiveGroup`: the process-group abstraction the sync
  toolkit talks to (reference ``PGWrapper``): ``rank``, ``world_size``,
  ``all_gather_object``, ``broadcast_object``, ``gather_object``, an
  optional point-to-point channel (``send_object`` / ``recv_object``),
  and the tensor collective :meth:`~CollectiveGroup.all_reduce_many`
  (one op a tensor, all in one gather; :meth:`~CollectiveGroup.all_reduce`
  is its one-tensor case) under the sharded metrics of ``parallel/`` (the
  counterpart of JAX's ``psum`` / ``pmax`` / ``pmin`` / ``pmean`` / tiled
  ``all_gather``).
* :class:`SingleProcessGroup` and :class:`NullGroup`: the world of one,
  and a group this process is not part of.
* :class:`TorchProcessGroup` and :func:`initialize_multihost`: a real
  world of processes over ``torch.distributed`` (gloo), the counterpart
  of JAX's ``JaxProcessGroup`` / ``initialize_multihost``.  Its object
  collectives are torch's (``all_gather_object``,
  ``broadcast_object_list``, ``gather_object``); its point-to-point
  channel rides the c10d store the process group already holds, as
  JAX's rides the coordination service's KV store.
  :func:`default_group` is this group whenever a ``torch.distributed``
  world of more than one process is up.
* :class:`LocalWorld` / :class:`LocalGroup`: an N-rank world in one
  process, one thread per rank, with barrier-synchronized collectives.
  It stands in for the reference's multi-process gloo harness and runs
  the same protocol: every object a rank ships is pickled.  With the
  telemetry bus on, its gathers emit one ``sync`` event each, as the JAX
  package's do (``local_all_gather_object``: the rank's pickle times the
  world size; ``local_gather_object``: the rank's pickle).
* :meth:`CollectiveGroup.split`: the sub-group of this rank's part of a
  partition of the ranks (a mesh's reduction over a sub-axis).

Every tensor an object carries travels through the CPU: a metric pickles
its states to the CPU (``Metric.__getstate__``) and comes back on its own
device (``Metric.__setstate__``), and a bare tensor is moved to the CPU
before it is pickled, so a payload never names a device the receiver
must have.

NCCL is not the transport: it runs one rank a GPU, and the object
collectives travel through the CPU anyway.

The serve plane's wire (``serve/cluster.py``): :func:`serve_tag` puts
every serve-plane p2p tag under :data:`SERVE_TAG_NAMESPACE`, and
:func:`pack_frames` / :func:`unpack_frames` frame a routed batch as
length-prefixed arrays, byte for byte the JAX package's format, so a
payload packed by either package unpacks in the other.
"""

from __future__ import annotations

import pickle
import struct
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.telemetry import events as _telemetry

REDUCE_OPS = ("sum", "max", "min", "mean", "concat")


def _dumps(obj: Any) -> bytes:
    # Lazy: the collective substrate sits below the metrics layer.
    from torcheval_tpu_torch.metrics.metric import _to_cpu_tree

    return pickle.dumps(_to_cpu_tree(obj))


def kv_timeout_ms() -> int:
    """The wait budget (ms) of a :class:`TorchProcessGroup` receive given
    no timeout: ``TORCHEVAL_TPU_TORCH_KV_TIMEOUT_MS`` when set (a positive
    integer; anything else raises, so a mistyped deployment fails loudly
    instead of waiting ten minutes), else 600 000.  Read at call time."""
    return _flags.get_int("KV_TIMEOUT_MS")


class PeerTimeoutError(TimeoutError):
    """A point-to-point receive waited past its budget; carries the
    ``peer`` rank it waited for."""

    def __init__(self, peer: int, tag: str, timeout: Optional[float]) -> None:
        self.peer = peer
        self.tag = tag
        self.timeout = timeout
        budget = f" after {timeout:g}s" if timeout is not None else ""
        super().__init__(f"no message from rank {peer} for tag {tag!r}{budget}")


class CollectiveGroup(ABC):
    """Process-group abstraction (reference ``PGWrapper``)."""

    @property
    @abstractmethod
    def rank(self) -> int: ...

    @property
    @abstractmethod
    def world_size(self) -> int: ...

    @property
    def supports_p2p(self) -> bool:
        """Whether :meth:`send_object` / :meth:`recv_object` work here."""
        return False

    def send_object(self, obj: Any, dst: int, tag: str) -> None:
        """Ship one picklable object to rank ``dst`` under ``tag``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no point-to-point object channel."
        )

    def recv_object(self, src: int, tag: str, timeout: Optional[float] = None) -> Any:
        """Receive the object rank ``src`` sent under ``tag``; raises
        :class:`PeerTimeoutError` when nothing arrives within ``timeout``
        seconds (``None``: wait for ever)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no point-to-point object channel."
        )

    @abstractmethod
    def all_gather_object(self, obj: Any) -> List[Any]:
        """Gather one picklable object from every rank; returns the
        world-size list on every rank."""

    @abstractmethod
    def broadcast_object(self, obj: Any, src: int) -> Any:
        """Broadcast ``obj`` from rank ``src``; returns it on every rank."""

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        """Gather one picklable object from every rank to rank ``dst``: the
        world-size list there, ``None`` elsewhere.  This base version
        all-gathers and drops (right results, not the memory bound);
        :class:`LocalGroup` and :class:`TorchProcessGroup` override it
        with a true gather."""
        gathered = self.all_gather_object(obj)
        return gathered if self.rank == dst else None

    def split(self, parts: Sequence[Sequence[int]]) -> "CollectiveGroup":
        """The sub-group of the part of ``parts`` (a partition of this
        group's ranks, each part in the order its sub-group ranks them)
        that holds this rank.  Every rank calls it with the same
        partition, in the same order: a ``torch.distributed`` sub-group is
        made by every rank of the world, members or not."""
        parts = [tuple(int(r) for r in part) for part in parts]
        mine = [part for part in parts if self.rank in part]
        if len(mine) != 1 or sorted(r for p in parts for r in p) != list(range(self.world_size)):
            raise ValueError(f"{parts} is not a partition of the {self.world_size} ranks")
        if mine[0] == tuple(range(self.world_size)):
            return self
        return self._split(parts, mine[0])

    def _split(self, parts: List[tuple], mine: tuple) -> "CollectiveGroup":
        raise NotImplementedError(f"{type(self).__name__} has no sub-groups.")

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Every rank's ``tensor`` reduced with ``op``: ``"sum"``,
        ``"max"``, ``"min"``, ``"mean"`` (the sum over the world size; an
        integer tensor's mean is a float, as JAX's ``pmean``) or
        ``"concat"`` (along dim 0, in rank order).  The one-tensor case of
        :meth:`all_reduce_many`."""
        return self.all_reduce_many([tensor], [op])[0]

    def all_reduce_many(
        self, tensors: Sequence[torch.Tensor], ops: Sequence[str]
    ) -> List[torch.Tensor]:
        """Each tensor reduced with its op (see :meth:`all_reduce`), all in
        ONE collective: the tensors travel together through
        :meth:`all_gather_object` (so through the CPU) and each is folded in
        rank order, ``((t_0 op t_1) op t_2) ...``, on its caller's device.
        Every rank holds the same bits, and they do not change from run to
        run.  Integer tensors stay integer."""
        if len(tensors) != len(ops):
            raise ValueError(f"{len(tensors)} tensors but {len(ops)} reduction ops")
        for op in ops:
            check_reduce_op(op)
        gathered = self.all_gather_object(list(tensors))
        return [
            reduce_gathered([g[i] for g in gathered], op, t.device)
            for i, (t, op) in enumerate(zip(tensors, ops))
        ]


class SingleProcessGroup(CollectiveGroup):
    """The world of one."""

    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    def all_gather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return obj

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        return [obj]


class NullGroup(CollectiveGroup):
    """A group this process is not a member of (world size -1)."""

    @property
    def rank(self) -> int:
        return -1

    @property
    def world_size(self) -> int:
        return -1

    def all_gather_object(self, obj: Any) -> List[Any]:
        raise RuntimeError("Process is not part of this group.")

    def broadcast_object(self, obj: Any, src: int) -> Any:
        raise RuntimeError("Process is not part of this group.")

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        raise RuntimeError("Process is not part of this group.")


class LocalWorld:
    """An N-rank world in one process, for tests and single-host runs.

    ``run(fn)`` executes ``fn(group, rank)`` on one thread per rank;
    collectives synchronize through a barrier, so every rank must enter
    each collective, as in a real world.
    """

    def __init__(self, world_size: int) -> None:
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self._world_size = world_size
        self._barrier = threading.Barrier(world_size)
        self._slots: List[Any] = [None] * world_size
        # Point-to-point mailboxes: (dst, src, tag) -> pickled payload.  No
        # barrier, so a vanished rank cannot hang its peers: receivers time
        # out instead.
        self._mail: dict = {}
        self._mail_cv = threading.Condition()
        # Sub-worlds of a split, by their ranks in order: each rank of a part
        # finds the same one, with its own barrier and mailboxes.
        self._children: Dict[tuple, "LocalWorld"] = {}
        self._children_lock = threading.Lock()

    @property
    def world_size(self) -> int:
        return self._world_size

    def subworld(self, ranks: tuple) -> "LocalWorld":
        """The world of ``ranks`` (in that order) inside this one; the same
        object for every rank that asks."""
        with self._children_lock:
            child = self._children.get(ranks)
            if child is None:
                child = self._children[ranks] = LocalWorld(len(ranks))
            return child

    def abort(self) -> None:
        """Break this world's barrier and every sub-world's, so that no
        rank stays in a collective its peers left."""
        self._barrier.abort()
        with self._children_lock:
            children = list(self._children.values())
        for child in children:
            child.abort()

    def group(self, rank: int) -> "LocalGroup":
        return LocalGroup(self, rank)

    def run(self, fn: Callable[["LocalGroup", int], Any]) -> List[Any]:
        """``[fn(group_r, r) for r in ranks]``, one thread per rank.  The
        first error a rank raises is raised here, after every thread has
        ended (a failing rank breaks the barrier, so its peers end too)."""
        results: List[Any] = [None] * self._world_size
        errors: List[Optional[BaseException]] = [None] * self._world_size

        def target(rank: int) -> None:
            try:
                results[rank] = fn(self.group(rank), rank)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[rank] = e
                self.abort()

        threads = [
            threading.Thread(target=target, args=(r,), daemon=True)
            for r in range(self._world_size)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # The originating error, not the BrokenBarrierErrors it caused.
        real = [
            e
            for e in errors
            if e is not None and not isinstance(e, threading.BrokenBarrierError)
        ]
        if real:
            raise real[0]
        broken = [e for e in errors if e is not None]
        if broken:
            raise broken[0]
        return results


class LocalGroup(CollectiveGroup):
    """One rank's handle into a :class:`LocalWorld`."""

    def __init__(self, world: LocalWorld, rank: int) -> None:
        self._world = world
        self._rank = rank

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world.world_size

    def all_gather_object(self, obj: Any) -> List[Any]:
        t0 = time.monotonic()
        payload = _dumps(obj)
        self._world._slots[self._rank] = payload
        self._world._barrier.wait()
        result = [pickle.loads(p) for p in self._world._slots]
        self._world._barrier.wait()
        if _telemetry.ENABLED:
            _telemetry.record_sync(
                "local_all_gather_object",
                time.monotonic() - t0,
                len(payload) * self.world_size,
            )
        return result

    def broadcast_object(self, obj: Any, src: int) -> Any:
        if self._rank == src:
            self._world._slots[src] = _dumps(obj)
        self._world._barrier.wait()
        result = pickle.loads(self._world._slots[src])
        self._world._barrier.wait()
        return result

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        # A true gather: only the recipient unpickles the world's payloads,
        # so the others' peak memory stays that of their own payload.
        if not 0 <= dst < self.world_size:
            raise ValueError(f"dst must be a rank in [0, {self.world_size}), got {dst}.")
        t0 = time.monotonic()
        payload = _dumps(obj)
        self._world._slots[self._rank] = payload
        self._world._barrier.wait()
        result = (
            [pickle.loads(p) for p in self._world._slots]
            if self._rank == dst
            else None
        )
        self._world._barrier.wait()
        if _telemetry.ENABLED:
            _telemetry.record_sync("local_gather_object", time.monotonic() - t0, len(payload))
        return result

    @property
    def supports_p2p(self) -> bool:
        return True

    def send_object(self, obj: Any, dst: int, tag: str) -> None:
        if not 0 <= dst < self.world_size:
            raise ValueError(f"dst must be a rank in [0, {self.world_size}), got {dst}.")
        # A mailbox put: sending to a rank that never receives cannot block.
        payload = _dumps(obj)
        cv = self._world._mail_cv
        with cv:
            self._world._mail[(dst, self._rank, tag)] = payload
            cv.notify_all()

    def recv_object(self, src: int, tag: str, timeout: Optional[float] = None) -> Any:
        key = (self._rank, src, tag)
        cv = self._world._mail_cv
        deadline = None if timeout is None else time.monotonic() + timeout
        with cv:
            while key not in self._world._mail:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise PeerTimeoutError(src, tag, timeout)
                if not cv.wait(remaining):
                    raise PeerTimeoutError(src, tag, timeout)
            payload = self._world._mail.pop(key)
        return pickle.loads(payload)

    def _split(self, parts: List[tuple], mine: tuple) -> "LocalGroup":
        # A view over this rank's part: a LocalWorld of its own (barrier,
        # slots, mailboxes) that every member finds under the same key.
        return LocalGroup(self._world.subworld(mine), mine.index(self._rank))


def check_reduce_op(op: str) -> None:
    """Raise unless ``op`` is one of :data:`REDUCE_OPS` (before a
    collective, so that every rank raises and none waits)."""
    if op not in REDUCE_OPS:
        raise ValueError(f"Unknown reduction {op!r}; expected one of {sorted(REDUCE_OPS)}")


def reduce_gathered(
    parts: Sequence[torch.Tensor], op: str, device: torch.device
) -> torch.Tensor:
    """Fold the world's gathered tensors with ``op`` on ``device``, in
    the order given (see :meth:`CollectiveGroup.all_reduce_many`)."""
    parts = [p.to(device) for p in parts]
    if op == "concat":
        return torch.cat(parts, dim=0)
    out = parts[0].clone()
    for p in parts[1:]:
        if op in ("sum", "mean"):
            out = out + p
        elif op == "max":
            out = torch.maximum(out, p)
        else:
            out = torch.minimum(out, p)
    return out / len(parts) if op == "mean" else out


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs: Any,
) -> "TorchProcessGroup":
    """Start this process's part of a ``torch.distributed`` world and
    return the world group: ``init_process_group("gloo",
    init_method="tcp://<coordinator_address>", world_size=num_processes,
    rank=process_id, **kwargs)``.  With no address, torch reads
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` from the
    environment.  Idempotent: a repeat call returns a new group over the
    world that is already up instead of raising."""
    import torch.distributed as dist

    if not dist.is_initialized():
        init_method = None
        if coordinator_address is not None:
            init_method = (
                coordinator_address
                if "://" in coordinator_address
                else f"tcp://{coordinator_address}"
            )
        dist.init_process_group(
            "gloo",
            init_method=init_method,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
            **kwargs,
        )
    return TorchProcessGroup()


# torch.distributed sub-groups by their global ranks (a set): every rank
# makes each one once, in the order the meshes ask for them.
_TORCH_SUBGROUPS: Dict[frozenset, Any] = {}
_TORCH_SUBGROUPS_LOCK = threading.Lock()

# One store value may hold 8 MiB (c10d's libuv store); payloads go in 4 MiB
# chunks, and the chunk count is written last.
_STORE_CHUNK = 4 << 20


class TorchProcessGroup(CollectiveGroup):
    """A world of processes over ``torch.distributed`` (the counterpart of
    JAX's ``JaxProcessGroup``): the default group, or with ``pg`` one of
    its sub-groups, whose members are the global ``ranks`` in the order
    this group ranks them.

    Object collectives pickle the object here (its tensors on the CPU) and
    ship the bytes with torch's own ``all_gather_object`` /
    ``broadcast_object_list`` / ``gather_object``.  Tensor reductions keep
    the base class's fold in rank order (never gloo's ``all_reduce``,
    whose order of addition is not the ranks'), so a float sum has the
    same bits as over a :class:`LocalWorld`.

    Point-to-point messages go through the c10d store of the default group
    (a ``TCPStore`` under ``init_method="tcp://..."``): one key a chunk
    plus a count key for each tag and direction, read and deleted by the
    receiver.  A receive polls the store with ``check``: a ``wait`` that
    runs out logs a c10d warning every time and holds the store client's
    lock for its whole budget, which would stall the merge's other
    threads.  A message never claimed leaves its keys behind, so tags must
    be unique per logical message (the fleet merge's carry a round id)."""

    def __init__(self, pg: Any = None, ranks: Optional[Sequence[int]] = None) -> None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "TorchProcessGroup needs a torch.distributed world: call "
                "initialize_multihost() or torch.distributed.init_process_group() first."
            )
        self._dist = dist
        self._pg = pg
        if ranks is None:
            ranks = range(dist.get_world_size())
        self._ranks = tuple(int(r) for r in ranks)
        # The order torch's collectives return a group's objects in.
        self._torch_order = tuple(
            dist.get_process_group_ranks(pg) if pg is not None else range(dist.get_world_size())
        )
        self._me = dist.get_rank()
        if self._me not in self._ranks:
            raise ValueError(f"global rank {self._me} is not in {self._ranks}")
        # A sub-group's (or a reordered world's) messages live apart from
        # the world's, under its members in order.
        whole = self._ranks == tuple(range(dist.get_world_size()))
        self._ns = "" if whole else "/".join(map(str, self._ranks)) + "/"

    @property
    def rank(self) -> int:
        return self._ranks.index(self._me)

    @property
    def world_size(self) -> int:
        return len(self._ranks)

    def _in_order(self, by_torch: Sequence[Any]) -> List[Any]:
        placed = dict(zip(self._torch_order, by_torch))
        return [placed[r] for r in self._ranks]

    def all_gather_object(self, obj: Any) -> List[Any]:
        t0 = time.monotonic()
        out: List[Any] = [None] * self.world_size
        self._dist.all_gather_object(out, _dumps(obj), group=self._pg)
        payloads = self._in_order(out)
        if _telemetry.ENABLED:
            _telemetry.record_sync(
                "all_gather_bytes", time.monotonic() - t0, sum(len(p) for p in payloads)
            )
        return [pickle.loads(p) for p in payloads]

    def broadcast_object(self, obj: Any, src: int) -> Any:
        box = [_dumps(obj) if self.rank == src else None]
        self._dist.broadcast_object_list(box, src=self._ranks[src], group=self._pg)
        return pickle.loads(box[0])

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        if not 0 <= dst < self.world_size:
            raise ValueError(f"dst must be a rank in [0, {self.world_size}), got {dst}.")
        t0 = time.monotonic()
        payload = _dumps(obj)
        out = [None] * self.world_size if self.rank == dst else None
        self._dist.gather_object(payload, out, dst=self._ranks[dst], group=self._pg)
        if _telemetry.ENABLED:
            _telemetry.record_sync("gather_object", time.monotonic() - t0, len(payload))
        if out is None:
            return None
        return [pickle.loads(p) for p in self._in_order(out)]

    # ------------------------------------------------------------ p2p
    def _store(self) -> Any:
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()

    @property
    def supports_p2p(self) -> bool:
        return True  # every torch.distributed world holds a store

    def _key(self, tag: str, src: int, dst: int) -> str:
        return f"torcheval_tpu_torch/p2p/{self._ns}{tag}/{self._ranks[src]}->{self._ranks[dst]}"

    def send_object(self, obj: Any, dst: int, tag: str) -> None:
        if not 0 <= dst < self.world_size:
            raise ValueError(f"dst must be a rank in [0, {self.world_size}), got {dst}.")
        store = self._store()
        prefix = self._key(tag, self.rank, dst)
        payload = _dumps(obj)
        chunks = [payload[i : i + _STORE_CHUNK] for i in range(0, max(len(payload), 1), _STORE_CHUNK)]
        for i, chunk in enumerate(chunks):
            store.set(f"{prefix}/{i}", chunk)
        store.set(f"{prefix}/n", str(len(chunks)))

    def recv_object(self, src: int, tag: str, timeout: Optional[float] = None) -> Any:
        """The object rank ``src`` sent under ``tag``; ``timeout=None``
        waits :func:`kv_timeout_ms`.  Raises :class:`PeerTimeoutError`
        when nothing arrives in time."""
        store = self._store()
        prefix = self._key(tag, src, self.rank)
        budget = kv_timeout_ms() / 1e3 if timeout is None else float(timeout)
        deadline = time.monotonic() + budget
        pause = 0.0005
        try:
            while not store.check([f"{prefix}/n"]):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PeerTimeoutError(src, tag, timeout)
                time.sleep(min(pause, remaining))
                pause = min(2 * pause, 0.005)
            n = int(store.get(f"{prefix}/n"))
            payload = b"".join(store.get(f"{prefix}/{i}") for i in range(n))
        except PeerTimeoutError:
            raise
        except Exception as exc:  # noqa: BLE001 - the store's errors, attributed to src
            raise PeerTimeoutError(src, tag, timeout) from exc
        for i in range(n):
            store.delete_key(f"{prefix}/{i}")
        store.delete_key(f"{prefix}/n")
        return pickle.loads(payload)

    def _split(self, parts: List[tuple], mine: tuple) -> "TorchProcessGroup":
        # Every rank of the world enters new_group for every part, in order.
        for part in parts:
            members = tuple(self._ranks[r] for r in part)
            if len(part) == self.world_size:
                pg = self._pg
            else:
                with _TORCH_SUBGROUPS_LOCK:
                    pg = _TORCH_SUBGROUPS.get(frozenset(members))
                    if pg is None:
                        pg = self._dist.new_group(sorted(members))
                        _TORCH_SUBGROUPS[frozenset(members)] = pg
            if part == mine:
                sub = TorchProcessGroup(pg, members)
        return sub


# --------------------------------------------------------------------------
# Serve-plane tag namespace.
#
# Both p2p transports key undelivered messages by (dst, src, tag): the
# LocalWorld mailbox dict and the TorchProcessGroup store alike, so two
# protocols sharing a group must not mint the same tag.  The hierarchical
# merge derives its tags from a round id (``fm{round}/...``,
# ``parallel/fleet_merge.py``); the serve cluster's traffic is long-lived
# and round-free, so every serve-plane tag goes through ``serve_tag()``
# and lives under this prefix.  A concurrent fleet_merge round and a
# migration on the same group then never cross-deliver envelopes.
SERVE_TAG_NAMESPACE = "serve/"


def serve_tag(tag: str) -> str:
    """Namespace a serve-plane p2p tag under :data:`SERVE_TAG_NAMESPACE`.
    Idempotent; the cluster routes every send/recv through here so no
    raw serve tag can collide with another protocol's."""
    if tag.startswith(SERVE_TAG_NAMESPACE):
        return tag
    return SERVE_TAG_NAMESPACE + tag


# --------------------------------------------------------------------------
# Length-prefixed array framing for the serve plane's cross-host batches.
#
# A routed submit must not become Python object soup on the hot path: the
# sender flattens the batch (positional arrays + array keywords) into ONE
# contiguous bytes payload of length-prefixed frames, and the receiver
# reassembles numpy views with ``np.frombuffer``: zero copies on unpack.
# The layout is the JAX package's: magic ``TEF1``, ``<HH`` counts, then one
# frame an array (positional ones named by index, keywords sorted by name):
# ``<H`` name length, name, ``<H`` dtype length, numpy dtype string, ``<B``
# ndim, ``<Q`` a dimension, ``<Q`` byte count, the C-order bytes.

_FRAME_MAGIC = b"TEF1"


def _host_array(value: Any) -> np.ndarray:
    """``value`` as a C-contiguous numpy array; a tensor (on any device)
    is pulled to the host first.  A tensor dtype numpy has no counterpart
    for (``torch.bfloat16``) raises ``TypeError``: the JAX package would
    frame ml_dtypes' ``<V2``, which does not round-trip."""
    if isinstance(value, torch.Tensor):
        try:
            value = value.detach().cpu().numpy()
        except TypeError as exc:
            raise TypeError(
                f"pack_frames cannot frame a {value.dtype} tensor: numpy has no "
                f"{value.dtype} dtype; cast it first (e.g. .float())"
            ) from exc
    return np.ascontiguousarray(np.asarray(value))


def _frame_array(name: str, value: Any) -> bytes:
    arr = _host_array(value)
    name_b = name.encode("utf-8")
    dtype_b = arr.dtype.str.encode("ascii")
    head = struct.pack(
        f"<H{len(name_b)}sH{len(dtype_b)}sB",
        len(name_b),
        name_b,
        len(dtype_b),
        dtype_b,
        arr.ndim,
    )
    shape = struct.pack(f"<{arr.ndim}Q", *arr.shape)
    body = arr.tobytes()
    return head + shape + struct.pack("<Q", len(body)) + body


def pack_frames(args: Any = (), kwargs: Optional[dict] = None) -> bytes:
    """Serialize positional arrays and array keywords into one framed
    bytes payload (tensors on any device are pulled to the host first)."""
    args = tuple(args)
    kwargs = dict(kwargs or {})
    out = [_FRAME_MAGIC, struct.pack("<HH", len(args), len(kwargs))]
    for i, value in enumerate(args):
        out.append(_frame_array(str(i), value))
    for name in sorted(kwargs):
        out.append(_frame_array(name, kwargs[name]))
    return b"".join(out)


def unpack_frames(payload: bytes) -> tuple:
    """Inverse of :func:`pack_frames`: ``(args, kwargs)`` of numpy arrays
    built as zero-copy views over the payload buffer (read-only views when
    ``payload`` is ``bytes``)."""
    view = memoryview(payload)
    if bytes(view[:4]) != _FRAME_MAGIC:
        raise ValueError("not a framed batch payload (bad magic)")
    npos, nkw = struct.unpack_from("<HH", view, 4)
    off = 8
    frames = []
    for _ in range(npos + nkw):
        (name_len,) = struct.unpack_from("<H", view, off)
        off += 2
        name = bytes(view[off : off + name_len]).decode("utf-8")
        off += name_len
        (dtype_len,) = struct.unpack_from("<H", view, off)
        off += 2
        dtype = np.dtype(bytes(view[off : off + dtype_len]).decode("ascii"))
        off += dtype_len
        (ndim,) = struct.unpack_from("<B", view, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}Q", view, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", view, off)
        off += 8
        arr = np.frombuffer(view[off : off + nbytes], dtype=dtype).reshape(shape)
        off += nbytes
        frames.append((name, arr))
    args = tuple(arr for _, arr in frames[:npos])
    kwargs = {name: arr for name, arr in frames[npos:]}
    return args, kwargs


def default_group() -> CollectiveGroup:
    """The world group: a :class:`TorchProcessGroup` when a
    ``torch.distributed`` world of more than one process is up, else the
    single-process group.  Pass a :class:`LocalGroup` (or any
    :class:`CollectiveGroup`) to sync across the ranks of one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return TorchProcessGroup()
    return SingleProcessGroup()


__all__ = (
    "REDUCE_OPS",
    "SERVE_TAG_NAMESPACE",
    "CollectiveGroup",
    "LocalGroup",
    "LocalWorld",
    "NullGroup",
    "PeerTimeoutError",
    "SingleProcessGroup",
    "TorchProcessGroup",
    "default_group",
    "initialize_multihost",
    "kv_timeout_ms",
    "pack_frames",
    "serve_tag",
    "unpack_frames",
)
