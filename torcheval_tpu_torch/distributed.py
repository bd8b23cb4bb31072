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
* :class:`LocalWorld` / :class:`LocalGroup`: an N-rank world in one
  process, one thread per rank, with barrier-synchronized collectives.
  It stands in for the reference's multi-process gloo harness and runs
  the same protocol: every object a rank ships is pickled.  With the
  telemetry bus on, its gathers emit one ``sync`` event each, as the JAX
  package's do (``local_all_gather_object``: the rank's pickle times the
  world size; ``local_gather_object``: the rank's pickle).

Every tensor an object carries travels through the CPU: a metric pickles
its states to the CPU (``Metric.__getstate__``) and comes back on its own
device (``Metric.__setstate__``), and a bare tensor is moved to the CPU
before it is pickled, so a payload never names a device the receiver
must have.

Not ported yet: ``JaxProcessGroup`` and ``initialize_multihost`` (their
counterpart is a ``torch.distributed`` group, which comes with the
process-group slice, ROADMAP queue 1 item 6) and ``pack_frames`` /
``unpack_frames`` (with the fleet merge).  :func:`default_group` is therefore the single-process
group.
"""

from __future__ import annotations

import pickle
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Callable, List, Optional, Sequence

import torch

from torcheval_tpu_torch.metrics.metric import _to_cpu_tree
from torcheval_tpu_torch.telemetry import events as _telemetry

REDUCE_OPS = ("sum", "max", "min", "mean", "concat")


def _dumps(obj: Any) -> bytes:
    return pickle.dumps(_to_cpu_tree(obj))


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
        :class:`LocalGroup` overrides it with a true gather."""
        gathered = self.all_gather_object(obj)
        return gathered if self.rank == dst else None

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

    @property
    def world_size(self) -> int:
        return self._world_size

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
                self._barrier.abort()

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


def default_group() -> CollectiveGroup:
    """The world group.  Until the port's ``torch.distributed`` group
    lands, that is the single-process group; pass a :class:`LocalGroup`
    (or any :class:`CollectiveGroup`) to sync across ranks."""
    return SingleProcessGroup()


__all__ = (
    "REDUCE_OPS",
    "CollectiveGroup",
    "LocalGroup",
    "LocalWorld",
    "NullGroup",
    "PeerTimeoutError",
    "SingleProcessGroup",
    "default_group",
)
