"""Streaming evaluation engine (the port of ``torcheval_tpu/engine``).

``MetricCollection.fused_update`` counts every supported member in one
pass of the collection kernel, but a stream of N batches is still N host
round trips of launches.  :class:`Evaluator` consumes a stream of
batches, stacks ``block_size`` of them on a leading axis, and dispatches
each block as ONE replay of a captured CUDA graph (``engine/scan.py``),
so N batches cost O(N / block_size) host dispatches.  A background thread
(``engine/prefetch.py``) assembles the next block in pinned host memory
and copies it to the card on a copy stream while the current one replays.

Ragged streams ride the same power-of-two bucketing as
``MetricCollection(bucket=True)``: every batch in a block is padded to
the block's largest bucket with a validity mask (padded rows count
nothing), and a partial tail block is padded to ``block_size`` steps with
fully masked pad steps, so the states are bit-identical to a per-batch
``fused_update`` loop over the same stream, at any stream length.  With
``bucket=False`` every batch in a block must share one exact shape; a
partial or shape-mismatched tail goes through per-batch ``fused_update``
(still bit-identical).  Batches that are CUDA tensors are stacked on the
card; numpy batches (or CPU tensors) are stacked on the host.  On a
collection built with ``device="cpu"`` the blocks run eagerly, step by
step, which is the plain version the tests hold against the JAX engine.

Example::

    from torcheval_tpu_torch.engine import Evaluator

    ev = Evaluator(col, block_size=8)
    ev.warmup((scores0, target0), max_batch=4096)  # or aot.warmup(ev, ...)
    results = ev.run(stream).result()

Telemetry (when enabled): an ``Evaluator.engine_block`` span and an
``engine_block`` counter event per dispatched block, an
``Evaluator.prefetch_wait`` span per consumed block, and a
``prefetch_stall`` counter when the dispatch loop outran the prefetch
thread, all in ``telemetry.report()``'s ``engine`` section
(``dispatches_per_batch`` is the O(N / block) claim, measured).
:meth:`Evaluator.start_fleet_merge` runs a fleet merge of a snapshot
beside further blocks.  With perfscope on, each block's program is priced
once a signature (``engine/scan.py``) and the installed SLO rules run every
``SLO_EVERY_BLOCKS`` dispatched blocks (``telemetry/perfscope.py``).
"""

import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.engine.prefetch import DEFAULT_DEPTH, Prefetcher
from torcheval_tpu_torch.engine.scan import ScanRunner, resolve_donate, states_nbytes
from torcheval_tpu_torch.metrics._bucket import bucket_size, bucket_sizes, pad_to_bucket
from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.ops import _mega_plan
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.resilience.checkpoint import CheckpointManager
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import flightrec as _flightrec
from torcheval_tpu_torch.telemetry import health as _health
from torcheval_tpu_torch.telemetry import perfscope as _perfscope
from torcheval_tpu_torch.telemetry import trace as _trace

__all__ = ["Evaluator", "Prefetcher", "ScanRunner"]

DEFAULT_BLOCK_SIZE = 8


class _Block(NamedTuple):
    """One unit of dispatch: a stacked block (``args`` carry a leading
    ``block_size`` axis) or a per-batch tail.  ``slot`` is the pinned ring
    slot a host-stacked block for the card was assembled in; ``ready`` the
    CUDA event its staging recorded on the copy stream."""

    args: Tuple[Any, ...]
    mask: Optional[Any]
    batches: int
    pad_steps: int
    perbatch: Tuple[Tuple[Any, ...], ...]
    ready: Optional[Any] = None
    slot: Optional[List[Any]] = None


def _block_rows(
    sizes: List[int], lead: Tuple[int, int], bucketed: bool, device: Any
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """On ``device``: the source row of every row of a block whose batches
    (of ``sizes`` rows) are concatenated, and its int32 validity mask
    (``None`` unbucketed).  A batch's pad rows repeat its last row, an
    empty batch reads the zero row past the end, and the tail's pad steps
    repeat step 0 under an all-zero mask, as :meth:`Evaluator._fill`
    writes them.  Only a (3, steps) table crosses from the host."""
    steps, bucket = lead
    n = np.zeros(steps, np.int64)
    n[: len(sizes)] = sizes
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    base = np.full(steps, start[0] if sizes[0] else sum(sizes), np.int64)
    base[: len(sizes)] = np.where(n[: len(sizes)] > 0, start, sum(sizes))
    last = np.full(steps, max(sizes[0] - 1, 0), np.int64)
    last[: len(sizes)] = np.maximum(n[: len(sizes)] - 1, 0)
    table = torch.from_numpy(np.stack([base, last, n])).to(device)
    cols = torch.arange(bucket, device=device)
    rows = table[0, :, None] + torch.minimum(cols[None, :], table[1, :, None])
    mask = (cols[None, :] < table[2, :, None]).to(torch.int32) if bucketed else None
    return rows.reshape(-1), mask


def _dtype_name(a: Any) -> str:
    return str(a.dtype).replace("torch.", "")


class _PinnedRing:
    """Pinned host buffers for stacked blocks, reused in turn: a slot is
    written again only after the copy that read it has finished."""

    def __init__(self, slots: int) -> None:
        self._slots = slots
        self._rings: Dict[Any, List[List[Any]]] = {}
        self._next: Dict[Any, int] = {}

    def take(self, specs: Tuple[Tuple[Tuple[int, ...], np.dtype], ...]) -> List[Any]:
        """A slot for arrays of these (shape, dtype): ``[tensors, event]``."""
        ring = self._rings.get(specs)
        if ring is None:
            ring = self._rings[specs] = []
            self._next[specs] = 0
        i = self._next[specs]
        self._next[specs] = (i + 1) % self._slots
        if i == len(ring):
            tensors = tuple(
                torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                            pin_memory=True)
                for shape, dt in specs
            )
            ring.append([tensors, None])
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()  # the last copy out of this slot is done
            slot[1] = None
        return slot


class Evaluator:
    """Drive a :class:`MetricCollection` over a batch stream in blocks,
    each one replay of a captured CUDA graph, with double-buffered
    prefetch.

    ``block_size`` batches share one host dispatch; larger blocks amortize
    more but delay periodic snapshots and raise the stacked block's device
    footprint (``block_size x bucket x row_bytes``).  ``bucket=None``
    inherits the collection's bucketing; bucketed mode requires mask-aware
    members.  ``donate=None`` follows the collection: donated, the members
    keep the same state tensors across blocks, written in place.
    ``snapshot_every=K`` computes the collection every K blocks
    (``on_snapshot(blocks, values)``; also kept on ``.snapshots`` /
    ``.last_snapshot``).

    ``checkpoint_dir`` makes the eval durable: every
    ``checkpoint_every_blocks`` dispatched blocks, the collection's
    ``state_dict()`` plus the stream cursor (batches consumed, blocks
    dispatched) is written atomically through
    :class:`~torcheval_tpu_torch.resilience.CheckpointManager`, and a NEW
    ``Evaluator`` over the same directory resumes from the newest valid
    generation: already-consumed batches are skipped on replay, and the
    final ``compute()`` is bit-identical to an uninterrupted run.

    ``step``/``flush``/``run`` must not be called concurrently; the
    prefetch thread only runs the engine's own block assembly.
    """

    def __init__(
        self,
        collection: MetricCollection,
        *,
        block_size: int = DEFAULT_BLOCK_SIZE,
        bucket: Optional[bool] = None,
        donate: Optional[bool] = None,
        prefetch: bool = True,
        prefetch_depth: int = DEFAULT_DEPTH,
        snapshot_every: Optional[int] = None,
        on_snapshot: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_blocks: Optional[int] = None,
        checkpoint_keep: int = 2,
    ) -> None:
        if not isinstance(collection, MetricCollection):
            raise TypeError(
                f"Evaluator drives a MetricCollection, got {type(collection).__name__}."
            )
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if snapshot_every is not None and int(snapshot_every) < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
        self._collection = collection
        self._block_size = int(block_size)
        self._bucket = collection._bucket if bucket is None else bool(bucket)
        if self._bucket:
            for name, m in collection.items():
                if not m._supports_mask:
                    raise ValueError(
                        f"bucket=True requires mask-aware members; "
                        f"{name}={type(m).__name__} does not support "
                        "update(..., mask=)."
                    )
        self._min_bucket = collection._min_bucket
        # Fail fast: a block has fused_update's requirements (tensor
        # states, no ring windows).
        collection._check_fusable()
        self._device = collection.device
        self._donate = donate
        self._prefetch = bool(prefetch)
        self._prefetch_depth = int(prefetch_depth)
        self._snapshot_every = int(snapshot_every) if snapshot_every is not None else None
        self._on_snapshot = on_snapshot
        self._runner: Optional[ScanRunner] = None
        self._pending: List[Tuple[Any, ...]] = []
        self._pending_key: Optional[Any] = None
        # Staging on the card: the copy stream, the pinned ring, and the
        # stream the dispatching thread works on (set by step/run).
        self._copy_stream: Optional[Any] = None
        self._dispatch_stream: Optional[Any] = None
        self._ring = _PinnedRing(self._prefetch_depth + 1)
        self.blocks_dispatched = 0
        self.batches_seen = 0
        self.snapshots: List[Dict[str, Any]] = []
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self._last_snap_at = 0
        # Causal tracing: one root trace per evaluator, a child span per
        # dispatched block.
        self._trace_ctx: Optional[_trace.TraceContext] = None
        self._last_block_span = ""

        # -- durable checkpoint/resume (resilience/) ----------------------
        if checkpoint_every_blocks is not None:
            if checkpoint_dir is None:
                raise ValueError("checkpoint_every_blocks requires checkpoint_dir.")
            if int(checkpoint_every_blocks) < 1:
                raise ValueError(
                    f"checkpoint_every_blocks must be >= 1, got {checkpoint_every_blocks}"
                )
        self._ckpt: Optional[CheckpointManager] = None
        self._ckpt_every = (
            int(checkpoint_every_blocks) if checkpoint_every_blocks is not None else None
        )
        self._resume_skip = 0
        self._stream_position = 0
        self._last_ckpt_blocks = 0
        self.resumed_from: Optional[str] = None
        if checkpoint_dir is not None:
            self._ckpt = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
            resumed = self._ckpt.load_latest()
            if resumed is not None:
                # Checkpoints hold host numpy in the JAX package's layout;
                # load_state_dict puts them on the members' device.  Lazy:
                # ``convert`` sits in the tools layer above the engine.
                from torcheval_tpu_torch import convert

                collection.load_state_dict(convert.state_from_jax(resumed.state))
                self.batches_seen = int(resumed.cursor.get("batches_seen", 0))
                self.blocks_dispatched = int(resumed.cursor.get("blocks_dispatched", 0))
                self._resume_skip = self.batches_seen
                self._last_ckpt_blocks = self.blocks_dispatched
                self.resumed_from = resumed.path

    # ------------------------------------------------------------ lifecycle
    @property
    def collection(self) -> MetricCollection:
        return self._collection

    @property
    def runner(self) -> Optional[ScanRunner]:
        """The current block runner (its ``captures`` and ``replays``)."""
        return self._runner

    def step(self, *args: Any) -> "Evaluator":
        """Buffer one batch (positional update args, e.g. ``(scores,
        target)``); dispatches once ``block_size`` batches are buffered (or
        the batch signature changes).  For a sliced collection the LAST
        positional is the batch's per-row slice-id vector."""
        if not args:
            raise ValueError("step() needs at least one batch array.")
        self._bind_streams()
        batch = self._admit(args)
        if batch is None:
            return self
        for block in self._push(batch):
            self._dispatch(self._stage_block(block))
        return self

    def _trace_root(self) -> Optional["_trace.TraceContext"]:
        """The evaluator's persistent root trace context (created on first
        traced use; None while tracing is off)."""
        if _trace.ENABLED:
            if self._trace_ctx is None:
                self._trace_ctx = _trace.root("evaluator")
                if _telemetry.ENABLED:
                    with _trace.activate(self._trace_ctx):
                        _telemetry.record_span("evaluator", "Evaluator", 0.0, 0)
        return self._trace_ctx

    def run(self, stream: Iterable[Any]) -> "Evaluator":
        """Consume an iterable of batches (tuples of update args, or single
        arrays) through the pipelined block loop.  Batches buffered by
        earlier :meth:`step` calls join the stream's first block, in order.

        With the flight recorder on, an exception escaping the loop dumps a
        post-mortem bundle before propagating; with tracing on the whole
        run is one span under the evaluator's root trace."""
        try:
            if _trace.ENABLED:
                with _trace.activate(self._trace_root()):
                    with _trace.span("evaluator.run"):
                        t0 = time.monotonic()
                        try:
                            return self._run_impl(stream)
                        finally:
                            if _telemetry.ENABLED:
                                _telemetry.record_span(
                                    "evaluator.run", "Evaluator", time.monotonic() - t0, 0
                                )
            return self._run_impl(stream)
        except BaseException as exc:  # noqa: B036 - rethrown below
            if _flightrec.ENABLED:
                _flightrec.trigger("unhandled_exception", f"{type(exc).__name__}: {exc}")
            raise

    def _run_impl(self, stream: Iterable[Any]) -> "Evaluator":
        self._bind_streams()
        blocks = self._block_stream(iter(stream))
        if self._prefetch:
            prefetcher = Prefetcher(blocks, stage=self._stage_block, depth=self._prefetch_depth)
            try:
                for block in prefetcher:
                    self._dispatch(block)
            finally:
                prefetcher.close()
        else:
            for block in blocks:
                self._dispatch(self._stage_block(block))
        return self

    def flush(self) -> "Evaluator":
        """Dispatch any buffered partial block now."""
        if self._pending:
            self._bind_streams()
            self._dispatch(self._stage_block(self._make_block()))
        return self

    def result(self) -> Dict[str, Any]:
        """Flush, then the collection's computed values."""
        self.flush()
        return self._collection.compute()

    def start_fleet_merge(
        self,
        group: Any,
        *,
        topology: str = "tree",
        sketch: Optional[str] = None,
        sketch_options: Optional[Dict[str, Any]] = None,
        recipient: Any = None,
        policy: Any = None,
        membership: Any = None,
    ) -> Any:
        """Overlap a fleet merge with further eval work.

        Flushes any buffered partial block, snapshots the collection, and
        runs :func:`torcheval_tpu_torch.parallel.fleet_merge.fleet_merge`
        over the snapshot on a daemon thread, while the caller keeps
        feeding :meth:`step` / :meth:`run`.  Returns a
        :class:`~torcheval_tpu_torch.parallel.fleet_merge.PendingMerge`;
        ``.result()`` joins and gives the ``MergeOutcome`` (a lost rank
        makes it partial; it never raises into the eval loop).

        On the card the snapshot is taken on this thread: its copies wait
        for the engine's last replay on the dispatching stream and are
        finished before the merge thread starts, so the merge never reads
        a state that a later block is still writing."""
        from copy import deepcopy

        from torcheval_tpu_torch.parallel.fleet_merge import PendingMerge, fleet_merge

        self.flush()
        on_card = self._device.type == "cuda"
        if on_card and self._dispatch_stream is not None:
            torch.cuda.current_stream(self._device).wait_stream(self._dispatch_stream)
        snapshot = deepcopy(self._collection)
        if on_card:
            torch.cuda.current_stream(self._device).synchronize()
        kwargs = {
            "topology": topology,
            "sketch": sketch,
            "sketch_options": sketch_options,
            "recipient": recipient,
            "policy": policy,
            "membership": membership,
        }
        if _trace.ENABLED:
            # Parent the merge's trace on the engine block that dispatched
            # last: the link from "a merge level degraded" back to the
            # block that scheduled it.
            base = _trace.current() or self._trace_root()
            if self._last_block_span:
                base = _trace.TraceContext(trace_id=base.trace_id, span_id=self._last_block_span)
            with _trace.activate(base):
                return PendingMerge(fleet_merge, (snapshot, group), kwargs)
        return PendingMerge(fleet_merge, (snapshot, group), kwargs)

    def warmup(
        self,
        example_batch: Iterable[Any],
        *,
        max_batch: Optional[int] = None,
        sizes: Optional[Iterable[int]] = None,
    ) -> Tuple[int, ...]:
        """Capture the block program of every bucket shape the stream can
        reach (cf. :func:`torcheval_tpu_torch.aot.warmup`, which delegates
        here for an ``Evaluator``), so the stream itself captures nothing
        and builds nothing.  State is snapshotted and restored, so warmup
        is invisible to metric values and to the dispatch counters.
        Returns the warmed batch sizes."""
        from torcheval_tpu_torch.aot import _tile_to

        arrays = list(example_batch)
        if not arrays:
            raise ValueError("example_batch must contain at least one array.")
        n = arrays[0].shape[0]
        top = int(max_batch) if max_batch is not None else n
        if sizes is not None:
            sweep = tuple(int(s) for s in sizes)
        elif self._bucket:
            sweep = bucket_sizes(top, min_bucket=self._min_bucket)
        else:
            sweep = (top,)
        snapshot = self._collection.state_dict()
        runner = self._ensure_runner()
        try:
            for b in sweep:
                step_args = tuple(
                    torch.as_tensor(_tile_to(a, b), device=self._device) for a in arrays
                )
                if self._bucket:
                    step_args, mask = pad_to_bucket(*step_args, min_bucket=b)
                    stacked_mask = torch.stack([mask] * self._block_size)
                else:
                    stacked_mask = None
                stacked = tuple(torch.stack([a] * self._block_size) for a in step_args)
                runner.dispatch(stacked, stacked_mask)
        finally:
            self._collection.load_state_dict(snapshot)
        return tuple(sweep)

    # ------------------------------------------------------ block assembly
    def _bind_streams(self) -> None:
        """Note the dispatching thread's stream (CUDA batches are read on
        the copy stream after it) and make the copy stream once."""
        if self._device.type == "cuda":
            self._dispatch_stream = torch.cuda.current_stream(self._device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self._device)

    def _admit(self, args: Tuple[Any, ...]) -> Optional[Tuple[Any, ...]]:
        """Count one incoming batch against the resume cursor.  Returns the
        normalized batch, or ``None`` while the replayed stream is still
        inside the already-checkpointed prefix."""
        self._stream_position += 1
        if self._stream_position <= self._resume_skip:
            return None
        return self._normalize(args)

    def _normalize(self, args: Tuple[Any, ...]) -> Tuple[Any, ...]:
        # A CUDA tensor for a collection on the card stays where it is;
        # anything else is host data (numpy) until its block is staged.
        on_card = self._device.type == "cuda"
        out = []
        for a in args:
            if isinstance(a, torch.Tensor):
                if not (on_card and a.device.type == "cuda"):
                    a = a.detach().cpu().numpy()
            else:
                a = np.asarray(a)
            out.append(a)
        args = tuple(out)
        if self._collection._slices is not None and len(args) < 2:
            raise ValueError(
                f"The collection is sliced (slices={self._collection._slices}); each "
                "batch must carry its per-row slice-id vector as the last positional arg."
            )
        if _faults.ENABLED:
            # Chaos site "engine.batch": a corrupt rule pokes a NaN into the
            # batch so the data-health monitor has a real finding.
            rule = _faults.fire("engine.batch", batch=self._stream_position)
            if rule is not None and rule.action == "corrupt":
                args = _faults.corrupt_batch(args)
        return args

    def _batch_key(self, args: Tuple[Any, ...]) -> Any:
        # Bucketed blocks share a dispatch across leading-dim raggedness
        # (padding absorbs it); unbucketed blocks need the exact shape.
        if self._bucket:
            return tuple((tuple(a.shape[1:]), _dtype_name(a)) for a in args)
        return tuple((tuple(a.shape), _dtype_name(a)) for a in args)

    def _push(self, args: Tuple[Any, ...]) -> List[_Block]:
        ready: List[_Block] = []
        key = self._batch_key(args)
        if self._pending and key != self._pending_key:
            ready.append(self._make_block())
        self._pending.append(args)
        self._pending_key = key
        if len(self._pending) >= self._block_size:
            ready.append(self._make_block())
        return ready

    def _make_block(self) -> _Block:
        pending, self._pending = self._pending, []
        self._pending_key = None
        count = len(pending)
        if not self._bucket and count < self._block_size:
            # Exact-shape mode cannot mask pad steps away; the ragged tail
            # stays bit-identical through per-batch fused_update.
            return _Block((), None, count, 0, tuple(pending))
        sizes = [int(batch[0].shape[0]) for batch in pending]
        lead = (
            self._block_size,
            bucket_size(max(sizes), min_bucket=self._min_bucket) if self._bucket else sizes[0],
        )
        if any(isinstance(a, torch.Tensor) for batch in pending for a in batch):
            return self._make_block_on_card(pending, lead)
        specs = tuple((lead + a.shape[1:], a.dtype) for a in pending[0])
        if self._bucket:
            specs += ((lead, np.dtype(np.int32)),)
        nargs = len(pending[0])
        slot = None
        if self._device.type == "cuda":
            slot = self._ring.take(specs)
            arrays = [t.numpy() for t in slot[0]]
        else:
            arrays = [np.empty(shape, dt) for shape, dt in specs]
        self._fill(arrays[:nargs], arrays[nargs] if self._bucket else None, pending)
        tensors = slot[0] if slot is not None else tuple(torch.from_numpy(a) for a in arrays)
        return _Block(tensors[:nargs], tensors[nargs] if self._bucket else None,
                      count, self._block_size - count, (), slot=slot)

    def _make_block_on_card(self, pending: List[Tuple[Any, ...]], lead) -> _Block:
        """Stack a block whose batches are CUDA tensors on the card, on the
        copy stream (after the dispatching stream's work that made them):
        each argument's batches concatenated, then its rows picked by one
        index (:func:`_block_rows`), so a block is a few launches whatever
        its batch count."""
        sizes = [int(batch[0].shape[0]) for batch in pending]
        if self._bucket and _telemetry.ENABLED:
            for n in sizes:
                _telemetry.record_bucket_pad(lead[1], n, lead[1] - n)
        stream = self._copy_stream
        stream.wait_stream(self._dispatch_stream)
        with torch.cuda.stream(stream):
            rows, mask = _block_rows(sizes, lead, self._bucket, self._device)
            # A full block of full batches is its concatenation as it is.
            index = None if sizes == [lead[1]] * lead[0] else rows
            stacked = []
            for j in range(len(pending[0])):
                parts = [torch.as_tensor(batch[j], device=self._device) for batch in pending]
                for part in parts:
                    part.record_stream(stream)
                if 0 in sizes:  # an empty batch's rows read one zero row
                    parts.append(parts[0].new_zeros((1,) + tuple(parts[0].shape[1:])))
                whole = torch.cat(parts)
                if index is not None:
                    whole = whole.index_select(0, index)
                stacked.append(whole.view(lead + tuple(whole.shape[1:])))
            ready = torch.cuda.Event()
            ready.record(stream)
        return _Block(tuple(stacked), mask, len(pending), self._block_size - len(pending),
                      (), ready)

    def _fill(self, stacked, mask, batches) -> None:
        """Write host batches into a block's numpy arrays.  Padding mirrors
        pad_to_bucket exactly (edge-replicated rows, an int32 1/0 validity
        mask), and the tail's pad steps repeat step 0
        under an all-zero mask, so results stay bit-identical to the
        per-batch path.  ``mask`` is ``None`` for an unbucketed block."""
        if mask is not None:
            mask[:] = 0
        bucket = stacked[0].shape[1]
        for i, batch in enumerate(batches):
            n = int(batch[0].shape[0])
            for dst, src in zip(stacked, batch):
                dst[i, :n] = src
                if mask is not None:
                    # Edge-replicate the last valid row (class indices stay
                    # in range for the members' own paths).
                    dst[i, n:] = src[-1:] if n else 0
            if mask is not None:
                mask[i, :n] = 1
                if _telemetry.ENABLED:
                    _telemetry.record_bucket_pad(bucket, n, bucket - n)
        for i in range(len(batches), self._block_size):
            for dst in stacked:
                dst[i] = dst[0]

    def _block_stream(self, it) -> Iterable[_Block]:
        for batch in it:
            args = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
            admitted = self._admit(args)
            if admitted is None:
                continue
            yield from self._push(admitted)
        if self._pending:
            yield self._make_block()

    def _stage_block(self, block: _Block) -> _Block:
        """Put a host-stacked block on the card: one non-blocking copy of
        each pinned buffer on the copy stream, then an event the dispatch
        waits on.  Blocks stacked on the card, per-batch tails (which
        ``fused_update`` places) and CPU blocks pass through."""
        if block.slot is None:
            return block
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            args = tuple(t.to(self._device, non_blocking=True) for t in block.args)
            mask = None if block.mask is None else block.mask.to(self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        block.slot[1] = ready  # the pinned slot is free again once this copy is done
        return block._replace(args=args, mask=mask, ready=ready, slot=None)

    # ------------------------------------------------------------ dispatch
    def _ensure_runner(self) -> ScanRunner:
        donate = resolve_donate(self._collection, self._donate)
        if (
            self._runner is None
            or self._runner.donate != donate
            or self._runner.health != _health.ENABLED
            or self._runner.token != _mega_plan.route_token()
        ):
            self._runner = ScanRunner(self._collection, donate, health=_health.ENABLED)
        return self._runner

    def _dispatch(self, block: _Block) -> None:
        if _trace.ENABLED:
            # One span per dispatched block, under the active context
            # (evaluator.run) or the evaluator root for bare step() use.
            ctx = _trace.child(_trace.current() or self._trace_root())
            self._last_block_span = ctx.span_id
            with _trace.activate(ctx):
                self._dispatch_impl(block)
            return
        self._dispatch_impl(block)

    def _dispatch_impl(self, block: _Block) -> None:
        if block.perbatch:
            # The per-batch tail goes through fused_update, which carries
            # its own health screen.  A sliced collection's trailing
            # slice-id vector moves to its keyword seat.
            sliced = self._collection._slices is not None
            for args in block.perbatch:
                if sliced:
                    self._collection.fused_update(*args[:-1], slice_ids=args[-1])
                else:
                    self._collection.fused_update(*args)
            self.batches_seen += block.batches
            self._maybe_snapshot()
            self._maybe_checkpoint()
            return
        if block.ready is not None:
            # Staged on the copy stream: order the dispatch after it, and
            # keep the allocator from reusing the staged tensors early.
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(block.ready)
            for t in (*block.args, block.mask):
                if t is not None:
                    t.record_stream(stream)
        runner = self._ensure_runner()
        t0 = time.monotonic() if _telemetry.ENABLED else 0.0
        health_stats = runner.dispatch(block.args, block.mask)
        self.blocks_dispatched += 1
        self.batches_seen += block.batches
        if _telemetry.ENABLED:
            _telemetry.record_engine_block(self._block_size, block.batches, block.pad_steps)
            _telemetry.record_span(
                "engine_block", "Evaluator", time.monotonic() - t0,
                states_nbytes(self._collection),
            )
        if health_stats is not None:
            # steps=block.batches: the stacked figures are reduced over the
            # REAL steps only, so the fully masked pad steps never read as
            # zero-weight batches.  One read back a block.
            # tpulint: disable=TPU001 -- health_stats is non-None only when the runner was built with health=_health.ENABLED
            _health.inspect(
                health_stats, source="engine_block", bounds=runner.bounds,
                steps=block.batches,
            )
        if _perfscope.ENABLED:
            _perfscope.maybe_evaluate_slo(self.blocks_dispatched)
        self._maybe_snapshot()
        self._maybe_checkpoint()

    def _maybe_snapshot(self) -> None:
        if (
            self._snapshot_every
            and self.blocks_dispatched
            and self.blocks_dispatched % self._snapshot_every == 0
            and self.blocks_dispatched != self._last_snap_at
        ):
            self._last_snap_at = self.blocks_dispatched
            snap = self._collection.compute()
            self.last_snapshot = snap
            self.snapshots.append(snap)
            if _telemetry.ENABLED:
                # The live quality stream: every snapshot's figures become
                # QualityEvents.  Lazy import: the engine (execution
                # layer) does not import the monitor at module level.
                from torcheval_tpu_torch.monitor import quality as _quality

                _quality.publish(self._collection, step=self.blocks_dispatched, values=snap)
            if self._on_snapshot is not None:
                self._on_snapshot(self.blocks_dispatched, snap)

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, *, flush: bool = True) -> str:
        """Persist the collection state + stream cursor now (atomic write).
        ``flush=True`` (default) dispatches any buffered partial block
        first so the cursor covers every batch handed to the evaluator;
        the periodic in-stream saves use ``flush=False`` (buffered batches
        are replayed on resume)."""
        if self._ckpt is None:
            raise RuntimeError("Evaluator was constructed without checkpoint_dir.")
        if flush:
            self.flush()
        self._last_ckpt_blocks = self.blocks_dispatched
        return self._ckpt.save(
            self._collection.state_dict(),
            {"batches_seen": self.batches_seen, "blocks_dispatched": self.blocks_dispatched},
        )

    def _maybe_checkpoint(self) -> None:
        # ``batches_seen`` counts exactly the batches whose effect is in
        # the member states, and the stream is refolded in order, so a
        # resume is bit-identical wherever the kill lands.
        if self._ckpt_every is None:
            return
        if self.blocks_dispatched - self._last_ckpt_blocks >= self._ckpt_every:
            self.save_checkpoint(flush=False)
