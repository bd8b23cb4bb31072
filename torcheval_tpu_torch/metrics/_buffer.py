"""Shared helpers for sample-buffer metrics (AUROC, PR curves, HitRate,
ReciprocalRank, Cat) and for the ring windows of ``metrics/window/``.

Buffer states are Python lists of tensors; all math is deferred to
``compute()``, where one concatenation feeds the kernels.  Merge
concatenates; ``_prepare_for_merge_state`` pre-concatenates each buffer so
a sync ships a single tensor per state (reference
``classification/auroc.py:130-134``).

The JAX package's jitted pair updates and its compilation-cache bypass
(``_windowed_pair_update_fused_impl`` and its donated variant,
``_windowed_donated_bypass``) serve its program cache and have no
counterpart: the port's updates write the ring columns in place."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.metric import Metric


def merge_concat_buffers(
    metric: Metric, metrics: Iterable[Metric], *state_names: str, dim: int = -1
) -> None:
    """Append each source metric's concatenated buffer (reference merge
    semantics: one pre-concatenated tensor per source,
    ``classification/auroc.py:121-128``)."""
    for other in metrics:
        if getattr(other, state_names[0]):
            for name in state_names:
                buf = getattr(other, name)
                getattr(metric, name).append(
                    torch.cat(buf, dim=dim).to(metric.device)
                )


def prepare_concat_buffers(metric: Metric, *state_names: str, dim: int = -1) -> None:
    for name in state_names:
        buf = getattr(metric, name)
        if buf:
            setattr(metric, name, [torch.cat(buf, dim=dim)])


class RingWindowMixin:
    """Shared machinery for windowed metrics whose state is a
    ``(num_tasks, capacity)`` ring buffer per state name
    (``WindowedBinaryAUROC`` and the per-update windows of
    :class:`WindowedLifetimeMixin`).

    Invariant: valid columns always form the prefix ``[:, :_num_valid]``:
    in-order inserts extend it, wrapped inserts overwrite inside it, and
    merge re-packs into it, so compute never guesses the fill level from a
    zero suffix (reference ``window/auroc.py:158-164``).

    The rings are the one kind of state the port writes in place (a batch
    writes each of its columns once, not a copy of the whole ring).  That
    is safe because a ring never shares storage: it is registered, loaded
    and reset as a fresh copy, a merge builds a new one, and an oversized
    batch is copied into it.

    Subclasses set ``_window_states`` (the ring state names) and call
    ``_init_window`` from ``__init__``; the capacity lives in
    ``_window_capacity`` (exposed under the reference attribute names by
    properties on each class).

    A graph-eligible subclass (``Metric._graph_update``) splits its
    ``update`` in three: ``_validate`` (every check), ``_update_body(start,
    ...)`` (device work only, writing the ring at ``start``, the cursor as
    a 0-dim int64 tensor on the states' device) and ``_update_host(...)``
    (the host bookkeeping: cursor, fill level, counters).  A standalone
    update runs the three in turn (:meth:`_split_update`);
    ``MetricCollection.update`` replays the bodies as a captured graph
    that reads ``start`` from a device tensor and moves it on with
    ``_advance_start(start, ...)``, the device twin of ``_update_host``'s
    cursor move (``metrics/_graphs.py``), then runs the bookkeeping.
    """

    _window_states: tuple = ()
    # Host-side counters each subclass also wants checkpointed
    # (e.g. "total_samples" / "total_updates").
    _window_counters: tuple = ()
    # The ring bookkeeping is host ints, not registered tensor state, so it
    # rides state_dict explicitly or a checkpoint restore would drop the
    # window's fill level.  Same key and int64 layout as the JAX package, so
    # a JAX windowed state_dict loads here (convert.state_from_jax).
    _WINDOW_META_KEY = "window_bookkeeping"

    def _init_window(self, capacity: int) -> None:
        self._window_capacity = capacity
        self._init_window_capacity = capacity
        self.next_inserted = 0
        self._num_valid = 0

    def state_dict(self):
        out = super().state_dict()
        meta = [self._window_capacity, self.next_inserted, self._num_valid]
        meta += [getattr(self, name) for name in self._window_counters]
        out[self._WINDOW_META_KEY] = torch.tensor(meta, dtype=torch.int64)
        return out

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        state_dict = dict(state_dict)
        meta = state_dict.pop(self._WINDOW_META_KEY, None)
        if meta is not None:
            values = [int(v) for v in torch.as_tensor(meta).tolist()]
            self._window_capacity, self.next_inserted, self._num_valid = values[:3]
            for name, value in zip(self._window_counters, values[3:]):
                setattr(self, name, value)
        super().load_state_dict(state_dict, strict=strict)

    def _window_start(self) -> torch.Tensor:
        """The cursor as the 0-dim int64 device tensor an ``_update_body``
        takes: one fill on a GPU, no copy from the host."""
        return torch.full((), self.next_inserted, dtype=torch.int64, device=self.device)

    def _split_update(self, *args, **kwargs) -> None:
        """A standalone ``update`` on a batch already on the states' device:
        the checks, the device body at the cursor, the host bookkeeping."""
        self._validate(*args, **kwargs)
        self._update_body(self._window_start(), *args, **kwargs)
        self._update_host(*args, **kwargs)

    def _window_advance(self, n: int) -> None:
        """Host bookkeeping after inserting ``n`` columns at
        ``next_inserted`` (mod capacity)."""
        self.next_inserted = (self.next_inserted + n) % self._window_capacity
        self._num_valid = min(self._num_valid + n, self._window_capacity)

    @staticmethod
    def _valid_window(metric: "RingWindowMixin", name: str) -> torch.Tensor:
        return getattr(metric, name)[:, : metric._num_valid]

    def _window_merge(self, metrics) -> None:
        """Pack every metric's valid columns into an enlarged window whose
        capacity is the sum of all capacities (reference merge semantics,
        ``window/auroc.py:166-207`` / ``window/normalized_entropy.py:232-296``,
        with the capacity updated, which the reference's NE merge forgets)."""
        merged_w = self._window_capacity + sum(m._window_capacity for m in metrics)
        idx = 0
        for name in self._window_states:
            pieces = [self._valid_window(self, name)] + [
                self._valid_window(m, name).to(self.device) for m in metrics
            ]
            # A never-updated metric may still hold its initial row count
            # (WindowedMeanSquaredError before its output dim is known); its
            # zero-column slice carries no data, so conform it to the sized
            # metrics' rows instead of failing the concatenation.
            rows = max(p.shape[0] for p in pieces)
            pieces = [
                p if p.shape[1] or p.shape[0] == rows else p.new_zeros((rows, 0))
                for p in pieces
            ]
            valid = torch.cat(pieces, dim=1)
            idx = valid.shape[1]
            setattr(self, name, torch.nn.functional.pad(valid, (0, merged_w - idx)))
        self._window_capacity = merged_w
        self.next_inserted = idx % merged_w
        self._num_valid = idx

    def _window_reset(self) -> None:
        """Restore the pre-merge capacity and zero the host counters
        (divergence: the reference base-class reset leaves them stale)."""
        self._window_capacity = self._init_window_capacity
        self.next_inserted = 0
        self._num_valid = 0


class WindowedLifetimeMixin(RingWindowMixin):
    """RingWindowMixin plus the shared lifecycle of every windowed metric
    that also keeps optional lifetime sums (``enable_lifetime``): merge
    packs window columns AND adds the lifetime states; reset restores the
    window bookkeeping and the update counter.

    Subclasses set ``_lifetime_states`` (added on merge when lifetime is
    enabled) besides the RingWindowMixin attributes, keep an
    ``enable_lifetime`` flag and a ``total_updates`` counter, and call
    ``_merge_windowed`` from ``merge_state``.  Two-sum metrics get their
    update body, bookkeeping and compute from ``_update_windowed_pair`` /
    ``_update_host`` / ``_ratio_compute``."""

    _lifetime_states: tuple = ()

    @property
    def max_num_updates(self) -> int:
        """Window capacity (grows on merge)."""
        return self._window_capacity

    def _init_task_window(
        self,
        num_tasks: int,
        max_num_updates: int,
        enable_lifetime: bool,
        dtype: torch.dtype,
    ) -> None:
        """Validate and allocate the standard per-task window layout:
        lifetime vectors ``(num_tasks,)`` and window rings
        ``(num_tasks, max_num_updates)``."""
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        if max_num_updates < 1:
            raise ValueError(
                "`max_num_updates` value should be greater than and equal to 1, "
                f"but received {max_num_updates}. "
            )
        self.num_tasks = num_tasks
        self.enable_lifetime = enable_lifetime
        self._init_window(max_num_updates)
        self.total_updates = 0
        if enable_lifetime:
            for name in self._lifetime_states:
                self._add_state(name, torch.zeros(num_tasks, dtype=dtype))
        for name in self._window_states:
            self._add_state(name, torch.zeros((num_tasks, max_num_updates), dtype=dtype))

    def _write_window(self, start: torch.Tensor, *values: torch.Tensor) -> None:
        """Write ``values`` (one a ring state, in ``_window_states`` order,
        each a scalar or a value a row) into ring column ``start`` (0-dim
        int64 device tensor), in place."""
        col = start.reshape(1)
        for name, v in zip(self._window_states, values):
            ring = getattr(self, name)
            ring.index_copy_(1, col, v.to(ring.dtype).reshape(-1, 1).expand(ring.shape[0], 1))

    def _update_windowed_pair(self, start: torch.Tensor, kernel, args, lifetime=None) -> None:
        """Device work of one update: write the two statistics of
        ``kernel(*args)`` into ring column ``start`` in place and add them
        to the lifetime sums ``lifetime`` (default ``_lifetime_states``)
        when enabled."""
        a, b = kernel(*args)
        self._write_window(start, a, b)
        if self.enable_lifetime:
            la, lb = lifetime or self._lifetime_states
            setattr(self, la, getattr(self, la) + a)
            setattr(self, lb, getattr(self, lb) + b)

    def _update_host(self, *_args, **_kwargs) -> None:
        """Host bookkeeping of one update: one ring column, one update."""
        self._window_advance(1)
        self.total_updates += 1

    def _advance_start(self, start: torch.Tensor, *_args, **_kwargs) -> None:
        """``start`` moved on in place as ``_update_host`` moves the cursor."""
        start.add_(1).remainder_(getattr(self, self._window_states[0]).shape[1])

    def _ratio_compute(self):
        """``windowed = Σa / Σb`` over the valid columns, plus the lifetime
        ratio when enabled; empty tensor(s) before any update."""
        if self._num_valid == 0:
            empty = torch.zeros(0, device=self.device)
            return (empty, empty) if self.enable_lifetime else empty
        wa, wb = self._window_states
        n = self._num_valid
        windowed = getattr(self, wa)[:, :n].sum(dim=1) / getattr(self, wb)[:, :n].sum(dim=1)
        if self.enable_lifetime:
            la, lb = self._lifetime_states
            return getattr(self, la) / getattr(self, lb), windowed
        return windowed

    def _merge_windowed(self, metrics):
        metrics = list(metrics)
        for m in metrics:
            if m.enable_lifetime != self.enable_lifetime:
                raise ValueError(
                    "Merged metrics must all have the same `enable_lifetime` "
                    f"setting; got {self.enable_lifetime} vs {m.enable_lifetime}."
                )
        self._window_merge(metrics)
        for m in metrics:
            if self.enable_lifetime:
                for name in self._lifetime_states:
                    setattr(self, name, getattr(self, name) + getattr(m, name).to(self.device))
            self.total_updates += m.total_updates
        return self

    def reset(self):
        """Reset states AND the host-side window bookkeeping, including the
        window size a previous merge may have grown."""
        super().reset()
        self._window_reset()
        self.total_updates = 0
        return self
