"""Tumbling / sliding bucket-of-epochs windows over existing states (the
port of ``torcheval_tpu/monitor/window.py``).

:class:`SlidingWindow` wraps a metric whose states are fixed-shape tensors
and keeps ``buckets`` copies of each, stacked on a new leading axis.  An
``update`` counts into bucket 0 through the inner metric's own update (its
own kernel), so it runs inside a collection and inside the engine's CUDA
graphs as the inner metric does.  Between updates, :meth:`advance`
rotates the buckets: bucket 0 becomes bucket 1, the oldest falls off and a
zero bucket opens.  The rotation makes new tensors on the device; the
engine copies the members' states into its graph's buffer before every
replay, so a rotation between blocks reaches the next replay.

``compute()`` sums the buckets and evaluates the inner metric on the sum,
so the reading covers the last ``buckets`` epochs; ``buckets=1`` is a
tumbling window.  The inner states must be additive (``merge_state`` adds
them), as every counter and binned metric's are: an inner metric with a
max / min state (``Metric._extremum_states``: ``Max``, ``Min``, PSNR
without a ``data_range``) is refused, where the JAX package sums its
buckets' extrema (ROADMAP queue 3, kept divergences).

Fixed states (``Metric._fixed_states``: the ``threshold`` edges of the
binned and sketch-mode curve metrics, a digest's ladder ``edges``) are
configuration, not counts: the window keeps one copy of each, with no
bucket axis, and neither rotates nor sums it.  The JAX package buckets
them with the counts, zero-filled, so its windowed binned curves count
every score at edges of zero; the port does not (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Any, Iterable

import torch

from torcheval_tpu_torch.metrics.metric import DeviceLike, Metric

__all__ = ["SlidingWindow"]


class SlidingWindow(Metric):
    """Sliding window of ``buckets`` epochs over ``metric``'s statistics.

    The window states are registered on the wrapper (the inner metric's
    names, with a leading ``(buckets,)`` axis; a fixed state keeps its own
    shape and value), so ``state_dict`` carries the whole window; the epoch count rides along under
    ``"window_epochs"`` (int64 ``[buckets, epochs]``, the JAX layout).
    ``device=None`` takes the inner metric's device.
    """

    _EPOCH_META_KEY = "window_epochs"

    def __init__(self, metric: Metric, *, buckets: int, device: DeviceLike = None) -> None:
        if not isinstance(metric, Metric):
            raise TypeError(
                f"SlidingWindow wraps a Metric instance; got {type(metric).__name__}."
            )
        if buckets < 1:
            raise ValueError(f"`buckets` must be >= 1; got {buckets}.")
        for name, default in metric._state_name_to_default.items():
            if not isinstance(default, torch.Tensor):
                raise TypeError(
                    "SlidingWindow requires fixed-shape array states; "
                    f"{type(metric).__name__}.{name} is a {type(default).__name__}."
                )
        if metric._extremum_states:
            raise TypeError(
                "SlidingWindow sums its buckets, so it needs additive states; "
                f"{type(metric).__name__}.{metric._extremum_states[0]} merges by max / min."
            )
        super().__init__(device=metric.device if device is None else device)
        self._inner = metric
        self.buckets = int(buckets)
        self._epochs = 0
        self._supports_mask = bool(metric._supports_mask)
        self._fixed_states = tuple(metric._fixed_states)
        self._windowed = tuple(
            n for n in metric._state_name_to_default if n not in self._fixed_states
        )
        for name, default in metric._state_name_to_default.items():
            if name in self._fixed_states:
                self._add_state(name, default)
            else:
                self._add_state(
                    name, torch.zeros((self.buckets,) + tuple(default.shape), dtype=default.dtype)
                )

    def __getattr__(self, name: str) -> Any:
        # Configuration (num_classes, average, ...) reads through to the
        # inner metric; the window states live on the wrapper.
        if name.startswith("__") or name == "_inner":
            raise AttributeError(name)
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # -------------------------------------------------------- lifecycle
    @property
    def inner(self) -> Metric:
        """The wrapped metric (the scratch of compute and update)."""
        return self._inner

    @property
    def epochs_advanced(self) -> int:
        """How many times :meth:`advance` has rotated the window."""
        return self._epochs

    def update(self, *args: Any, **kwargs: Any) -> "SlidingWindow":
        # The inner metric's own update on bucket 0, written back as row 0.
        inner = self._inner
        self._install_fixed()
        for name in self._windowed:
            setattr(inner, name, getattr(self, name)[0])
        inner.update(*args, **kwargs)
        for name in self._windowed:
            st = getattr(self, name)
            row = getattr(inner, name).to(st.dtype).unsqueeze(0)
            setattr(self, name, torch.cat([row, st[1:]]))
        return self

    def advance(self) -> "SlidingWindow":
        """Rotate the window one epoch: a zero bucket 0 opens and the oldest
        bucket drops.  Call it between epochs, off the update path."""
        for name in self._windowed:
            st = getattr(self, name)
            setattr(self, name, torch.cat([torch.zeros_like(st[:1]), st[:-1]]))
        self._epochs += 1
        return self

    def compute(self) -> Any:
        inner = self._inner
        self._install_fixed()
        for name in self._windowed:
            st = getattr(self, name)
            setattr(inner, name, st.sum(0, dtype=st.dtype))
        return inner.compute()

    def _install_fixed(self) -> None:
        # The wrapper's copy is the one a checkpoint, .to() or the engine's
        # state buffer moves; the inner metric reads it as it is.
        for name in self._fixed_states:
            setattr(self._inner, name, getattr(self, name))

    def merge_state(self, metrics: Iterable["SlidingWindow"]) -> "SlidingWindow":
        # Bucket by bucket addition: the additive-state contract compute's
        # bucket sum rests on too.
        metrics = list(metrics)
        for m in metrics:
            if not isinstance(m, SlidingWindow) or m.buckets != self.buckets:
                raise ValueError(
                    "merge_state requires SlidingWindow peers with "
                    f"buckets={self.buckets}; got {m!r}."
                )
            for name in self._fixed_states:
                if getattr(m, name).shape != getattr(self, name).shape:
                    raise ValueError(
                        f"merge_state requires the same `{name}` geometry: "
                        f"{tuple(getattr(m, name).shape)} vs "
                        f"{tuple(getattr(self, name).shape)}."
                    )
        for name in self._windowed:
            acc = getattr(self, name)
            for m in metrics:
                acc = acc + getattr(m, name).to(self.device)
            setattr(self, name, acc)
        return self

    def reset(self) -> "SlidingWindow":
        super().reset()
        self._inner.reset()
        self._epochs = 0
        return self

    def to(self, device: DeviceLike, *args: Any, **kwargs: Any) -> "SlidingWindow":
        super().to(device, *args, **kwargs)
        self._inner.to(device, *args, **kwargs)
        return self

    # ------------------------------------------------------- checkpoint
    def state_dict(self):
        out = super().state_dict()
        out[self._EPOCH_META_KEY] = torch.tensor([self.buckets, self._epochs], dtype=torch.int64)
        return out

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        state_dict = dict(state_dict)
        meta = state_dict.pop(self._EPOCH_META_KEY, None)
        if meta is not None:
            buckets, epochs = (int(v) for v in torch.as_tensor(meta).tolist())
            if buckets != self.buckets:
                raise RuntimeError(
                    f"Checkpoint was written with buckets={buckets}; this "
                    f"SlidingWindow has buckets={self.buckets}."
                )
            self._epochs = epochs
        for name in self._fixed_states:
            value = state_dict.get(name)
            want = tuple(self._state_name_to_default[name].shape)
            if value is not None and tuple(value.shape) != want:
                raise RuntimeError(
                    f"Checkpoint `{name}` has shape {tuple(value.shape)}; this "
                    f"SlidingWindow keeps it unbucketed, shape {want} (a JAX "
                    "window buckets its edges with zeros, which the port "
                    "cannot continue)."
                )
        super().load_state_dict(state_dict, strict=strict)
