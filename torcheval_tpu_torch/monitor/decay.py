"""Exponential time decay folded into existing counter / binned states (the
port of ``torcheval_tpu/monitor/decay.py``).

:class:`Decayed` wraps a metric whose states are all tensors and multiplies
every state by a constant factor ``decay`` before the inner metric's own
update adds the batch: no ring buffer, the same states, the same
kernels.  After ``n`` updates

    s_n = d * s_(n-1) + x_n = sum_i d^(n-i) x_i

so the most recent batch weighs 1 and a batch ``k`` updates old ``d^k``.
``half_life_updates=N`` gives ``d = 0.5 ** (1/N)``.

Fixed states (``Metric._fixed_states``: the ``threshold`` edges of the
binned and sketch-mode curve metrics, a digest's ladder ``edges``) are
configuration, not statistics: they are neither decayed nor cast.  The
JAX package decays them too, so its binned curves count against edges
scaled by ``d^n``; the port keeps them (ROADMAP queue 3).

The state is ``s * d + x`` in float32: two rounded operations, the
multiply then the add, as the JAX package's eager path runs them.

With a validity ``mask`` (``bucket=True``, the engine's pad steps) the
factor is ``torch.where(mask.sum() > 0, d, 1.0)``, computed on the device
with no read back, so a fully masked step multiplies by exactly 1.0 and
the engine's blocks (which run pad steps inside a CUDA graph) stay
bit-equal to the per-batch path.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.metric import DeviceLike, Metric

__all__ = ["Decayed"]


def _resolve_decay(decay: Optional[float], half_life_updates: Optional[float]) -> float:
    if (decay is None) == (half_life_updates is None):
        raise ValueError(
            "Pass exactly one of `decay=` (per-update factor in (0, 1)) "
            "or `half_life_updates=` (updates until a batch's weight "
            f"halves); got decay={decay!r}, "
            f"half_life_updates={half_life_updates!r}."
        )
    if decay is not None:
        if not 0.0 < decay < 1.0:
            raise ValueError(
                f"`decay` must lie in (0, 1); got {decay!r}. decay=1 is a "
                "plain lifetime metric — drop the wrapper instead."
            )
        return float(decay)
    if half_life_updates <= 0:
        raise ValueError(
            f"`half_life_updates` must be positive; got {half_life_updates!r}."
        )
    return float(0.5 ** (1.0 / float(half_life_updates)))


class Decayed(Metric):
    """Exponentially time-decayed view of ``metric``.

    The wrapper owns no state: it shares the inner metric's state
    registry, decays those states in its update and delegates ``compute``,
    ``merge_state`` and checkpoints, so it joins collections, the engine
    and ``state_dict`` round trips as the inner metric does.  Only metrics
    whose states are all tensors are accepted (a buffer metric has no
    accumulated statistic to decay); integer states become float32, in the
    live state and the registry default, so the fractional decay fits.
    Fixed states (edges) stay as they are.
    ``device=None`` takes the inner metric's device.
    """

    def __init__(
        self,
        metric: Metric,
        *,
        decay: Optional[float] = None,
        half_life_updates: Optional[float] = None,
        device: DeviceLike = None,
    ) -> None:
        if not isinstance(metric, Metric):
            raise TypeError(f"Decayed wraps a Metric instance; got {type(metric).__name__}.")
        for name, default in metric._state_name_to_default.items():
            if not isinstance(default, torch.Tensor):
                raise TypeError(
                    f"Decayed requires array states; {type(metric).__name__}"
                    f".{name} is a {type(default).__name__} (buffer-style "
                    "metrics have no accumulated statistic to decay)."
                )
        super().__init__(device=metric.device if device is None else device)
        self._decay = _resolve_decay(decay, half_life_updates)
        self._inner = metric
        # One registry for both: the wrapper's state_dict / reset / load walk
        # the inner's names, and the forwarding below makes the inner's live
        # tensors the wrapper's states.
        self._state_name_to_default = metric._state_name_to_default
        self._device = metric._device
        self._supports_mask = bool(metric._supports_mask)
        # The edges of a binned or sketch metric are geometry, not counts:
        # they neither decay nor change dtype.
        self._fixed_states = tuple(metric._fixed_states)
        self._decayed = tuple(
            n for n in metric._state_name_to_default if n not in self._fixed_states
        )
        for name in self._decayed:
            default = metric._state_name_to_default[name]
            if not default.is_floating_point():
                metric._state_name_to_default[name] = default.to(torch.float32)
                setattr(metric, name, getattr(metric, name).to(torch.float32))

    # ------------------------------------------------------- forwarding
    # The states live on the inner metric: writes of a state name land
    # there (the collection installs states with setattr); reads of what
    # the wrapper lacks (states, num_classes, ...) fall through.
    def __setattr__(self, name: str, value: Any) -> None:
        inner = self.__dict__.get("_inner")
        if inner is not None and name in inner._state_name_to_default:
            setattr(inner, name, value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") or name == "_inner":
            raise AttributeError(name)
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # -------------------------------------------------------- lifecycle
    @property
    def decay(self) -> float:
        """The per-update multiplicative factor."""
        return self._decay

    @property
    def inner(self) -> Metric:
        """The wrapped metric (it shares its states with this wrapper)."""
        return self._inner

    def update(self, *args: Any, **kwargs: Any) -> "Decayed":
        inner = self._inner
        mask = kwargs.get("mask")
        if mask is None:
            factor: Any = self._decay
        else:
            # A fully masked step (an engine pad step) must be an exact no-op:
            # x * 1.0 is x, bit for bit.  On the device, no read back.
            mask = torch.as_tensor(mask, device=inner.device)
            kwargs["mask"] = mask
            factor = torch.where(mask.sum() > 0, self._decay, 1.0)
        for name in self._decayed:
            setattr(inner, name, getattr(inner, name) * factor)
        inner.update(*args, **kwargs)
        return self

    def compute(self) -> Any:
        return self._inner.compute()

    def merge_state(self, metrics: Iterable["Decayed"]) -> "Decayed":
        metrics = list(metrics)
        for m in metrics:
            if not isinstance(m, Decayed) or m._decay != self._decay:
                raise ValueError(
                    "merge_state requires Decayed peers with the same "
                    f"decay factor {self._decay!r}; got {m!r}."
                )
        self._inner.merge_state([m._inner for m in metrics])
        return self

    def to(self, device: DeviceLike, *args: Any, **kwargs: Any) -> "Decayed":
        self._inner.to(device, *args, **kwargs)
        object.__setattr__(self, "_device", self._inner._device)
        return self

    def __setstate__(self, state: Any) -> None:
        super().__setstate__(state)
        # Pickling copies the shared registry into two dicts; share it again
        # so state_dict / reset on either object stay in step.
        object.__setattr__(self, "_state_name_to_default", self._inner._state_name_to_default)
