"""Multi-batch stepping: ``block_size`` batches through every member's
fused update in ONE host dispatch (the port of
``torcheval_tpu/engine/scan.py``).

The JAX package folds a block's stacked batches through the collection's
update body as a :func:`jax.lax.scan` inside one jitted program.  PyTorch
runs eagerly, so here the counterpart of that program is a captured CUDA
graph: the first block of a signature (stacked shapes and dtypes, mask or
none, the member states' layout; a runner is built for one donate,
health and route-token setting) is captured once, ``block_size`` steps of
:meth:`MetricCollection._scan_step` over static slot views of a static
block buffer, and every block of that signature is one
``CUDAGraph.replay()``.  The collection kernel (``mega.cu``) and, for
members past its plan, their own kernels (``cm_slab.cu``,
``binned_count.cu``, and ``wavefront.cu`` for the text family's token ids
or logits) run inside the graph; each step's result is bit-equal to a
``fused_update`` of the same padded batch, since it is the same body on
the same tensors.

The runner's programs, their state buffer, capture and replay are a
:class:`~torcheval_tpu_torch.metrics._graphs.GraphPrograms` over every
member's states (``metrics/_graphs.py``), the owner
``MetricCollection.update``'s replay uses too: every member state is a
view of one flat buffer of its dtype, which every graph of the runner
reads and writes.  The graph adds each step's counts in place; after the
replay the members get the buffer's views (``donate``: the same tensors
every block) or one clone of the buffer (no donation: new tensors every
block, as in JAX).  A capture's eager warm-up runs the first step once,
and the capture is in ``"thread_local"`` mode, so the prefetch thread's
pinned allocations and copies on its own stream stay legal.  A failed
capture or replay raises; it never falls back to the eager loop.

On the CPU the same steps run eagerly, one by one: the plain version the
tests hold against the JAX engine.  There the capture counter
(``_stats``) counts what a capture would have been, once a signature.
With the data-health monitor on, each step's
:func:`~torcheval_tpu_torch.telemetry.health.batch_stats` is stacked as a
side output (JAX's scan ``ys``), read back once a block.  With perfscope
on, the first block of each signature is priced as ``"mega_scan"`` or
``"engine_scan"`` (:func:`_program_name`); on the card its states are the
runner's buffer, which a donated replay writes in place, and the memory
rise of that block includes the capture's graph pool.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from torcheval_tpu_torch._stats import bump_trace
from torcheval_tpu_torch.metrics._graphs import (
    GraphPrograms, Program, States, install_states, pairs, read_states)
from torcheval_tpu_torch.metrics.collection import MetricCollection, _call_signature
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.ops import _mega_plan
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import health as _health
from torcheval_tpu_torch.telemetry import perfscope as _perfscope


def _program_name(
    collection: MetricCollection,
    stacked_args: Tuple[torch.Tensor, ...],
    stacked_mask: Optional[torch.Tensor],
) -> str:
    """``"mega_scan"`` when a step's update routes through the collection
    kernel, else ``"engine_scan"``: the plan reads shapes and dtypes only,
    so step 0's slot views give every step's answer."""
    elems = tuple(a[0] for a in stacked_args)
    kw: Dict[str, Any] = {}
    if collection._slices is not None:
        elems, kw["slice_ids"] = elems[:-1], elems[-1]
    if stacked_mask is not None:
        kw["mask"] = stacked_mask[0]
    plan = _mega_plan.plan_for(collection._metrics, elems, kw, collection._slices)
    return "mega_scan" if plan is not None else "engine_scan"


def _stack(values: List[Any]) -> Any:
    """Stack one figure of :func:`health.batch_stats` across steps."""
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    if isinstance(first, tuple):
        return tuple(_stack([v[j] for v in values]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([v[k] for v in values]) for k in first}
    return first


def _run_steps(
    collection: MetricCollection,
    stacked_args: Tuple[torch.Tensor, ...],
    stacked_mask: Optional[torch.Tensor],
    steps: int,
    donate: bool,
    health: bool,
    bounds: Tuple[Tuple[str, int], ...],
) -> Optional[Dict[str, Any]]:
    """Fold the first ``steps`` steps of a block through the collection's
    step body; returns the step-stacked health figures (or ``None``).  For
    a sliced collection the last stacked positional is the slice ids."""
    sliced = collection._slices is not None
    per_step = []
    with skip_value_checks():
        for i in range(steps):
            step_args = tuple(a[i] for a in stacked_args)
            kw: Dict[str, Any] = {}
            if sliced:
                step_args, kw["slice_ids"] = step_args[:-1], step_args[-1]
            step_mask = None if stacked_mask is None else stacked_mask[i]
            if step_mask is not None:
                kw["mask"] = step_mask
            collection._scan_step(step_args, kw, donate)
            if health:
                per_step.append(_health.batch_stats(step_args, step_mask, bounds))
    return _stack(per_step) if health else None


class ScanRunner:
    """Owns the captured block programs of one (collection, donate, health)
    triple and dispatches stacked blocks through them, with the
    collection's abort-safe state install and restore."""

    def __init__(
        self,
        collection: MetricCollection,
        donate: bool,
        health: bool = False,
    ) -> None:
        self._collection = collection
        self._donate = bool(donate)
        self._health = bool(health)
        # Route inputs at build time; the engine rebuilds the runner when
        # this drifts (a flag flipped mid-lifecycle).
        self._token = _mega_plan.route_token()
        self.bounds: Tuple[Tuple[str, int], ...] = (
            _health.label_bounds(collection._metrics) if health else ()
        )
        # Signature -> captured program (on the card) or True (on the CPU).
        self._programs = GraphPrograms("engine_scan", collection._all_members)
        self.replays = 0
        # Perfscope's program name of each block signature.
        self._perf_programs: Dict[Any, str] = {}

    @property
    def donate(self) -> bool:
        return self._donate

    @property
    def health(self) -> bool:
        return self._health

    @property
    def token(self) -> Tuple[Any, ...]:
        """Route token the runner's programs were built under."""
        return self._token

    @property
    def captures(self) -> int:
        """Signatures this runner holds a program for."""
        return len(self._programs)

    def dispatch(
        self,
        stacked_args: Tuple[torch.Tensor, ...],
        stacked_mask: Optional[torch.Tensor],
    ) -> Optional[Dict[str, Any]]:
        """Run one block and install the resulting member states.  Returns
        the step-stacked health figures when the runner was built with
        health (read them before the next dispatch), else ``None``."""
        col = self._collection
        before = read_state_arrays(col)
        device = stacked_args[0].device
        states_key = self._programs.states_key(before, device)
        batch = {"mask": stacked_mask}
        key = (_call_signature(stacked_args, batch), states_key)
        if _faults.ENABLED:
            # Chaos site "engine.scan": a mid-stream abort BETWEEN blocks
            # (before any state is read), the kill checkpoint/resume
            # recovers from.
            _faults.fire("engine.scan", signature=hash(key))
        if states_key is None:
            raise ValueError(
                f"the block is on {device} but the collection's states are on "
                f"{col.device}."
            )
        pending = (
            self._perfscope_begin(key, stacked_args, stacked_mask, device)
            if _perfscope.ENABLED
            else None
        )
        program = self._programs.get(key)
        if device.type == "cuda":
            if program is None:
                col._check_fusable()
                program = self._capture(key, stacked_args, batch, before)
            self._replay(program, stacked_args, batch, before)
            if pending is not None:
                # The replay read and wrote the runner's buffer: those are
                # the states a donated block keeps in place.
                self._price(pending, program.states.views, stacked_args, stacked_mask)
            return program.out
        if device.type != "cpu":
            raise ValueError(f"the engine runs on cuda or cpu, not {device}.")
        if program is None:
            col._check_fusable()
            bump_trace(_program_name(col, stacked_args, stacked_mask))
            self._programs.put(key, True)
        stats = self._run_eager(stacked_args, stacked_mask, before)
        if pending is not None:
            self._price(pending, before, stacked_args, stacked_mask)
        return stats

    def _perfscope_begin(self, key, stacked_args, stacked_mask, device):
        """Perfscope's gate for one block (only called with perfscope on);
        the program name of a signature is worked out once."""
        program = self._perf_programs.get(key)
        if program is None:
            program = self._perf_programs[key] = _program_name(
                self._collection, stacked_args, stacked_mask)
        return _perfscope.begin(
            program, (key, self._donate, self._health, self._token), device)

    def _price(self, pending, before: States, stacked_args, stacked_mask) -> None:
        if not _perfscope.ENABLED:
            return
        _perfscope.profile_program(
            pending, before, read_state_arrays(self._collection),
            batch_args=(stacked_args, stacked_mask), donate=self._donate,
        )

    # ----------------------------------------------------------------- CPU
    def _run_eager(self, stacked_args, stacked_mask, before: States):
        col = self._collection
        try:
            stats = _run_steps(
                col, stacked_args, stacked_mask, stacked_args[0].shape[0],
                False, self._health, self.bounds,
            )
        except BaseException:
            if _telemetry.ENABLED and self._donate:
                _telemetry.record_donation("abort")
            install_states(col._all_members, before)
            raise
        if self._donate:
            # Donated: the results go into the states' own tensors.
            dst, src = pairs(before, read_state_arrays(col))
            if dst:
                torch._foreach_copy_(dst, src)
            install_states(col._all_members, before)
        self.replays += 1
        return stats

    # ---------------------------------------------------------------- card
    def _capture(self, key, stacked_args, batch: Dict[str, Any], before: States) -> Program:
        col = self._collection
        steps = stacked_args[0].shape[0]
        name = _program_name(col, stacked_args, batch["mask"])

        def warm(block, s_batch):
            _run_steps(col, block, s_batch["mask"], 1, True, self._health, self.bounds)

        def body(block, s_batch):
            bump_trace(name)
            return _run_steps(col, block, s_batch["mask"], steps, True, self._health, self.bounds)

        return self._programs.capture(key, key[1], before, stacked_args, batch, body, warm)

    def _replay(self, program: Program, stacked_args, batch: Dict[str, Any], before: States) -> None:
        try:
            self._programs.replay(program, stacked_args, batch, before, self._donate)
        except BaseException:
            if _telemetry.ENABLED and self._donate:
                _telemetry.record_donation("abort")
            raise
        self.replays += 1


def resolve_donate(collection: MetricCollection, donate: Optional[bool]) -> bool:
    """Engine-level donation default: the explicit flag, else the
    collection's, else off (the port has no global donation flag)."""
    if donate is not None:
        return bool(donate)
    return bool(collection._donate)


def states_nbytes(collection: MetricCollection) -> int:
    """Total member state bytes (the payload of ``engine_block`` spans),
    slice clones included."""
    return sum(_telemetry.state_nbytes(m) for m in collection._all_members.values())


def read_state_arrays(collection: MetricCollection) -> States:
    """The member states, for parity and debug inspection."""
    return read_states(collection._all_members)


__all__ = ["ScanRunner", "read_state_arrays", "resolve_donate", "states_nbytes"]
