"""Captured CUDA graphs of update bodies: the static state buffer and the
capture recipe that the engine (``engine/scan.py``) and
:meth:`MetricCollection.update` share, and the collection's replay of its
graph-eligible members.

A graph replays the addresses it captured, so its owner keeps the states
the graph reads and writes: every member state is a view of one flat
buffer of its dtype (:class:`StateBuffer`).  Before a replay the members'
states are copied in (one copy, skipped when the members hold the buffer's
own views); the graph ends by copying in every state a member rebound;
after it the members get the buffer's views (donation) or one clone of the
buffer (new tensors every call).

:func:`capture` runs the body once eagerly on a side stream first, on
scratch copies of the states (PyTorch's capture recipe), so every kernel is
built, loaded and configured before the capture, then captures it in
``"thread_local"`` mode.  Its launches go to the capture's own counter
(``_build.recording``); each replay adds them (``_build.count_replay``).

:class:`GraphedUpdate` is the collection's use of it.  A member class sets
``Metric._graph_update`` where its ``update`` is ``_validate`` (every
check, with its read backs) followed by ``_update_body`` (device work
only, its host branches decided by shapes, dtypes and constructor
parameters).  On a GPU an unsliced collection runs each such member's
``_validate`` eagerly, in member order, then replays one graph of all
their ``_update_body`` calls for the call's signature: the batch's
shapes, strides, dtypes and device, the presence of each keyword, the
members' state layout and ``_mega_plan.route_token()``.  A new signature
is captured on its first call.  A capture or replay that fails raises.

A ring window (``_buffer.RingWindowMixin``) writes its ring at its host
cursor, which the graph cannot freeze: its body reads ``start`` from one
entry of a static int64 tensor of the program (one entry a ring member,
made only where the collection has ring members), and the graph ends by
moving each entry on as the member's host bookkeeping moves its cursor
(``_advance_start``).  After a replay the call runs each ring member's
``_update_host`` in member order and keeps the cursors; a later call whose
cursors differ from the kept ones (a ``reset``, a load, a merge, another
program's replays) first copies its cursors in from pinned memory, a copy
the host does not wait for.  The cursor is data, not signature: one graph
serves every position.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch.metrics._buffer import RingWindowMixin
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.ops import _build, _mega_plan

States = Dict[str, Dict[str, torch.Tensor]]

# Byte alignment of each state's view in its flat state buffer.
_ALIGN = 16


def states_signature(states: States) -> Tuple[Any, ...]:
    return tuple(
        (name, s, tuple(v.shape), str(v.dtype), str(v.device))
        for name, per in states.items()
        for s, v in per.items()
    )


def pairs(dst: States, src: States) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The (destination, source) tensors of ``src`` that are not already
    the tensors of ``dst``."""
    d, s = [], []
    for name, per in src.items():
        for state, v in per.items():
            target = dst[name][state]
            if v is not target:
                d.append(target)
                s.append(v)
    return d, s


def clone_states(states: States) -> States:
    return {name: {s: v.clone() for s, v in per.items()} for name, per in states.items()}


class StateBuffer:
    """A graph owner's static states: every member state is a view of one
    flat buffer of its dtype, so copying them in and cloning them out are
    one copy a dtype, and a clone's views are one ``as_strided`` a state."""

    def __init__(self, states: States, device: torch.device) -> None:
        self._layout = []
        used: Dict[torch.dtype, int] = {}
        for name, per in states.items():
            for s, v in per.items():
                at = used.get(v.dtype, 0)
                shape = tuple(v.shape)
                stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
                self._layout.append((name, s, v.dtype, shape, stride, at))
                step = max(_ALIGN // v.element_size(), 1)
                used[v.dtype] = at + -(-v.numel() // step) * step
        self.flats = {dt: torch.empty(max(n, 1), dtype=dt, device=device) for dt, n in used.items()}
        self.views = self._views(self.flats)
        # The clone the members got after the last replay (no donation).
        self._clone_flats: Optional[Dict[torch.dtype, torch.Tensor]] = None
        self._clone_views: Optional[States] = None

    def _views(self, flats: Dict[torch.dtype, torch.Tensor]) -> States:
        out: States = {}
        for name, s, dtype, shape, stride, at in self._layout:
            out.setdefault(name, {})[s] = flats[dtype].as_strided(shape, stride, at)
        return out

    def _all_are(self, current: States, views: Optional[States]) -> bool:
        return views is not None and all(
            v is views[name][s] for name, per in current.items() for s, v in per.items()
        )

    def holds(self, current: States) -> bool:
        """Whether ``current`` are this buffer's views or its last clone's
        (then they have the buffer's layout)."""
        return self._all_are(current, self.views) or self._all_are(current, self._clone_views)

    def copy_in(self, current: States) -> None:
        """Make the buffer hold ``current``: nothing to do when the members
        hold its own views, one copy a dtype when they hold the last clone,
        else one multi-tensor copy of every state."""
        if self._all_are(current, self.views):
            return
        if self._all_are(current, self._clone_views):
            for dtype, flat in self.flats.items():
                flat.copy_(self._clone_flats[dtype])
            return
        dst, src = pairs(self.views, current)
        torch._foreach_copy_(dst, src)

    def write_back(self, current: States) -> None:
        """Copy into the buffer every state a member rebound (inside the
        capture: the graph ends with the buffer holding its result)."""
        dst, src = pairs(self.views, current)
        if dst:
            torch._foreach_copy_(dst, src)

    def cloned(self) -> States:
        self._clone_flats = {dtype: flat.clone() for dtype, flat in self.flats.items()}
        self._clone_views = self._views(self._clone_flats)
        return self._clone_views


def capture(
    device: torch.device,
    warm: Callable[[], Any],
    body: Callable[[], Any],
    read: Callable[[], States],
    install: Callable[[States], None],
    before: States,
    states: StateBuffer,
) -> Tuple[Any, Any, Counter]:
    """Capture ``body()`` into a CUDA graph on ``states``: ``warm()`` runs
    first on a side stream over scratch copies of ``before``, then the
    capture runs ``body()`` with the members on the buffer's views and ends
    by writing back every state they rebound.  The members get ``before``
    back whatever happens.  Returns the graph, what ``body()`` returned and
    the launches the capture recorded."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(device)
    try:
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            install(clone_states(before))
            warm()
        current.wait_stream(side)
        install(states.views)
        with _build.recording() as launches:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = body()
                states.write_back(read())
    finally:
        # The members hold capture-time tensors of the graph's pool (or
        # scratch); put the caller's states back.
        install(before)
    return graph, out, launches


# ------------------------------------------------------ collection replay
class _Program(NamedTuple):
    """One captured update of the eligible members and its static tensors."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    states: StateBuffer
    launches: Counter
    # The ring members' write positions the graph reads and moves on (None:
    # no ring), and the host cursors they hold (empty: unknown).
    starts: Optional[torch.Tensor]
    cursors: List[int]


def _tensors(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> List[torch.Tensor]:
    """The call's tensors in signature order (positionals, then keywords
    by name)."""
    out = [a for a in args if isinstance(a, torch.Tensor)]
    out.extend(kwargs[k] for k in sorted(kwargs) if isinstance(kwargs[k], torch.Tensor))
    return out


def _leaf(v: Any, device: torch.device) -> Any:
    """One argument's part of the signature; ``False`` where no graph can
    take it: a tensor elsewhere than ``device`` or not contiguous (its
    static copy would change the strides the body reads), or a value
    other than a tensor, ``None`` or a number (a number is a constant of
    the graph, so its value is keyed)."""
    if isinstance(v, torch.Tensor):
        if v.device != device or not v.is_contiguous():
            return False
        return (tuple(v.shape), v.stride(), v.dtype)
    if v is None:
        return None
    if isinstance(v, (bool, int, float)):
        return (type(v).__name__, repr(v))
    return False


class GraphedUpdate:
    """The graph-eligible members of one unsliced collection (``members``,
    in member order) and their captured update bodies, one graph a call
    signature.  :meth:`key` says whether a call can replay; :meth:`run`
    replays (capturing first where the signature is new)."""

    def __init__(self, members: Dict[str, Any]) -> None:
        # Lazy: the bounded program cache lives in the execution layer.
        from torcheval_tpu_torch.parallel._compile_cache import LruCache

        self._members = members
        self.name = "graph[" + ",".join(members) + "].update"
        self._programs = LruCache(name="collection_update")
        self._states: Optional[StateBuffer] = None
        self._states_key: Optional[Tuple[Any, ...]] = None
        # The ring-window members, in member order: each reads its start
        # from its entry of the program's ``starts``.
        self._rings = tuple(n for n, m in members.items() if isinstance(m, RingWindowMixin))

    def read(self) -> States:
        return {
            name: {s: getattr(m, s) for s in m._state_name_to_default}
            for name, m in self._members.items()
        }

    def install(self, states: States) -> None:
        for name, per in states.items():
            m = self._members[name]
            for s, v in per.items():
                setattr(m, s, v)

    def key(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any], current: States
    ) -> Optional[Tuple[Any, ...]]:
        """The signature of this call on the members' ``current`` states,
        or ``None`` where it cannot replay: a batch on no GPU, on another
        device than the states, not contiguous, or holding a value that is
        not a tensor or a number; a state that is not a tensor."""
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if first is None or first.device.type != "cuda":
            return None
        device = first.device
        batch = tuple(_leaf(a, device) for a in args)
        named = tuple((k, _leaf(kwargs[k], device)) for k in sorted(kwargs))
        if False in batch or any(v is False for _, v in named):
            return None
        if self._states is not None and self._states.holds(current):
            states_key = self._states_key
        else:
            if not all(
                isinstance(v, torch.Tensor) and v.device == device
                for per in current.values() for v in per.values()
            ):
                return None
            states_key = states_signature(current)
        return (batch, named, states_key, _mega_plan.route_token())

    def run(
        self,
        key: Tuple[Any, ...],
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        current: States,
    ) -> None:
        """The members' update bodies on this batch as one replay of the
        graph of ``key`` (captured here first where it is new); the members
        then hold new state tensors, and the ring members' host bookkeeping
        follows."""
        tensors = _tensors(args, kwargs)
        program = self._programs.get(key)
        how = "replay"
        if program is None:
            states_key = key[2]
            if states_key != self._states_key:
                self._states = StateBuffer(current, tensors[0].device)
                self._states_key = states_key
            program = self._capture(args, kwargs, tensors, current, self._states)
            self._programs.put(key, program)
            how = "capture"
        if self._rings:
            self._seed_starts(program)
        torch._foreach_copy_(program.inputs, tensors)
        program.states.copy_in(current)
        program.graph.replay()
        _build.count_replay(program.launches)
        self.install(program.states.cloned())
        if self._rings:
            self._ring_bookkeeping(program, args, kwargs)
        _stats.count_member_updates(how, len(self._members))

    def _seed_starts(self, program: _Program) -> None:
        """Copy the ring members' cursors into ``program.starts`` unless it
        holds them already (the cursors its last replay left)."""
        cursors = [self._members[n].next_inserted for n in self._rings]
        if cursors != program.cursors:
            # A pinned tensor of the caching host allocator is not handed
            # out again before the copy from it has run.
            program.starts.copy_(
                torch.tensor(cursors, dtype=torch.int64, pin_memory=True), non_blocking=True)
        program.cursors.clear()

    def _ring_bookkeeping(self, program: _Program, args, kwargs) -> None:
        """After a replay: each ring member's host bookkeeping, in member
        order; the cursors it leaves are those the graph moved
        ``program.starts`` to."""
        for name in self._rings:
            self._members[name]._update_host(*args, **kwargs)
        program.cursors.extend(self._members[n].next_inserted for n in self._rings)

    def _capture(self, args, kwargs, tensors, current: States, states: StateBuffer) -> _Program:
        def static(v):
            return torch.empty_like(v) if isinstance(v, torch.Tensor) else v

        s_args = tuple(static(a) for a in args)
        s_kwargs = {k: static(v) for k, v in kwargs.items()}
        inputs = _tensors(s_args, s_kwargs)
        torch._foreach_copy_(inputs, tensors)
        device = tensors[0].device
        # Zeros until the call copies the cursors in: a column of every
        # ring, so the warm-up's writes stay inside the rings.
        starts = (
            torch.zeros(len(self._rings), dtype=torch.int64, device=device)
            if self._rings else None
        )
        start_of = {name: starts[i] for i, name in enumerate(self._rings)}

        def bodies():
            with skip_value_checks():
                for name, m in self._members.items():
                    if name in start_of:
                        m._update_body(start_of[name], *s_args, **s_kwargs)
                        m._advance_start(start_of[name], *s_args, **s_kwargs)
                    else:
                        m._update_body(*s_args, **s_kwargs)

        graph, _, launches = capture(
            device, bodies, bodies, self.read, self.install, current, states)
        _stats.bump_trace("collection_update")
        return _Program(graph, inputs, states, launches, starts, [])


__all__ = ["GraphedUpdate", "StateBuffer", "capture", "clone_states", "pairs", "states_signature"]
