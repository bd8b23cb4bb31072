"""Captured CUDA graphs of update bodies: :class:`GraphPrograms`, the one
owner of the port's captured programs, which both
:meth:`MetricCollection.update` (:class:`GraphedUpdate`) and the engine
(``engine/scan.py``) use, and the collection's replay of its
graph-eligible members.

A graph replays the addresses it captured, so its owner keeps the states
the graph reads and writes: every member state is a view of one flat
buffer of its dtype (:class:`StateBuffer`), one buffer an owner, made
anew where the states' layout changes.  Each call decides once what the
members hold: the buffer's views, its last clone or other tensors.  That
decides the states' part of the call's key (kept, or a new signature)
and what a replay copies in (nothing, one copy a dtype, or one
multi-tensor copy of every state).  The graph ends by copying in every
state a member rebound; after it the members get the buffer's views
(donation) or one clone of the buffer (new tensors every call).  If the
replay raises, the members keep the states they held.

A capture runs the body once eagerly on a side stream first, on scratch
copies of the states (PyTorch's capture recipe), so every kernel is
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
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch.metrics._buffer import RingWindowMixin
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.ops import _build, _mega_plan

States = Dict[str, Dict[str, torch.Tensor]]

# Byte alignment of each state's view in its flat state buffer.
_ALIGN = 16


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


def read_states(members: Mapping[str, Any]) -> States:
    """Every state of each of ``members`` (``{name: Metric}``), by name."""
    return {
        name: {s: getattr(m, s) for s in m._state_name_to_default}
        for name, m in members.items()
    }


def install_states(members: Mapping[str, Any], states: States) -> None:
    """Bind each member of ``states`` to its tensors."""
    for name, per in states.items():
        m = members[name]
        for s, v in per.items():
            setattr(m, s, v)


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

    def held_in(self, current: States) -> Optional[Dict[torch.dtype, torch.Tensor]]:
        """What ``current`` holds of this buffer: its own views (``{}``,
        nothing to copy in), its last clone's (that clone's flat buffers,
        one copy a dtype) or other tensors (``None``)."""
        if self._all_are(current, self.views):
            return {}
        if self._all_are(current, self._clone_views):
            return self._clone_flats
        return None

    def copy_in(self, current: States, held: Optional[Dict[torch.dtype, torch.Tensor]]) -> None:
        """Make the buffer hold ``current``, of which it holds ``held``
        (:meth:`held_in`): the flat buffers ``held`` names, else one
        multi-tensor copy of every state."""
        if held is None:
            dst, src = pairs(self.views, current)
            torch._foreach_copy_(dst, src)
            return
        for dtype, flat in held.items():
            self.flats[dtype].copy_(flat)

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


class Program(NamedTuple):
    """One captured program and the static tensors it replays on."""

    graph: Any  # torch.cuda.CUDAGraph
    # Static copies of the call's tensors, in :func:`_tensors` order.
    inputs: List[torch.Tensor]
    states: StateBuffer
    launches: Counter
    # What the captured body returned: the engine's step-stacked health
    # figures; the collection's ring starts and the host cursors they hold.
    out: Any


def _tensors(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> List[torch.Tensor]:
    """The call's tensors in signature order (positionals, then keywords
    by name)."""
    out = [a for a in args if isinstance(a, torch.Tensor)]
    out.extend(kwargs[k] for k in sorted(kwargs) if isinstance(kwargs[k], torch.Tensor))
    return out


class GraphPrograms:
    """The captured programs of one owner over the states of ``members``
    (``{name: Metric}``): a bounded cache of programs under ``name``
    (``TORCHEVAL_TPU_TORCH_COMPILE_CACHE_CAP``; an evicted graph's memory
    pool goes with it), the state buffer they read and write, and the
    capture and replay sequence.  The owner's key is its own; its states'
    part comes from :meth:`states_key`."""

    def __init__(self, name: str, members: Mapping[str, Any]) -> None:
        # Lazy: the bounded program cache lives in the execution layer.
        from torcheval_tpu_torch.parallel._compile_cache import LruCache

        self._members = members
        self._cache = LruCache(name=name)
        self._states: Optional[StateBuffer] = None
        self._states_key: Optional[Tuple[Any, ...]] = None
        # What the members held of the buffer at the last states_key call.
        self._held: Optional[Dict[torch.dtype, torch.Tensor]] = None

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, key: Any) -> Any:
        return self._cache.get(key)

    def put(self, key: Any, value: Any) -> None:
        self._cache.put(key, value)

    def states_key(self, current: States, device: torch.device) -> Optional[Tuple[Any, ...]]:
        """The layout key of the members' ``current`` states, or ``None``
        where a state is not a tensor on ``device``.  Decides, for this
        call's replay, what the members hold of the buffer: its views or
        its last clone keep the buffer's key, other tensors are keyed by
        their signature."""
        self._held = None if self._states is None else self._states.held_in(current)
        if self._held is not None:
            return self._states_key
        if not all(
            isinstance(v, torch.Tensor) and v.device == device
            for per in current.values() for v in per.values()
        ):
            return None
        return tuple(
            (name, s, tuple(v.shape), str(v.dtype), str(v.device))
            for name, per in current.items() for s, v in per.items()
        )

    def buffer(self, states_key: Tuple[Any, ...], current: States, device: torch.device) -> StateBuffer:
        """The state buffer of the layout ``states_key``, made from
        ``current`` on ``device`` where the layout changed."""
        if states_key != self._states_key:
            self._states = StateBuffer(current, device)
            self._states_key = states_key
        return self._states

    def capture(
        self, key: Any, states_key: Tuple[Any, ...], current: States, args: Tuple[Any, ...],
        kwargs: Dict[str, Any], body: Callable[..., Any], warm: Callable[..., Any],
    ) -> Program:
        """Capture and keep the program of ``key``: ``body`` and ``warm``
        take the call's arguments with static copies of its tensors
        (``empty_like``, filled from them).  ``warm`` runs first on a side
        stream over scratch copies of ``current``, then the capture runs
        ``body`` with the members on the buffer's views and ends by writing
        back every state they rebound.  The members get ``current`` back
        whatever happens."""
        tensors = _tensors(args, kwargs)
        device = tensors[0].device
        states = self.buffer(states_key, current, device)

        def static(v):
            return torch.empty_like(v) if isinstance(v, torch.Tensor) else v

        s_args = tuple(static(a) for a in args)
        s_kwargs = {k: static(v) for k, v in kwargs.items()}
        inputs = _tensors(s_args, s_kwargs)
        torch._foreach_copy_(inputs, tensors)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(device)
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                install_states(self._members, clone_states(current))
                warm(s_args, s_kwargs)
            stream.wait_stream(side)
            install_states(self._members, states.views)
            with _build.recording() as launches:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = body(s_args, s_kwargs)
                    states.write_back(read_states(self._members))
        finally:
            # The members hold capture-time tensors of the graph's pool (or
            # scratch); put the caller's states back.
            install_states(self._members, current)
        program = Program(graph, inputs, states, launches, out)
        self._cache.put(key, program)
        return program

    def replay(
        self, program: Program, args: Tuple[Any, ...], kwargs: Dict[str, Any], current: States,
        donate: bool = False,
    ) -> None:
        """One replay of ``program`` on this call's tensors over the
        members' ``current`` states (those of the last :meth:`states_key`
        call); the members then hold the buffer's views (``donate``) or one
        clone of it.  If anything raises, they hold ``current``."""
        held = self._held if program.states is self._states else program.states.held_in(current)
        # The decision may name the last clone's flats: let them go with
        # the members' old views.
        self._held = None
        try:
            torch._foreach_copy_(program.inputs, _tensors(args, kwargs))
            program.states.copy_in(current, held)
            program.graph.replay()
        except BaseException:
            install_states(self._members, current)
            raise
        _build.count_replay(program.launches)
        install_states(
            self._members, program.states.views if donate else program.states.cloned())


# ------------------------------------------------------ collection replay
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
        self._members = members
        self.name = "graph[" + ",".join(members) + "].update"
        self._programs = GraphPrograms("collection_update", members)
        # The ring-window members, in member order: each reads its start
        # from its entry of the program's ``starts``.
        self._rings = tuple(n for n, m in members.items() if isinstance(m, RingWindowMixin))

    def read(self) -> States:
        return read_states(self._members)

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
        states_key = self._programs.states_key(current, device)
        if states_key is None:
            return None
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
        program = self._programs.get(key)
        how = "replay"
        if program is None:
            program = self._capture(key, args, kwargs, current)
            how = "capture"
        if self._rings:
            self._seed_starts(*program.out)
        self._programs.replay(program, args, kwargs, current)
        if self._rings:
            self._ring_bookkeeping(program.out[1], args, kwargs)
        _stats.count_member_updates(how, len(self._members))

    def _seed_starts(self, starts: torch.Tensor, cursors: List[int]) -> None:
        """Copy the ring members' cursors into a program's ``starts``
        unless it holds them already (the ``cursors`` its last replay
        left)."""
        now = [self._members[n].next_inserted for n in self._rings]
        if now != cursors:
            # A pinned tensor of the caching host allocator is not handed
            # out again before the copy from it has run.
            starts.copy_(torch.tensor(now, dtype=torch.int64, pin_memory=True), non_blocking=True)
        cursors.clear()

    def _ring_bookkeeping(self, cursors: List[int], args, kwargs) -> None:
        """After a replay: each ring member's host bookkeeping, in member
        order; the cursors it leaves are those the graph moved the
        program's ``starts`` to."""
        for name in self._rings:
            self._members[name]._update_host(*args, **kwargs)
        cursors.extend(self._members[n].next_inserted for n in self._rings)

    def _capture(self, key, args, kwargs, current: States) -> Program:
        # Zeros until the call copies the cursors in: a column of every
        # ring, so the warm-up's writes stay inside the rings.
        starts = (
            torch.zeros(len(self._rings), dtype=torch.int64, device=_tensors(args, kwargs)[0].device)
            if self._rings else None
        )
        start_of = {name: starts[i] for i, name in enumerate(self._rings)}

        def bodies(s_args, s_kwargs):
            with skip_value_checks():
                for name, m in self._members.items():
                    if name in start_of:
                        m._update_body(start_of[name], *s_args, **s_kwargs)
                        m._advance_start(start_of[name], *s_args, **s_kwargs)
                    else:
                        m._update_body(*s_args, **s_kwargs)
            return starts, []

        program = self._programs.capture(key, key[2], current, args, kwargs, bodies, bodies)
        _stats.bump_trace("collection_update")
        return program


__all__ = [
    "GraphPrograms", "GraphedUpdate", "Program", "StateBuffer", "clone_states",
    "install_states", "pairs", "read_states",
]
