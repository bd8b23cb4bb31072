"""TPU007: lock-order — deadlock potential, proven on the global
acquisition graph.

Two findings:

- **cycle**: lock B acquired while A is held somewhere, and A acquired
  while B is held somewhere else — two threads taking the two paths
  deadlock.  Re-acquiring a non-reentrant ``Lock``/``Condition``
  already held is the one-lock cycle and reported the same way.
- **blocking-while-holding**: an unbounded blocking call — ``join``,
  ``queue.get``/``put``, ``Event``/``Barrier``/``Condition`` waits,
  ``time.sleep``, or one of the repo's object collectives — issued
  while a lock is held.  Every other thread that needs that lock now
  waits on the blocked peer's progress; with collectives in the mix
  that is a distributed deadlock.  A ``Condition.wait`` holding only
  its own condition is the sanctioned shape (wait releases it).

Held sets include caller propagation: a helper only ever called under
``_lock`` blocks "while holding" even though the ``with`` is a frame up.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Set, Tuple

from .._core import (
    Finding,
    LockId,
    Module,
    Rule,
    concurrency_model,
    register,
)


class LockOrderRule(Rule):
    code = "TPU007"
    name = "lock-order"
    summary = (
        "no cycles in the global lock-acquisition graph; no unbounded "
        "blocking calls while a different lock is held"
    )

    def check_program(self, mods: List[Module]) -> List[Finding]:
        model = concurrency_model(mods)
        findings: List[Finding] = []

        # ---- acquisition graph: edge (outer -> inner) per site
        edges: Dict[Tuple[LockId, LockId], List] = {}
        for acq in model.acquisitions:
            outer_set = acq.held_before | model.entry_held.get(
                acq.func_key, frozenset()
            )
            for outer in outer_set:
                edges.setdefault((outer, acq.lock), []).append(acq)

        def reaches(src: LockId, dst: LockId) -> bool:
            seen: Set[LockId] = set()
            stack = [src]
            while stack:
                cur = stack.pop()
                if cur == dst:
                    return True
                if cur in seen:
                    continue
                seen.add(cur)
                stack.extend(b for (a, b) in edges if a == cur)
            return False

        for (outer, inner), acqs in sorted(edges.items()):
            for acq in acqs:
                if outer == inner:
                    if model.locks.get(inner) != "rlock":
                        findings.append(
                            Finding(
                                code=self.code,
                                path=acq.path,
                                line=acq.line,
                                scope=acq.scope,
                                symbol=inner[2],
                                message=(
                                    f"re-acquiring non-reentrant "
                                    f"`{model.lock_label(inner)}` while "
                                    "already holding it (self-deadlock)"
                                ),
                            )
                        )
                elif reaches(inner, outer):
                    findings.append(
                        Finding(
                            code=self.code,
                            path=acq.path,
                            line=acq.line,
                            scope=acq.scope,
                            symbol=f"{outer[2]}->{inner[2]}",
                            message=(
                                f"acquiring `{model.lock_label(inner)}` "
                                f"while holding "
                                f"`{model.lock_label(outer)}` completes "
                                "a cycle in the lock-acquisition graph "
                                "(deadlock potential: another path "
                                "takes them in the opposite order)"
                            ),
                        )
                    )

        # ---- blocking while holding
        for b in model.blocking:
            held: FrozenSet[LockId] = b.held | model.entry_held.get(
                b.func_key, frozenset()
            )
            if b.exempt is not None:
                held = held - {b.exempt}
            if not held:
                continue
            locks_label = ", ".join(
                sorted(model.lock_label(lk) for lk in held)
            )
            findings.append(
                Finding(
                    code=self.code,
                    path=b.path,
                    line=b.line,
                    scope=b.scope,
                    symbol=b.label.split(".")[-1].rstrip("()"),
                    message=(
                        f"unbounded blocking call `{b.label}` while "
                        f"holding `{locks_label}` — every thread that "
                        "needs the lock now waits on this call's peer"
                    ),
                )
            )
        return findings


register(LockOrderRule())
