"""TPU006: lock-discipline — inferred guard consistency.

The contract: an attribute or module global that is accessed under a
lock at any site is *guarded* by that lock, and every other access on a
concurrent path must hold the same lock.  The association is inferred
from the code (``_infer_guards`` in ``_core``), never annotated:

- fields never written outside ``__init__`` are immutable-after-
  publication and exempt;
- fields never accessed under any lock are lock-free by design (the
  one-branch ``ENABLED`` flags, barrier-synchronized slots) and exempt;
- sync primitives themselves (locks, events, queues) are exempt.

What remains is a field the code itself declares lock-guarded; reading
or writing it outside the lock from a concurrent context is a data
race (torn iteration of a rebound ring, lost counter increments).
"""

from __future__ import annotations

from typing import List

from .._core import Finding, Module, Rule, concurrency_model, register


class LockDisciplineRule(Rule):
    code = "TPU006"
    name = "lock-discipline"
    summary = (
        "a field accessed under a lock anywhere must hold the same "
        "lock at every concurrent site (guard inferred, not annotated)"
    )

    def check_program(self, mods: List[Module]) -> List[Finding]:
        model = concurrency_model(mods)
        findings: List[Finding] = []
        for fid in sorted(model.guards):
            guards = model.guards[fid]
            locks_label = ", ".join(
                sorted(model.lock_label(lk) for lk in guards)
            )
            for a in model.fields[fid]:
                if a.in_init or (model.held_for(a) & guards):
                    continue
                reason = model.concurrent.get(a.func_key)
                if reason is None:
                    continue
                verb = "written" if a.write else "read"
                findings.append(
                    Finding(
                        code=self.code,
                        path=a.path,
                        line=a.line,
                        scope=a.scope,
                        symbol=fid[2],
                        message=(
                            f"`{model.field_label(fid)}` is {verb} "
                            f"without `{locks_label}`, which guards it "
                            f"at its other sites ({reason})"
                        ),
                    )
                )
        return findings


register(LockDisciplineRule())
