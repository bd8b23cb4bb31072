"""TPU011 pad-neutrality: a traced state write in a mask-accepting
update path must degenerate to a no-op when every row is masked.

The scan engine runs the update body for *every* block, including the
ragged tail where a block may contain zero live rows.  A stateful
monitor (decay, windowing) that rescales or overwrites its state
unconditionally therefore corrupts state on all-padding steps — the
canonical guard is ``factor = torch.where(mask.sum() > 0, decay, 1.0)``
so the write is exactly identity when nothing is live.

The check evaluates each read-modify-write's right-hand side under the
all-masked abstraction from the dataflow interpreter (mask = zeros, so
``sum(mask) > 0`` is statically false and ``where`` picks its else
branch).  The write is neutral iff the abstract value collapses back to
IDENT — the state reads itself times one, plus zero.  Three write
shapes are recognized: ``obj.attr = ...obj.attr...``, ``obj.attr op=
expr``, and ``setattr(obj, n, ...getattr(obj, n)...)``.  Writes whose
value routes through an opaque call are exempt: the callee owns the
neutrality proof (e.g. delegating to ``accumulate``), and plain
overwrites that never read the old state are a different contract
(initialization), out of scope here.
"""

from __future__ import annotations

from typing import List

from .._core import (
    Finding,
    Module,
    Rule,
    module_dataflow,
    register,
    scope_qualname,
)


class PadNeutralityRule(Rule):
    code = "TPU011"
    name = "pad-neutrality"
    summary = (
        "read-modify-write state updates in mask-accepting paths must "
        "be identity when the whole block is masked (ragged tail steps)"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for summary in module_dataflow(mod):
            for write in summary.nonneutral_writes:
                findings.append(
                    Finding(
                        code=self.code,
                        path=mod.path,
                        line=write.node.lineno,
                        message=(
                            f"state write to {write.symbol} is not a "
                            f"no-op when every row is masked (abstract "
                            f"value '{write.detail}', expected identity)"
                            f"; gate the factor with torch.where("
                            f"any_valid, ..., neutral)"
                        ),
                        scope=scope_qualname(summary.func),
                        symbol=write.symbol,
                    )
                )
        return findings


register(PadNeutralityRule())
