"""TPU010 mask-discipline: a mask-accepting function must thread its
validity mask into every full reduction over padded batch data.

The bucketing engine pads every batch up to its bucket's row count, so
each update kernel receives a ``mask`` (or pulls one out of ``kwargs``)
marking which rows are live.  A full reduction (``torch.sum``,
``.sum()``, ``index_add_`` / ``scatter_add_``, ``torch.bincount``, the
port's ``_scatter.at_add``) over a value derived only from the
padded data arguments — never combined with the mask — counts the pad
rows as real rows.  The bug is silent: results are merely wrong, and
only on batches that actually got padded, which is exactly the case unit
tests with bucket-sized batches never exercise.

The check runs the mask-present abstract walk from
:func:`torcheval_tpu_torch.analysis._core.module_dataflow`: every
parameter seeds ``raw`` provenance, the mask seeds ``mask`` provenance,
and any expression combining the two (``correct * mask.to(...)``,
``torch.where(valid, x, 0)``, a call handed the mask) is mask-clean.
Only reductions whose operand is provably raw-without-mask fire.
Row-wise reductions with an explicit non-leading constant dimension
(``dim=1`` / ``dim=-1``) are exempt — they do not collapse padded rows into live
ones.  Reductions inside ``if mask is None:`` fast paths are skipped:
the unmasked path owes no mask discipline.
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


class MaskDisciplineRule(Rule):
    code = "TPU010"
    name = "mask-discipline"
    summary = (
        "full reductions in mask-accepting functions must thread the "
        "validity mask (padded rows count as real rows otherwise)"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for summary in module_dataflow(mod):
            for red in summary.raw_reductions:
                findings.append(
                    Finding(
                        code=self.code,
                        path=mod.path,
                        line=red.node.lineno,
                        message=(
                            f"reduction {red.symbol} over padded batch "
                            f"data drops the validity mask; combine "
                            f"{red.operand} with the mask (multiply, "
                            f"torch.where, or a masked helper) before "
                            f"reducing"
                        ),
                        scope=scope_qualname(summary.func),
                        symbol=red.symbol,
                    )
                )
        return findings


register(MaskDisciplineRule())
