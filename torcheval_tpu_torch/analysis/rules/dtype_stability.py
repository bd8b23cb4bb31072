"""TPU012 dtype-stability: no float64 widening in captured or masked
update paths, and no int-state arithmetic against float factors without
the sanctioned float32 normalization.

Two prongs, one contract — the dtype a state was declared with is the
dtype it keeps:

* **float64 widening** (prong A): a literal ``torch.float64`` /
  ``torch.double`` dtype, ``x.double()``, ``.to(torch.float64)`` or
  ``np.float64(x)`` in a hot update path.  Unlike JAX with ``x64`` off,
  torch never narrows it back: the tensor really is double-width, every
  buffer it feeds doubles its bytes, and an H100 runs float64 at a
  fraction of its float32 rate.  Checked inside functions reachable
  from a CUDA-graph capture (the TPU003 region set) and inside
  mask-accepting update kernels.

* **int-state float arithmetic** (prong B): a monitor that multiplies
  integer state by a float factor (``setattr(inner, name,
  getattr(inner, name) * factor)``) relies on the owning class casting
  that state to float32 up front — otherwise type promotion changes the
  state's dtype on the first step.  The dataflow walk records every
  state×float read-modify-write; the rule fires only when the enclosing
  class body contains no sanctioned float32 cast (``.float()``,
  ``.to(torch.float32)``, ``dtype=torch.float32``, or numpy's
  ``astype(np.float32)``), i.e. nothing establishes the float32
  invariant the multiply depends on.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .._core import (
    Finding,
    Module,
    Rule,
    dotted_name,
    find_float64_widening,
    is_mask_accepting,
    module_dataflow,
    register,
    scope_qualname,
)
from .traced import traced_functions

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

_F32_CHAINS = {
    "np.float32",
    "numpy.float32",
    "torch.float32",
    "torch.float",
}


def _class_has_float32_cast(cls: ast.ClassDef) -> bool:
    """True when the class body normalizes *state* to float32: a
    ``.float()``, a ``.to`` / ``astype`` to float32 or a
    ``dtype=float32`` keyword.  A bare ``np.float32(...)`` scalar
    constructor does NOT count — that is how the hazardous factor
    itself is spelled, not how state gets its dtype established."""
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "float"
            and not node.args
            and not node.keywords
        ):
            return True
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("astype", "to")
            and node.args
        ):
            arg = node.args[0]
            if dotted_name(arg) in _F32_CHAINS:
                return True
            if isinstance(arg, ast.Constant) and arg.value == "float32":
                return True
        for kw in node.keywords:
            if kw.arg == "dtype":
                if dotted_name(kw.value) in _F32_CHAINS:
                    return True
                if (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value == "float32"
                ):
                    return True
    return False


def _enclosing_classes(tree: ast.AST) -> Dict[int, ast.ClassDef]:
    """id(funcdef) -> nearest enclosing ClassDef, module-wide."""
    out: Dict[int, ast.ClassDef] = {}

    def visit(node: ast.AST, cls: Optional[ast.ClassDef]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child)
            else:
                if isinstance(child, _FuncDef) and cls is not None:
                    out[id(child)] = cls
                visit(child, cls)

    visit(tree, None)
    return out


class DtypeStabilityRule(Rule):
    code = "TPU012"
    name = "dtype-stability"
    summary = (
        "no literal float64 widening in traced regions; int-state "
        "float arithmetic requires the class's sanctioned float32 cast"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        self._check_widening(mod, findings)
        self._check_state_mults(mod, findings)
        return findings

    def _check_widening(self, mod: Module, findings: List[Finding]) -> None:
        scoped: Dict[int, ast.AST] = {
            key: fn for key, (fn, _origin) in traced_functions(mod).items()
        }
        for node in ast.walk(mod.tree):
            if isinstance(node, _FuncDef) and is_mask_accepting(node):
                scoped.setdefault(id(node), node)
        for fn in scoped.values():
            for call, spelled in find_float64_widening(fn):
                findings.append(
                    Finding(
                        code=self.code,
                        path=mod.path,
                        line=call.lineno,
                        message=(
                            f"float64 widening ({spelled}) in a captured "
                            f"or masked update path: the tensor really is "
                            f"double-width (twice the bytes, a fraction of "
                            f"the card's float32 rate) — spell the "
                            f"intended dtype (float32) explicitly"
                        ),
                        scope=scope_qualname(fn),
                        symbol=spelled,
                    )
                )

    def _check_state_mults(
        self, mod: Module, findings: List[Finding]
    ) -> None:
        classes = _enclosing_classes(mod.tree)
        sanctioned: Dict[int, bool] = {}
        for summary in module_dataflow(mod):
            if not summary.float_state_mults:
                continue
            cls = classes.get(id(summary.func))
            if cls is not None:
                ok = sanctioned.get(id(cls))
                if ok is None:
                    ok = _class_has_float32_cast(cls)
                    sanctioned[id(cls)] = ok
                if ok:
                    continue
            for mult in summary.float_state_mults:
                where = f"class {cls.name}" if cls is not None else "module"
                findings.append(
                    Finding(
                        code=self.code,
                        path=mod.path,
                        line=mult.node.lineno,
                        message=(
                            f"state {mult.symbol} is multiplied by a "
                            f"float factor but {where} never casts "
                            f"state to float32; integer state would "
                            f"silently promote on the first step — "
                            f"normalize with .float() / "
                            f".to(torch.float32) at registration"
                        ),
                        scope=scope_qualname(summary.func),
                        symbol=f"{mult.symbol}*float",
                    )
                )


register(DtypeStabilityRule())
