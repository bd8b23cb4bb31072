"""TPU004 donation-safety — **out of scope in the port; not registered.**

Why the port does not run this rule: its premise does not exist under
torch.  JAX deletes a buffer handed to a ``donate_argnums`` program, and
a later read raises.  torch never deletes a tensor handed to a call.
The port's ``donate=`` (``ops/mega.py``, ``engine/scan.py``,
``telemetry/perfscope.py``) means an in-place add into the caller's
state tensors, and reading those tensors after the call is the intended
use.  The code below is JAX's, kept unregistered so every other rule
keeps JAX's code number; ``--select TPU004`` is an unknown code (exit
2) and ``--list-rules`` says why.

JAX's description, for the record:

TPU004 donation-safety: no reads of a buffer after it was donated.

``jax.jit(f, donate_argnums=(0,))`` marks argument 0's buffers for
reuse: after the wrapped call, the donated arrays are *deleted* and any
later host-side access raises ``RuntimeError: Array has been deleted``
— but only at run time, and only on platforms that honour donation
(TPU does, CPU silently doesn't, which is exactly how these bugs
survive CPU test suites and detonate on chip).

The rule resolves donating callables flow-insensitively:

- ``g = jax.jit(f, donate_argnums=(0, 2))`` — bare name or attribute
  chain target (``self._fused_apply = jax.jit(...)``); the donated
  index set is the set of integer constants found under the
  ``donate_argnums`` keyword (a conditional ``(0,) if donate else ()``
  counts as *possibly donating* index 0 — the read is unsafe on any
  path where donation happened),
- immediate calls ``jax.jit(f, donate_argnums=(0,))(x)``.

Within each function, statements are scanned in document order: a call
to a donating callable marks its positional ``Name`` arguments at the
donated indices; any later load of a marked name in the same function
is flagged until the name is rebound.  Reads in ``except`` handlers
count — an abort-restore path that deliberately touches donated
buffers must prove it guards deletion and carry an inline suppression
saying so.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .._core import (
    Finding,
    Module,
    Rule,
    dotted_name,
    register,
    scope_qualname,
)

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)
_JIT_CHAINS = {"jax.jit", "jit"}


def _donated_indices(call: ast.Call) -> Optional[Set[int]]:
    """Donated argnums if ``call`` is a jit(...) with donate_argnums."""
    if dotted_name(call.func) not in _JIT_CHAINS:
        return None
    for kw in call.keywords:
        if kw.arg != "donate_argnums":
            continue
        idx = {
            n.value
            for n in ast.walk(kw.value)
            if isinstance(n, ast.Constant) and isinstance(n.value, int)
        }
        return idx or None
    return None


def _collect_donating_callables(tree: ast.AST) -> Dict[str, Set[int]]:
    """dotted assignment target -> donated indices, module-wide."""
    out: Dict[str, Set[int]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        if not isinstance(node.value, ast.Call):
            continue
        idx = _donated_indices(node.value)
        if not idx:
            continue
        target = dotted_name(node.targets[0])
        if target:
            out[target] = idx
    return out


def _statements_in_order(fn: ast.AST) -> Iterable[ast.stmt]:
    """Pre-order statement walk of ``fn``'s body, skipping nested
    function/class bodies (their locals are a different timeline)."""

    def visit(stmts: List[ast.stmt]) -> Iterable[ast.stmt]:
        for st in stmts:
            yield st
            if isinstance(st, _FuncDef + (ast.ClassDef,)):
                continue
            for field in (
                "body",
                "orelse",
                "finalbody",
            ):
                yield from visit(getattr(st, field, []) or [])
            for handler in getattr(st, "handlers", []) or []:
                yield from visit(handler.body)

    yield from visit(fn.body)


def _expr_nodes(stmt: ast.stmt) -> Iterable[ast.AST]:
    """All nodes of ``stmt`` excluding nested function/class bodies."""
    work: List[ast.AST] = [stmt]
    while work:
        node = work.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FuncDef + (ast.ClassDef,)):
                continue
            work.append(child)


class DonationSafetyRule(Rule):
    code = "TPU004"
    name = "donation-safety"
    summary = (
        "a buffer passed at a donated argnum is deleted by the call; "
        "reading it afterwards raises on TPU"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        donors = _collect_donating_callables(mod.tree)
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, _FuncDef):
                findings.extend(self._check_function(mod, node, donors))
        return findings

    def _check_function(
        self,
        mod: Module,
        fn: ast.AST,
        module_donors: Dict[str, Set[int]],
    ) -> List[Finding]:
        donors = dict(module_donors)
        findings: List[Finding] = []
        # name -> (donation lineno, callable spelled)
        donated: Dict[str, Tuple[int, str]] = {}
        for stmt in _statements_in_order(fn):
            # Local donating-callable bindings shadow module-wide ones.
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                if isinstance(stmt.value, ast.Call):
                    idx = _donated_indices(stmt.value)
                    target = dotted_name(stmt.targets[0])
                    if idx and target:
                        donors[target] = idx

            now_donated: List[Tuple[str, int, str]] = []
            donating_arg_ids: Set[int] = set()
            for node in _expr_nodes(stmt):
                if not isinstance(node, ast.Call):
                    continue
                idx: Optional[Set[int]] = None
                spelled = dotted_name(node.func)
                if spelled in donors:
                    idx = donors[spelled]
                elif isinstance(node.func, ast.Call):
                    idx = _donated_indices(node.func)
                    spelled = spelled or "jax.jit(...)"
                if not idx:
                    continue
                for i, arg in enumerate(node.args):
                    if i in idx and isinstance(arg, ast.Name):
                        now_donated.append(
                            (arg.id, node.lineno, spelled or "<donor>")
                        )
                        donating_arg_ids.add(id(arg))

            # Reads of already-donated names (the donating call's own
            # argument occurrence is the donation, not a read).
            for node in _expr_nodes(stmt):
                if (
                    isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in donated
                    and id(node) not in donating_arg_ids
                ):
                    don_line, spelled = donated[node.id]
                    findings.append(
                        Finding(
                            code=self.code,
                            path=mod.path,
                            line=node.lineno,
                            message=(
                                f"`{node.id}` was donated to "
                                f"`{spelled}` on line {don_line}; its "
                                "buffer is deleted after that call and "
                                "this read raises on TPU (copy before "
                                "the call, or rebind from the result)"
                            ),
                            scope=scope_qualname(node),
                            symbol=node.id,
                        )
                    )

            for name, lineno, spelled in now_donated:
                donated[name] = (lineno, spelled)

            # Rebinding clears the taint — after recording this
            # statement's donations, so `state = apply(state)` (donate
            # and rebind from the result) comes out clean.
            for node in _expr_nodes(stmt):
                if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    donated.pop(node.id, None)
        return findings


# Not registered: see the module docstring.
OUT_OF_SCOPE = (
    "TPU004",
    "donation-safety",
    "out of scope in the port: torch never deletes a tensor handed to a "
    "call, and the port's donate= is an in-place add into the caller's "
    "states, read after the call on purpose",
)
