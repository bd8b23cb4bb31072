"""TPU009: check-then-act — a guard lock must span the test AND the
mutation it authorizes.

The racy shapes, on a field the code elsewhere treats as lock-guarded
(the TPU006 association):

- **hoisted check**: the test reads the field outside the lock, the
  branch body mutates it (even if the mutation re-takes the lock) —
  two threads both pass the stale test;
- **split lock**: test under one ``with``, mutation under a *second*
  ``with`` — the field can change in the released window between them;
- **bail-early**: ``if <reads F>: return`` outside the lock followed by
  a mutation of F later in the same block.

A test is spanned (and exempt) when one acquisition covers both ends:
the same ``with`` block is an ancestor of test and write, or a caller
holds the guard around the whole function (``entry_held``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .._core import (
    Access,
    Finding,
    Module,
    Rule,
    concurrency_model,
    parent,
    register,
)

_TERMINAL = (ast.Return, ast.Raise, ast.Break, ast.Continue)


def _test_ancestor(node: ast.AST) -> Optional[ast.stmt]:
    """The If/While whose *test* contains ``node``, if any."""
    prev, cur = node, parent(node)
    while cur is not None:
        if isinstance(cur, (ast.If, ast.While)) and cur.test is prev:
            return cur
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        prev, cur = cur, parent(cur)
    return None


def _subtree_ids(nodes) -> Set[int]:
    out: Set[int] = set()
    for n in nodes:
        for d in ast.walk(n):
            out.add(id(d))
    return out


def _trailing_siblings(stmt: ast.stmt) -> List[ast.stmt]:
    """Statements after ``stmt`` in its enclosing block."""
    p = parent(stmt)
    if p is None:
        return []
    for attr in ("body", "orelse", "finalbody"):
        block = getattr(p, attr, None)
        if isinstance(block, list) and stmt in block:
            i = block.index(stmt)
            return block[i + 1 :]
    return []


def _is_ancestor(anc: ast.AST, node: ast.AST) -> bool:
    cur = node
    while cur is not None:
        if cur is anc:
            return True
        cur = parent(cur)
    return False


class CheckThenActRule(Rule):
    code = "TPU009"
    name = "check-then-act"
    summary = (
        "read-test-write sequences on lock-guarded state must be "
        "spanned by one acquisition of the guard"
    )

    def check_program(self, mods: List[Module]) -> List[Finding]:
        model = concurrency_model(mods)
        findings: List[Finding] = []
        reported: Set[tuple] = set()

        for fid in sorted(model.guards):
            guards = model.guards[fid]
            accesses = model.fields[fid]
            writes = [a for a in accesses if a.write and not a.in_init]
            if not writes:
                continue
            for a in accesses:
                if a.write or a.in_init:
                    continue
                test_stmt = _test_ancestor(a.node)
                if test_stmt is None:
                    continue
                key = (id(test_stmt), fid)
                if key in reported:
                    continue
                # writes this test can authorize: in the branch body,
                # or after a terminating branch (bail-early)
                scope_ids = _subtree_ids(
                    list(test_stmt.body) + list(
                        getattr(test_stmt, "orelse", [])
                    )
                )
                body = test_stmt.body
                if body and isinstance(body[-1], _TERMINAL):
                    scope_ids |= _subtree_ids(
                        _trailing_siblings(test_stmt)
                    )
                acted = [
                    w
                    for w in writes
                    if w.func_key == a.func_key and id(w.node) in scope_ids
                ]
                if not acted:
                    continue
                if self._spanned(model, guards, a, acted):
                    continue
                reported.add(key)
                locks_label = ", ".join(
                    sorted(model.lock_label(lk) for lk in guards)
                )
                findings.append(
                    Finding(
                        code=self.code,
                        path=a.path,
                        line=test_stmt.lineno,
                        scope=a.scope,
                        symbol=fid[2],
                        message=(
                            f"check-then-act on `{model.field_label(fid)}`"
                            f": the test and the mutation it authorizes "
                            f"are not spanned by one acquisition of "
                            f"`{locks_label}` — the field can change "
                            "between check and act"
                        ),
                    )
                )
        return findings

    @staticmethod
    def _spanned(model, guards, test_access: Access, acted) -> bool:
        # caller holds the guard around the whole function
        if model.entry_held.get(
            test_access.func_key, frozenset()
        ) & guards:
            return True
        # one `with` acquiring a guard lock covers test and every write
        cur = parent(test_access.node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if model.with_locks.get(id(cur), frozenset()) & guards:
                if all(_is_ancestor(cur, w.node) for w in acted):
                    return True
            cur = parent(cur)
        return False


register(CheckThenActRule())
