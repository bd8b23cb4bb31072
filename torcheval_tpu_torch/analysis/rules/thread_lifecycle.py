"""TPU008: thread-lifecycle — no leaked or unstoppable threads.

Two findings per the tentpole contract:

- **leak**: a ``threading.Thread``/``Timer`` constructed neither
  ``daemon=True`` nor with a reachable ``join()``/``cancel()`` path
  (searched on the stored handle across the module for attribute
  bindings, within the constructing function for locals).  A
  non-daemon thread with no join pins interpreter shutdown; a daemon
  thread with no join is an explicit, documented choice (the reaper
  threads in ``resilience/retry.py``).
- **unstoppable loop**: a ``while True`` in a thread-entry-reachable
  function whose body has no ``break``/``return``/``raise``/``yield``
  and never consults a stop signal (``Event.is_set``/``wait``) — once
  started, nothing the owner does can end the run loop.
"""

from __future__ import annotations

import ast
from typing import List

from .._core import (
    Finding,
    Module,
    Rule,
    _owned_nodes,
    concurrency_model,
    register,
)

_STOP_CONSULTS = {"is_set", "wait", "get", "get_nowait"}


def _loop_has_exit(loop: ast.While) -> bool:
    for n in ast.walk(loop):
        if n is loop:
            continue
        if isinstance(n, (ast.Break, ast.Return, ast.Raise, ast.Yield,
                          ast.YieldFrom)):
            return True
        if isinstance(n, ast.While) and n is not loop:
            continue
        if isinstance(n, ast.Attribute) and n.attr in _STOP_CONSULTS:
            return True
    return False


class ThreadLifecycleRule(Rule):
    code = "TPU008"
    name = "thread-lifecycle"
    summary = (
        "every Thread is daemonized or joined/cancelled, and thread "
        "run loops consult a stop signal"
    )

    def check_program(self, mods: List[Module]) -> List[Finding]:
        model = concurrency_model(mods)
        findings: List[Finding] = []

        for site in model.thread_sites:
            if site.daemon:
                continue
            joined = False
            if site.binding is not None:
                if site.binding_is_attr:
                    joined = site.binding in model.joins.get(
                        site.module, set()
                    )
                else:
                    # local handle: any join/cancel in the same function
                    joined = site.func_key in model.join_funcs
            if not joined:
                what = "Timer" if site.kind == "timer" else "Thread"
                findings.append(
                    Finding(
                        code=self.code,
                        path=site.path,
                        line=site.line,
                        scope=site.scope,
                        symbol=site.binding or site.kind,
                        message=(
                            f"{what} is neither daemon=True nor "
                            "joined/cancelled on any reachable path — "
                            "it outlives its owner and pins shutdown"
                        ),
                    )
                )

        # ---- unstoppable run loops in thread-reachable code
        seen_loops = set()
        for key, reason in sorted(model.concurrent.items()):
            fi = model.functions.get(key)
            if fi is None or fi.node is None:
                continue
            for n in _owned_nodes(fi.node):
                if not isinstance(n, ast.While):
                    continue
                test_true = (
                    isinstance(n.test, ast.Constant) and bool(n.test.value)
                )
                if not test_true or id(n) in seen_loops:
                    continue
                seen_loops.add(id(n))
                if not _loop_has_exit(n):
                    findings.append(
                        Finding(
                            code=self.code,
                            path=fi.path,
                            line=n.lineno,
                            scope=fi.qualname,
                            symbol="while_true",
                            message=(
                                "`while True` run loop on a concurrent "
                                "path has no break/return and never "
                                "consults a stop Event — the thread "
                                f"cannot be stopped ({reason})"
                            ),
                        )
                    )
        return findings


register(ThreadLifecycleRule())
