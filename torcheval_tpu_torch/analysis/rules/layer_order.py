"""TPU002 layer-order: the declared layer DAG, enforced on the
module-level import graph.

The survey's architectural rule — "Lower layers never import higher
ones" (PAPER.md §1) — with the package-level order

    ops/native -> metrics -> engine/parallel/resilience/serve ->
    monitor/telemetry -> tools -> tests

refined to module granularity where the hook architecture demands it:
the **bus-leaf** modules (``telemetry.events``, ``telemetry.health``,
``telemetry.perfscope``, ``telemetry.trace``, ``telemetry.flightrec``,
``resilience.faults``) are foundation-layer by design.  Every layer holds their one-branch ``ENABLED`` hook sites, so
they must be importable from everywhere and import nothing back; the
telemetry *aggregation* side (``telemetry/__init__``, ``export``,
``aggregate``) and the quality monitor stay in the high observe layer.
``distributed`` (the collective-group substrate) and ``_stats`` are
foundation for the same reason.

Only **module-level** imports create layer edges: a lazy import inside
a function body defers resolution to call time and is the sanctioned
way for a low layer to reach optional high-layer functionality (the
engine's quality-publish hook, ops' routing warnings).  Cycles are
checked over the same module-level graph — any strongly-connected
component of size > 1 fails, whatever the layers say.

The port's table is JAX's re-rooted on ``torcheval_tpu_torch``, plus the
modules only the port has: ``ops._build`` (the kernel build and launch
counters, pinned exactly so that ``from ...ops import _build`` is an
edge to it and not to ``ops/__init__``), the kernel wrappers
``ops.{auc,binned,cm,mega,ustat,wavefront}``, the metric helpers
``metrics.functional._scatter`` / ``metrics.functional.image._precision``
/ ``metrics.ranking._scores``, and ``convert`` / ``flagship`` (tools).

The port's own boundary is part of the rule: no file of the port (nor
its GPU-host tooling) imports ``jax``, ``jaxlib`` or the JAX package
``torcheval_tpu`` — at module level or lazily — since the GPU host has
neither.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from .._core import Finding, Module, Rule, enclosing_function, register

LAYER_NAMES = (
    "foundation",  # hook buses, flags, collective substrate
    "kernels",  # ops / native
    "metrics",  # metric classes + functional + routing
    "execution",  # engine / parallel / resilience / aot
    "observe",  # telemetry aggregation + live monitor
    "tools",  # profiling, analysis, test utils
    "facade",  # the root torcheval_tpu_torch namespace
    "tests",  # everything outside the package (tests, scripts)
)

# Exact-module pins take priority over prefixes; longest prefix wins
# otherwise.  Keep this table in lockstep with docs/source/analysis.rst.
_ROOT = "torcheval_tpu_torch"

_EXACT: Dict[str, int] = {
    _ROOT: 6,
    f"{_ROOT}.version": 0,
    f"{_ROOT}._flags": 0,
    f"{_ROOT}._stats": 0,
    f"{_ROOT}.distributed": 0,
    f"{_ROOT}.routing": 2,
    f"{_ROOT}.aot": 3,
    f"{_ROOT}.telemetry.events": 0,
    f"{_ROOT}.telemetry.health": 0,
    f"{_ROOT}.telemetry.perfscope": 0,
    f"{_ROOT}.telemetry.trace": 0,
    f"{_ROOT}.telemetry.flightrec": 0,
    f"{_ROOT}.resilience.faults": 0,
    # Port-only modules.
    f"{_ROOT}.ops._build": 1,
    f"{_ROOT}.ops.auc": 1,
    f"{_ROOT}.ops.binned": 1,
    f"{_ROOT}.ops.cm": 1,
    f"{_ROOT}.ops.mega": 1,
    f"{_ROOT}.ops.ustat": 1,
    f"{_ROOT}.ops.wavefront": 1,
    f"{_ROOT}.metrics.functional._scatter": 2,
    f"{_ROOT}.metrics.functional.image._precision": 2,
    f"{_ROOT}.metrics.ranking._scores": 2,
    f"{_ROOT}.convert": 5,
    f"{_ROOT}.flagship": 5,
}

_PREFIX: Tuple[Tuple[str, int], ...] = (
    (f"{_ROOT}.ops._flags", 0),
    (f"{_ROOT}.ops", 1),
    (f"{_ROOT}.native", 1),
    (f"{_ROOT}.metrics", 2),
    (f"{_ROOT}.engine", 3),
    (f"{_ROOT}.parallel", 3),
    (f"{_ROOT}.resilience", 3),
    (f"{_ROOT}.serve", 3),
    (f"{_ROOT}.monitor", 4),
    (f"{_ROOT}.telemetry", 4),
    (f"{_ROOT}.tools", 5),
    (f"{_ROOT}.utils", 5),
    (f"{_ROOT}.analysis", 5),
)

# Packages the port never imports: JAX, and the JAX package this port
# is held against (its tests import both; the port imports neither).
_FOREIGN = ("jax", "jaxlib", "torcheval_tpu", "__graft_entry__")


def layer_of(module: str) -> Optional[int]:
    """Layer index for a dotted module, or None when outside the
    package (tests/scripts — the top layer, free to import anything,
    never imported by the package)."""
    if module in _EXACT:
        return _EXACT[module]
    best: Optional[int] = None
    best_len = -1
    for prefix, layer in _PREFIX:
        if (
            module == prefix or module.startswith(prefix + ".")
        ) and len(prefix) > best_len:
            best, best_len = layer, len(prefix)
    if best is None and _in_package(module):
        return 6  # unmapped package module rides with the facade
    return best


def _in_package(module: str) -> bool:
    return module == _ROOT or module.startswith(_ROOT + ".")


def _is_foreign(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in _FOREIGN)


def _foreign_imports(mod: Module) -> Iterable[Tuple[str, int, bool]]:
    """(module, lineno, lazy) for every import of a foreign package."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _is_foreign(alias.name):
                    lazy = enclosing_function(node) is not None
                    yield alias.name, node.lineno, lazy
        elif (
            isinstance(node, ast.ImportFrom)
            and not node.level
            and node.module
            and _is_foreign(node.module)
        ):
            yield node.module, node.lineno, enclosing_function(node) is not None


def _bound_by_port(mod: Module) -> bool:
    """The port's own files and its tooling: everything analyzed except
    tests, which import both packages on purpose."""
    head = mod.name.split(".")[0]
    return not (head == "tests" or head.startswith("test_") or head == "conftest")


def _module_level_imports(mod: Module) -> Iterable[Tuple[str, int]]:
    """(target_module, lineno) for every module-level intra-package
    import statement."""
    for node in ast.walk(mod.tree):
        if enclosing_function(node) is not None:
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _in_package(alias.name):
                    yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = mod.package.split(".") if mod.package else []
                drop = node.level - 1
                parts = (
                    parts[: len(parts) - drop]
                    if drop <= len(parts)
                    else []
                )
                if base:
                    parts.append(base)
                base = ".".join(parts)
            if not _in_package(base):
                continue
            # `from pkg import name`: name may be a submodule; count the
            # deeper target when that exact module carries its own pin
            # (events, health, _flags, ...) so bus-leaf imports land on
            # the leaf layer.  One edge per distinct target, not per
            # imported name.
            targets = set()
            for alias in node.names:
                deep = f"{base}.{alias.name}"
                targets.add(
                    deep if deep in _EXACT or _is_pinned(deep) else base
                )
            for target in sorted(targets):
                yield target, node.lineno


def _is_pinned(module: str) -> bool:
    return any(module == p for p, _ in _PREFIX)


class LayerOrderRule(Rule):
    code = "TPU002"
    name = "layer-order"
    summary = (
        "module-level imports must respect the layer DAG "
        "(lower layers never import higher ones) and stay acyclic"
    )

    def check_program(self, mods: List[Module]) -> List[Finding]:
        findings: List[Finding] = []
        graph: Dict[str, List[Tuple[str, int, str]]] = {}
        by_name = {m.name: m for m in mods}
        for mod in mods:
            src_layer = layer_of(mod.name)
            for target, lineno in _module_level_imports(mod):
                graph.setdefault(mod.name, []).append(
                    (target, lineno, mod.path)
                )
                if src_layer is None:
                    continue  # tests/scripts may import anything
                dst_layer = layer_of(target)
                if dst_layer is None or dst_layer <= src_layer:
                    continue
                findings.append(
                    Finding(
                        code=self.code,
                        path=mod.path,
                        line=lineno,
                        message=(
                            f"upward import: {mod.name} "
                            f"[{LAYER_NAMES[src_layer]}] imports {target} "
                            f"[{LAYER_NAMES[dst_layer]}] at module level; "
                            "lower layers never import higher ones "
                            "(make it a lazy function-level import or "
                            "move the dependency down)"
                        ),
                        scope="<module>",
                        symbol=target,
                    )
                )
        for mod in mods:
            if not _bound_by_port(mod):
                continue
            for target, lineno, lazy in _foreign_imports(mod):
                findings.append(
                    Finding(
                        code=self.code,
                        path=mod.path,
                        line=lineno,
                        message=(
                            f"port boundary: {mod.name} imports {target}"
                            + (" (lazily)" if lazy else "")
                            + "; the port and its GPU-host tooling import "
                            "neither jax nor the JAX package (the GPU host "
                            "has neither) — keep a copy of what is needed"
                        ),
                        scope="<module>",
                        symbol=f"foreign:{target}",
                    )
                )
        findings.extend(self._cycles(graph, by_name))
        return findings

    def _cycles(
        self,
        graph: Dict[str, List[Tuple[str, int, str]]],
        by_name: Dict[str, Module],
    ) -> List[Finding]:
        # Tarjan SCC over analyzed modules only (imports of modules not
        # in this run can't witness a cycle we can report precisely).
        adj: Dict[str, List[str]] = {}
        for src, edges in graph.items():
            for target, _, _ in edges:
                dst = self._resolve_to_analyzed(target, by_name)
                if dst and dst != src:
                    adj.setdefault(src, []).append(dst)
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        stack: List[str] = []
        on_stack: set = set()
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in adj.get(v, []):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

        for v in sorted(set(adj) | {w for ws in adj.values() for w in ws}):
            if v not in index:
                strongconnect(v)
        findings = []
        for comp in sccs:
            head = comp[0]
            mod = by_name.get(head)
            line = 1
            if mod is not None:
                for target, lineno, _ in graph.get(head, []):
                    if self._resolve_to_analyzed(target, by_name) in comp:
                        line = lineno
                        break
            findings.append(
                Finding(
                    code=self.code,
                    path=mod.path if mod else head,
                    line=line,
                    message=(
                        "import cycle at module level: "
                        + " <-> ".join(comp)
                    ),
                    scope="<module>",
                    symbol="cycle:" + ",".join(comp),
                )
            )
        return findings

    @staticmethod
    def _resolve_to_analyzed(
        target: str, by_name: Dict[str, Module]
    ) -> Optional[str]:
        """Map an import target onto an analyzed module: exact hit, or
        the nearest analyzed ancestor package (`from pkg import name`
        executes pkg/__init__)."""
        cur = target
        while cur:
            if cur in by_name:
                return cur
            cur = cur.rpartition(".")[0]
        return None


register(LayerOrderRule())
