"""TPU001 hook-guard: telemetry/health/faults/perfscope/quality entry
points must be dominated by their ``ENABLED`` branch.

The zero-cost-when-off contract (``telemetry/events.py``) is that a
disabled bus costs one module-attribute read and one branch per hook
site.  ``chip_smoke.py``'s hook-map phase proves it *empirically* on
the card for the hot paths it drives; this rule proves it
*statically* for every call site in the tree: a call to a hook entry
point that is not dominated by the right ``ENABLED`` guard is a finding
whether or not any workload exercises it.

Recognized guard shapes (all observed in this repo):

- ``if _telemetry.ENABLED:`` (including ``... and extra`` /
  ``... or other.ENABLED`` conjunctions — any positive mention counts);
- early exit: ``if not _telemetry.ENABLED: return ...`` followed by the
  hook later in the same block (also raise/continue/break);
- conditional expression: ``x if _telemetry.ENABLED else y``;
- a local flag: ``health = _health.ENABLED`` then ``if health:`` — the
  flag may be read from an enclosing (closure) scope, which is how the
  fused-update builder threads the monitor flag into its traced body;
- ``module.enabled()`` calls, equivalent to the attribute read.

Guard equivalences: each hook module guards on its own flag, except
``monitor.quality`` whose documented contract is to be gated on the
*event bus* flag (``telemetry.events.ENABLED``) — a quality reading is
just another event.  The event module's span entry points guard on its
other flags: ``timed_phase`` / ``member_phase`` on ``SPANS`` (the bus or
the profiler ranges on) and ``span`` on ``ANNOTATE`` (the ranges on);
the shapes above hold for them with that flag in place of ``ENABLED``.

Dominance is checked lexically within the enclosing function: a hook
wrapped in a helper whose *callers* hold the branch cannot be proven
here and needs an inline ``# tpulint: disable=TPU001 -- why`` or a
baseline entry (that is a feature: every such site gets a recorded
justification).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .._core import (
    Finding,
    Module,
    Rule,
    dotted_name,
    enclosing_function,
    parent,
    register,
    resolve_chain,
    scope_qualname,
)


@dataclass(frozen=True)
class HookSpec:
    module: str  # fully-dotted defining module
    names: FrozenSet[str]  # explicit entry-point names
    record_prefix: bool  # also match any discovered record_* name
    guard_modules: FrozenSet[str]  # whose flag dominates these hooks
    runtime_ns: str  # prefix of the hook-map check's counting wrappers
    # The module flags (attribute names) that guard these hooks.
    guard_flags: FrozenSet[str] = frozenset({"ENABLED"})

    @property
    def guards(self) -> FrozenSet[Tuple[str, str]]:
        """Every accepted (module, flag) guard of these hooks."""
        return frozenset(
            (m, f) for m in self.guard_modules for f in self.guard_flags
        )


_EVENTS = "torcheval_tpu_torch.telemetry.events"
_HEALTH = "torcheval_tpu_torch.telemetry.health"
_PERFSCOPE = "torcheval_tpu_torch.telemetry.perfscope"
_FAULTS = "torcheval_tpu_torch.resilience.faults"
_QUALITY = "torcheval_tpu_torch.monitor.quality"
_TRACE = "torcheval_tpu_torch.telemetry.trace"
_FLIGHTREC = "torcheval_tpu_torch.telemetry.flightrec"
_AUTOTUNE = "torcheval_tpu_torch.routing_autotune"
_METERING = "torcheval_tpu_torch.serve.metering"

HOOK_SPECS: Tuple[HookSpec, ...] = (
    HookSpec(
        module=_EVENTS,
        names=frozenset({"emit"}),
        record_prefix=True,
        guard_modules=frozenset({_EVENTS}),
        runtime_ns="",
    ),
    HookSpec(
        module=_EVENTS,
        # A metric phase span: with the bus, the profiler ranges, or both.
        names=frozenset({"timed_phase", "member_phase"}),
        record_prefix=False,
        guard_modules=frozenset({_EVENTS}),
        runtime_ns="",
        guard_flags=frozenset({"SPANS", "ENABLED"}),
    ),
    HookSpec(
        module=_EVENTS,
        # A profiler range; the bus may be off.
        names=frozenset({"span"}),
        record_prefix=False,
        guard_modules=frozenset({_EVENTS}),
        runtime_ns="",
        guard_flags=frozenset({"ANNOTATE"}),
    ),
    HookSpec(
        module=_HEALTH,
        names=frozenset(
            {"label_bounds", "batch_stats", "stats_for_update", "inspect"}
        ),
        record_prefix=False,
        guard_modules=frozenset({_HEALTH}),
        runtime_ns="health.",
    ),
    HookSpec(
        module=_PERFSCOPE,
        names=frozenset(
            {
                "profile_program",
                "maybe_evaluate_slo",
                "evaluate_slo",
                "batch_nbytes",
            }
        ),
        record_prefix=False,
        guard_modules=frozenset({_PERFSCOPE}),
        runtime_ns="perfscope.",
    ),
    HookSpec(
        module=_FAULTS,
        names=frozenset({"fire"}),
        record_prefix=False,
        guard_modules=frozenset({_FAULTS}),
        runtime_ns="faults.",
    ),
    HookSpec(
        module=_QUALITY,
        names=frozenset({"publish"}),
        record_prefix=False,
        # Contract (monitor/quality.py docstring): callers gate quality
        # publishing on the EVENT BUS flag — quality rides the bus.
        guard_modules=frozenset({_EVENTS, _QUALITY}),
        runtime_ns="monitor.",
    ),
    HookSpec(
        module=_TRACE,
        # The propagation API — the calls hot paths make.  The offline
        # reconstruction half (build_forest, select_trace, ...) runs on
        # saved dumps, never on the hot path, and is deliberately absent.
        names=frozenset(
            {
                "capture",
                "adopt",
                "activate",
                "span",
                "current",
                "push",
                "pop",
                "root",
                "child",
                "derive",
                "reparent",
                "new_span_id",
            }
        ),
        record_prefix=False,
        guard_modules=frozenset({_TRACE}),
        runtime_ns="trace.",
    ),
    HookSpec(
        module=_FLIGHTREC,
        names=frozenset({"observe", "trigger"}),
        record_prefix=False,
        guard_modules=frozenset({_FLIGHTREC}),
        runtime_ns="flightrec.",
    ),
    HookSpec(
        module=_AUTOTUNE,
        # The hot-path surface of the measured-cost routing layer: the
        # profile observer, the decision lookup, and the measurement
        # recorder.  The cold store/race machinery (flush, preference,
        # warmup racing) runs off the update path and is absent here.
        names=frozenset({"observe_profile", "decide", "record_measurement"}),
        record_prefix=False,
        guard_modules=frozenset({_AUTOTUNE}),
        runtime_ns="autotune.",
    ),
    HookSpec(
        module=_METERING,
        # The per-tenant serve ledger's hot-path surface: the record_*
        # hooks plus the payload/row sizers the hook sites call to build
        # their arguments.  The snapshot half (ledger_rows, publish,
        # rebalance_hints) runs at report time, off the hot path.
        names=frozenset(
            {
                "payload_nbytes",
                "batch_rows",
                "program_id",
            }
        ),
        record_prefix=True,
        guard_modules=frozenset({_METERING}),
        runtime_ns="metering.",
    ),
)

_SPECS_BY_MODULE: Dict[str, Tuple[HookSpec, ...]] = {}
for _spec in HOOK_SPECS:
    _SPECS_BY_MODULE[_spec.module] = _SPECS_BY_MODULE.get(_spec.module, ()) + (_spec,)

# Every flag attribute some hook is guarded by.
_GUARD_FLAGS: FrozenSet[str] = frozenset(
    f for spec in HOOK_SPECS for f in spec.guard_flags
)

# A hook module's own source freely calls its entry points after the
# public guard (record_* funnel into emit, fire dispatches rules);
# dominance applies to *callers*, not the implementation.
_DEFINING_MODULES: FrozenSet[str] = frozenset(_SPECS_BY_MODULE)


def _spec_for_call(
    mod: Module, call: ast.Call
) -> Optional[Tuple[HookSpec, str]]:
    """(spec, hook_name) when this call statically targets a hook entry
    point, else None."""
    for module, attr in resolve_chain(mod, call.func):
        if attr is None:
            continue
        for spec in _SPECS_BY_MODULE.get(module, ()):
            if attr in spec.names or (
                spec.record_prefix and attr.startswith("record_")
            ):
                return spec, attr
    return None


# ----------------------------------------------------------- guard tests


Guard = Tuple[str, str]  # (module, flag attribute)


def _guarded_modules_of_test(
    mod: Module, test: ast.AST, local_flags: Dict[str, Set[Guard]]
) -> Set[Guard]:
    """(module, flag) guards a test expression *positively*
    requires-or-mentions.  `a.ENABLED and x`, `a.ENABLED or b.ENABLED`
    both count for `a` — the contract is one branch per site, not
    minimal branch strength."""
    out: Set[Guard] = set()

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                walk(v)
            return
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return  # negation flips polarity; handled by early-exit form
        if isinstance(node, ast.Attribute) and node.attr in _GUARD_FLAGS:
            for module, attr in resolve_chain(mod, node):
                if attr == node.attr and module in _SPECS_BY_MODULE:
                    out.add((module, attr))
            return
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            if dn and dn.split(".")[-1] == "enabled":
                for module, attr in resolve_chain(mod, node.func):
                    if attr == "enabled" and module in _SPECS_BY_MODULE:
                        out.add((module, "ENABLED"))
            return
        if isinstance(node, ast.Name):
            out.update(local_flags.get(node.id, set()))
            return
        # Anything else (comparisons, subscripts) is not a guard shape.

    walk(test)
    return out


def _negated_guard_modules(
    mod: Module, test: ast.AST, local_flags: Dict[str, Set[Guard]]
) -> Set[Guard]:
    """Guards (M, F) for which the test is (or contains, via `or`) a
    ``not M.F`` — the early-exit polarity."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _guarded_modules_of_test(mod, test.operand, local_flags)
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        out: Set[Guard] = set()
        for v in test.values:
            out.update(_negated_guard_modules(mod, v, local_flags))
        return out
    return set()


def _collect_local_flags(
    mod: Module, fn: Optional[ast.AST]
) -> Dict[str, Set[Guard]]:
    """Names assigned from a guard expression (``health =
    _health.ENABLED``) in the enclosing function chain (closures
    included) and at module level.  Flow-insensitive: a name that ever
    holds the flag is trusted — misuse would be a contrived way to lie
    to the linter, not an accident."""
    flags: Dict[str, Set[Guard]] = {}
    scopes: List[ast.AST] = []
    cur = fn
    while cur is not None:
        scopes.append(cur)
        cur = enclosing_function(cur)
    scopes.append(mod.tree)
    for scope in scopes:
        if scope is mod.tree:
            # Module scope: top-level statements only — an assignment
            # buried in some OTHER function must not leak trust here.
            nodes: List[ast.AST] = list(getattr(scope, "body", []))
        else:
            nodes = list(ast.walk(scope))
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    mods = _guarded_modules_of_test(mod, node.value, flags)
                    # Also: ternary value `X if flag else Y` does not
                    # define a flag; only direct reads do.
                    if mods:
                        flags.setdefault(tgt.id, set()).update(mods)
    return flags


_TERMINAL = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _dominated(
    mod: Module,
    call: ast.Call,
    guards: FrozenSet[Guard],
    local_flags: Dict[str, Set[Guard]],
) -> bool:
    """True when the call is dominated by a branch on any accepted
    (module, flag) guard, looking only within the enclosing function
    (a def's body runs at call time, not where the def statement sits)."""

    def positive(test: ast.AST) -> bool:
        return bool(_guarded_modules_of_test(mod, test, local_flags) & guards)

    def negated(test: ast.AST) -> bool:
        return bool(_negated_guard_modules(mod, test, local_flags) & guards)

    node: ast.AST = call
    up = parent(node)
    while up is not None:
        if isinstance(up, ast.If):
            # `node` is a DIRECT child of `up` (the walk ascends one
            # level per step), so identity membership suffices.
            in_body = any(node is s for s in up.body)
            in_else = any(node is s for s in up.orelse)
            if in_body and positive(up.test):
                return True
            if in_else and negated(up.test):
                return True
        elif isinstance(up, ast.IfExp):
            if node is up.body and positive(up.test):
                return True
            if node is up.orelse and negated(up.test):
                return True
        # Early-exit form: a preceding `if not M.ENABLED: return` in any
        # statement list on the way up — including the enclosing
        # function's own body, so this must run before the scope break.
        for field in ("body", "orelse", "finalbody"):
            block = getattr(up, field, None)
            if isinstance(block, list) and node in block:
                idx = block.index(node)
                for prev in block[:idx]:
                    if (
                        isinstance(prev, ast.If)
                        and not prev.orelse
                        and prev.body
                        and isinstance(prev.body[-1], _TERMINAL)
                        and negated(prev.test)
                    ):
                        return True
        if isinstance(
            up, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            break
        node, up = up, parent(up)
    return False


# ----------------------------------------------------------------- rule


class HookGuardRule(Rule):
    code = "TPU001"
    name = "hook-guard"
    summary = (
        "telemetry/health/faults/perfscope/quality hook calls must be "
        "dominated by their ENABLED branch"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        if mod.name in _DEFINING_MODULES:
            return []
        findings: List[Finding] = []
        flag_cache: Dict[int, Dict[str, Set[Guard]]] = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _spec_for_call(mod, node)
            if hit is None:
                continue
            spec, hook = hit
            fn = enclosing_function(node)
            key = id(fn)
            if key not in flag_cache:
                flag_cache[key] = _collect_local_flags(mod, fn)
            if _dominated(mod, node, spec.guards, flag_cache[key]):
                continue
            module, flag = sorted(spec.guards)[0]
            guard = f"{module.rsplit('.', 1)[-1]}.{flag}"
            findings.append(
                Finding(
                    code=self.code,
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"hook call `{spec.runtime_ns}{hook}` is not "
                        f"dominated by an `{guard}` branch "
                        "(zero-cost-when-off contract)"
                    ),
                    scope=scope_qualname(node),
                    symbol=f"{spec.runtime_ns}{hook}",
                )
            )
        return findings


register(HookGuardRule())


# ------------------------------------------------- hook-site discovery


def discover_hook_sites(
    mods: Sequence[Module],
) -> Dict[str, List[str]]:
    """Every statically-visible hook call site, guarded or not, keyed by
    the runtime-namespace hook name the hook-map check uses for its
    counting wrappers (``record_sync``, ``health.inspect``,
    ``faults.fire``, ...).  That check wraps every name in this list, so
    the empirical and static guards cannot diverge silently.  Defining modules are included here (unlike findings):
    a record_* helper only the implementation calls still needs a
    runtime wrapper.
    """
    sites: Dict[str, List[str]] = {}
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _spec_for_call(mod, node)
            if hit is None:
                continue
            spec, hook = hit
            if mod.name == spec.module:
                continue  # the implementation's internal funnels
            sites.setdefault(f"{spec.runtime_ns}{hook}", []).append(
                f"{mod.path}:{node.lineno}"
            )
    return {k: sorted(v) for k, v in sorted(sites.items())}
