"""TPU003 / TPU005: contracts inside traced regions, which in the port
are CUDA-graph captures.

A capture records the kernels a stretch of host code launches and
replays them later without running that host code again.  A *traced
region* is therefore:

- the body of ``with torch.cuda.graph(...):`` (the port's engine
  captures its scan block this way, ``engine/scan.py``);
- the statements between ``g.capture_begin(...)`` and
  ``g.capture_end()`` in one block;
- any function statically reachable from those statements, and any
  callable handed to ``torch.cuda.make_graphed_callables``, with what
  it reaches.

A function called directly from a capture body is an *entry*: its
parameters bound to a plain name at that call carry tensors into the
capture, while those bound to a constant, an attribute or shape
metadata are host values fixed at capture (the counterpart of JAX's
``static_argnums``).  Every parameter of a callable handed to
``make_graphed_callables`` is a tensor (its sample arguments).

Reachability uses a conservative same-module call graph: a call to a
bare name resolves to any def of that name in the module; ``self.m()``
/ ``cls.m()`` resolve to any method named ``m``.  Cross-module calls
are not followed (their modules get their own entry points when they
capture).

**TPU003 traced-host-sync** flags, inside traced regions:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` — a
  device->host copy, which a capture refuses (or, where it does not,
  reads the capture-time value on every replay);
- ``float(x)`` / ``int(x)`` / ``bool(x)`` on non-literal arguments —
  the same read, implicitly;
- ``np.asarray`` / ``np.array`` and ``torch.cuda.synchronize()`` —
  host round-trips a capture cannot record;
- ``if``/``while`` branching directly on a tensor parameter of an
  entry (branching on host configuration is fine and common; branching
  on a tensor is a host read that freezes one side into the graph).

**TPU005 traced-determinism** flags host-side nondeterminism baked into
a capture as a constant: ``time.time``/``monotonic``/``perf_counter``/
``time_ns``, ``random.*``, ``np.random.*``, ``os.urandom``, and argless
``datetime.now()``/``utcnow()`` — each evaluates once at capture and
then lies on every replay.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .._core import (
    Finding,
    Module,
    Rule,
    dotted_name,
    parent,
    register,
    scope_qualname,
)

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)

# Dotted spellings of the capture context manager and of the
# graphed-callable wrapper.
_GRAPH_CHAINS = {"torch.cuda.graph", "cuda.graph"}
_GRAPHED_CHAINS = {
    "torch.cuda.make_graphed_callables",
    "cuda.make_graphed_callables",
    "make_graphed_callables",
}

# Call arguments that are host values fixed at capture: shape metadata
# and attribute reads (configuration), besides literals.
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "itemsize", "nbytes",
                 "numel", "dim", "element_size", "device"}
_STATIC_CALLS = {"len", "torch.finfo", "torch.iinfo", "np.finfo", "np.iinfo",
                 "numpy.finfo", "numpy.iinfo"}


class _Entry:
    """One capture entry: a def or lambda whose ``tensor_params`` carry
    tensors into the capture, or a capture body (a :class:`_Region`,
    with none)."""

    def __init__(self, fn: ast.AST, kind: str, tensor_params: Set[str]) -> None:
        self.fn = fn
        self.kind = kind
        self._tensor_params = tensor_params

    def traced_params(self) -> Set[str]:
        return set(self._tensor_params)


class _Region(ast.AST):
    """A capture body as a pseudo-node: its statements, walked like a
    function body (``ast.walk`` follows ``body``)."""

    _fields = ("body",)

    def __init__(self, body: List[ast.stmt]) -> None:
        super().__init__()
        self.body = body


def _defs_in_module(tree: ast.AST) -> Dict[str, List[ast.AST]]:
    """name -> defs (functions anywhere, methods keyed by bare name)."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, _FuncDef):
            out.setdefault(node.name, []).append(node)
    return out


def _all_params(fn: ast.AST) -> List[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


def _is_host_value(node: ast.AST) -> bool:
    """An argument fixed at capture: a literal, an attribute read, shape
    metadata, or a container of those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_host_value(e) for e in node.elts)
    if isinstance(node, ast.Attribute):
        return True
    return _is_static_metadata(node)


def _bound_tensor_params(fn: ast.AST, call: ast.Call) -> Set[str]:
    """Parameters of ``fn`` that ``call`` binds to a value that is not a
    host value (a name, a subscript, an expression): those carry
    tensors into the capture."""
    args = getattr(fn, "args", None)
    if args is None:
        return set()
    positional = [a.arg for a in args.posonlyargs + args.args]
    is_method = bool(positional) and positional[0] in ("self", "cls") and (
        isinstance(call.func, ast.Attribute)
    )
    if is_method:
        positional = positional[1:]
    out: Set[str] = set()
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            out.update(positional[i:])
            break
        if i < len(positional) and not _is_host_value(arg):
            out.add(positional[i])
    names = set(_all_params(fn))
    for kw in call.keywords:
        if kw.arg is None:
            continue
        if kw.arg in names and not _is_host_value(kw.value):
            out.add(kw.arg)
    return out - {"self", "cls"}


def _capture_regions(mod: Module) -> List[_Region]:
    """Capture bodies: ``with torch.cuda.graph(...)`` blocks and the
    statements between ``capture_begin()`` and ``capture_end()``."""
    regions: List[_Region] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call) and dotted_name(ce.func) in _GRAPH_CHAINS:
                    regions.append(_Region(node.body))
                    break
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if not isinstance(block, list):
                continue
            start: Optional[int] = None
            for i, st in enumerate(block):
                attr = _method_call_attr(st)
                if attr == "capture_begin":
                    start = i
                elif attr == "capture_end" and start is not None:
                    regions.append(_Region(block[start + 1 : i]))
                    start = None
    return regions


def _method_call_attr(st: ast.AST) -> Optional[str]:
    if (
        isinstance(st, ast.Expr)
        and isinstance(st.value, ast.Call)
        and isinstance(st.value.func, ast.Attribute)
    ):
        return st.value.func.attr
    return None


def _callee_name(call: ast.Call) -> Optional[str]:
    dn = dotted_name(call.func)
    if dn is None:
        return None
    parts = dn.split(".")
    if len(parts) == 1:
        return parts[0]
    if len(parts) == 2 and parts[0] in ("self", "cls"):
        return parts[1]
    return None


def _find_entries(mod: Module) -> List[_Entry]:
    defs = _defs_in_module(mod.tree)
    entries: List[_Entry] = []
    seen: Set[Tuple[int, str]] = set()

    def add(fn: Optional[ast.AST], kind: str, params: Set[str]) -> None:
        if fn is None:
            return
        key = (id(fn), kind)
        if key in seen:
            for e in entries:
                if e.fn is fn and e.kind == kind:
                    e._tensor_params |= params
            return
        seen.add(key)
        entries.append(_Entry(fn, kind, set(params)))

    def lookup(node: ast.AST) -> List[ast.AST]:
        if isinstance(node, (ast.Lambda,) + _FuncDef):
            return [node]
        if isinstance(node, (ast.Tuple, ast.List)):
            return [f for e in node.elts for f in lookup(e)]
        dn = dotted_name(node)
        if dn is None:
            return []
        cands = defs.get(dn.split(".")[-1], [])
        return cands[:1]

    for region in _capture_regions(mod):
        add(region, "graph", set())
        for node in _region_nodes(region):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_name(node)
            for cand in defs.get(name, []) if name else []:
                add(cand, "graph", _bound_tensor_params(cand, node))
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and dotted_name(node.func) in _GRAPHED_CHAINS:
            if node.args:
                for fn in lookup(node.args[0]):
                    params = set(_all_params(fn)) - {"self", "cls"}
                    add(fn, "make_graphed_callables", params)
    return entries


def _region_nodes(region: _Region):
    """Nodes of a capture body, nested def/class bodies excluded (they
    run only if called, and are followed through the call graph)."""
    stack: List[ast.AST] = list(region.body)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.ClassDef, ast.Lambda) + _FuncDef):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _reachable(
    mod: Module, entries: Sequence[_Entry]
) -> Dict[int, Tuple[ast.AST, _Entry]]:
    """id(def or region) -> (node, originating entry) for everything
    reachable from a capture entry in the same module."""
    defs = _defs_in_module(mod.tree)
    # Every entry keeps itself as its origin (its branch checks), even
    # when another entry also reaches it.
    out: Dict[int, Tuple[ast.AST, _Entry]] = {id(e.fn): (e.fn, e) for e in entries}
    work: List[ast.AST] = [e.fn for e in entries]
    expanded: Set[int] = set()
    while work:
        fn = work.pop()
        if id(fn) in expanded:
            continue
        expanded.add(id(fn))
        origin = out[id(fn)][1]
        nodes = _region_nodes(fn) if isinstance(fn, _Region) else ast.walk(fn)
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            callee = _callee_name(node)
            if callee is None:
                continue
            for cand in defs.get(callee, []):
                out.setdefault(id(cand), (cand, origin))
                work.append(cand)
    return out


def _enclosing_def(node: ast.AST) -> Optional[ast.AST]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.Lambda,) + _FuncDef):
            return cur
        cur = parent(cur)
    return None


def _is_static_metadata(node: ast.AST) -> bool:
    """Shape, dtype and finfo arithmetic: host math on values fixed at
    capture, not a read of a tensor's contents."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if isinstance(sub, ast.Call):
            dn = dotted_name(sub.func)
            if dn in _STATIC_CALLS:
                return True
    return False


_COERCIONS = {"float", "int", "bool"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CALLS = {
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
    "torch.cuda.synchronize",
    "cuda.synchronize",
}
_NONDET_CALLS = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.perf_counter",
    "os.urandom",
}
_NONDET_NOW = {"datetime.now", "datetime.datetime.now", "datetime.utcnow",
               "datetime.datetime.utcnow"}
_NONDET_PREFIXES = ("random.", "np.random.", "numpy.random.", "_random.")


_REACH_CACHE: List[Tuple[Module, Dict[int, Tuple[ast.AST, _Entry]]]] = []
# Enough for a whole run (each rule walks every module before the next
# rule starts), so the three rules really share the walk.
_CACHE_MODULES = 1024


def traced_functions(mod: Module) -> Dict[int, Tuple[ast.AST, _Entry]]:
    """:func:`_reachable` from the module's capture entries, memoized per
    module object so TPU003, TPU005 and TPU012 share one walk (the entry
    holds the Module itself, as ``_core.module_dataflow`` does)."""
    for cached_mod, reach in _REACH_CACHE:
        if cached_mod is mod:
            return reach
    entries = _find_entries(mod)
    reach = _reachable(mod, entries) if entries else {}
    _REACH_CACHE.append((mod, reach))
    del _REACH_CACHE[:-_CACHE_MODULES]
    return reach


class TracedRulesBase(Rule):
    """Shared traversal for the two traced-region rules."""

    def _traced_functions(self, mod: Module):
        return traced_functions(mod)

    @staticmethod
    def _owned(fn: ast.AST, reach: Dict[int, Tuple[ast.AST, "_Entry"]]):
        """Nodes that run when ``fn`` runs: a region's statements, or a
        def's body minus nested defs that are not themselves reached."""
        if isinstance(fn, _Region):
            yield from _region_nodes(fn)
            return
        for node in ast.walk(fn):
            inner = _enclosing_def(node)
            if inner is not fn and id(inner) not in reach:
                continue
            yield node


class TracedHostSyncRule(TracedRulesBase):
    code = "TPU003"
    name = "traced-host-sync"
    summary = (
        "no host reads (.item/.cpu/float/np.asarray/synchronize/tensor "
        "branching) inside code reachable from a CUDA-graph capture"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        reach = self._traced_functions(mod)
        if not reach:
            return []
        findings: List[Finding] = []
        for fn, origin in reach.values():
            traced_params = (
                origin.traced_params() if fn is origin.fn else set()
            )
            for node in self._owned(fn, reach):
                if isinstance(node, ast.Call):
                    self._check_call(mod, fn, node, findings)
                elif isinstance(node, (ast.If, ast.While)) and traced_params:
                    self._check_branch(
                        mod, fn, node, traced_params, findings
                    )
        findings.sort(key=lambda f: (f.line, f.symbol))
        return findings

    def _check_call(
        self,
        mod: Module,
        fn: ast.AST,
        node: ast.Call,
        findings: List[Finding],
    ) -> None:
        dn = dotted_name(node.func)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_METHODS
            and not node.args
            and not (dn and dn.split(".")[0] in ("np", "numpy", "torch"))
        ):
            findings.append(
                self._finding(
                    mod,
                    node,
                    f"`.{node.func.attr}()` copies a tensor to the host "
                    "inside a CUDA-graph capture",
                    node.func.attr,
                )
            )
        elif (
            dn in _COERCIONS
            and len(node.args) == 1
            and not isinstance(node.args[0], ast.Constant)
            and not _is_static_metadata(node.args[0])
        ):
            findings.append(
                self._finding(
                    mod,
                    node,
                    f"`{dn}(...)` reads a tensor's value on the host "
                    "inside a CUDA-graph capture (refused, or frozen "
                    "into every replay)",
                    dn,
                )
            )
        elif dn in _HOST_CALLS:
            findings.append(
                self._finding(
                    mod,
                    node,
                    f"`{dn}` is a host round-trip a CUDA-graph capture "
                    "cannot record",
                    dn,
                )
            )

    def _check_branch(
        self,
        mod: Module,
        fn: ast.AST,
        node: ast.AST,
        traced_params: Set[str],
        findings: List[Finding],
    ) -> None:
        test = node.test
        name: Optional[str] = None
        if isinstance(test, ast.Name) and test.id in traced_params:
            name = test.id
        elif isinstance(test, ast.Compare) and not any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            operands = [test.left] + list(test.comparators)
            for op in operands:
                if isinstance(op, ast.Name) and op.id in traced_params:
                    name = op.id
                    break
        if name is not None:
            findings.append(
                self._finding(
                    mod,
                    node,
                    f"host branch on tensor parameter `{name}` of a "
                    "CUDA-graph capture entry (use torch.where, or pass "
                    "a host value)",
                    f"branch:{name}",
                )
            )

    def _finding(
        self, mod: Module, node: ast.AST, message: str, symbol: str
    ) -> Finding:
        return Finding(
            code=self.code,
            path=mod.path,
            line=node.lineno,
            message=message,
            scope=scope_qualname(node),
            symbol=symbol,
        )


class TracedDeterminismRule(TracedRulesBase):
    code = "TPU005"
    name = "traced-determinism"
    summary = (
        "no wall-clock / RNG host calls inside CUDA-graph captures "
        "(they bake into the graph as constants)"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        reach = self._traced_functions(mod)
        if not reach:
            return []
        findings: List[Finding] = []
        for fn, _ in reach.values():
            for node in self._owned(fn, reach):
                if not isinstance(node, ast.Call):
                    continue
                dn = dotted_name(node.func)
                if dn is None:
                    continue
                hit = (
                    dn in _NONDET_CALLS
                    or (dn in _NONDET_NOW and not node.args)
                    or any(dn.startswith(p) for p in _NONDET_PREFIXES)
                )
                if hit:
                    findings.append(
                        Finding(
                            code=self.code,
                            path=mod.path,
                            line=node.lineno,
                            message=(
                                f"`{dn}` inside a CUDA-graph capture "
                                "evaluates once at capture and becomes a "
                                "baked-in constant on every replay (draw "
                                "on the device with a torch.Generator, or "
                                "hoist to the host side)"
                            ),
                            scope=scope_qualname(node),
                            symbol=dn,
                        )
                    )
        findings.sort(key=lambda f: (f.line, f.symbol))
        return findings


register(TracedHostSyncRule())
register(TracedDeterminismRule())
