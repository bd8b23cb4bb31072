"""tpulint core for the PyTorch port: source loading, AST utilities,
findings, rule registry, the concurrency model and the dataflow
interpreter.

Everything in this package is **stdlib-only** (``ast`` + friends): the
linter must run where neither jax nor torch is importable and must
never pay an import of the library it is analyzing.  To that end the
whole subpackage uses relative imports, so it can be loaded by path
under a synthetic package name without triggering
``torcheval_tpu_torch/__init__`` (which imports torch).

The central objects:

- :class:`Module` — one parsed source file: path, module name, AST with
  parent links, source lines, suppression table.
- :class:`Finding` — one diagnostic, carrying a line for humans and a
  line-independent *fingerprint* for the baseline file (line numbers
  drift; ``code:path:scope:symbol#occurrence`` does not).
- :class:`Rule` — the rule protocol; concrete rules live in
  ``analysis/rules/`` and register via :func:`register`.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import (
    AbstractSet,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

# --------------------------------------------------------------------- AST


def attach_parents(tree: ast.AST) -> None:
    """Set ``node.tpulint_parent`` on every node (dominance checks and
    scope walks need upward navigation, which ``ast`` does not give)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.tpulint_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "tpulint_parent", None)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda, or None at
    module level."""
    cur = parent(node)
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return cur
        cur = parent(cur)
    return None


def scope_qualname(node: ast.AST) -> str:
    """Dotted path of enclosing class/function defs, ``<module>`` when
    the node sits at module level.  Used in fingerprints: stable across
    line drift, specific enough to pin a finding."""
    names: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            names.append(cur.name)
        cur = parent(cur)
    return ".".join(reversed(names)) or "<module>"


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None (calls,
    subscripts and other dynamic bases defeat static resolution)."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


# ------------------------------------------------------------ import model


@dataclass
class ImportedName:
    """One local binding produced by an import statement.

    ``module_candidates`` are the fully-dotted modules this name may
    refer to; for ``from a.b import c`` both ``a.b.c`` (c is a module)
    and ``a.b`` with ``attr='c'`` (c is a function) are possible — the
    consumer checks both against its own table, so the ambiguity is
    harmless.
    """

    local: str
    module_candidates: Tuple[str, ...]
    attr: Optional[str] = None  # set for `from M import attr`
    lineno: int = 0
    function_level: bool = False  # import nested inside a def


def _resolve_relative(module: Optional[str], level: int, pkg: str) -> str:
    """Absolute module for a ``from ...x import y`` given the importing
    module's *package* dotted name ``pkg`` (for a package ``__init__``
    that is the module name itself; for a plain module, its parent)."""
    if level == 0:
        return module or ""
    base = pkg.split(".") if pkg else []
    drop = level - 1  # level 1 = the package itself
    base = base[: len(base) - drop] if drop <= len(base) else []
    if module:
        base.append(module)
    return ".".join(base)


def collect_imports(mod: "Module") -> List[ImportedName]:
    """Every import binding in the file, flow-insensitively.  Marks
    function-level (lazy) imports — the layer rule only constrains
    module-level edges."""
    out: List[ImportedName] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            fl = enclosing_function(node) is not None
            for alias in node.names:
                if alias.asname:
                    # `import a.b.c as x`: x IS module a.b.c.
                    local, target = alias.asname, alias.name
                else:
                    # `import a.b.c` binds `a`; the chain walker folds
                    # trailing attrs back into the dotted module path.
                    local = target = alias.name.split(".")[0]
                out.append(
                    ImportedName(
                        local=local,
                        module_candidates=(target,),
                        lineno=node.lineno,
                        function_level=fl,
                    )
                )
        elif isinstance(node, ast.ImportFrom):
            fl = enclosing_function(node) is not None
            base = _resolve_relative(node.module, node.level, mod.package)
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                out.append(
                    ImportedName(
                        local=local,
                        module_candidates=(
                            f"{base}.{alias.name}" if base else alias.name,
                            base,
                        ),
                        attr=alias.name,
                        lineno=node.lineno,
                        function_level=fl,
                    )
                )
    return out


def resolve_chain(
    mod: "Module", node: ast.AST
) -> List[Tuple[str, Optional[str]]]:
    """Resolve a Name/Attribute chain against the module's import
    bindings.  Returns ``(module, attr)`` candidates: e.g. with
    ``from torcheval_tpu_torch.telemetry import events as _telemetry``,
    ``_telemetry.record_sync`` yields
    ``("torcheval_tpu_torch.telemetry.events", "record_sync")``.
    """
    dn = dotted_name(node)
    if dn is None:
        return []
    parts = dn.split(".")
    head, rest = parts[0], parts[1:]
    out: List[Tuple[str, Optional[str]]] = []
    for imp in mod.imports_by_local.get(head, []):
        for cand in imp.module_candidates:
            if not cand:
                continue
            if imp.attr is not None and cand != imp.module_candidates[0]:
                # `from M import a` second candidate: name IS M.a
                chain = [imp.attr] + rest
            else:
                chain = list(rest)
            # Fold leading attrs into the module path, offering every
            # split point: a.b.c may be module a.b attr c or module
            # a.b.c attr None...
            for k in range(len(chain), -1, -1):
                m = ".".join([cand] + chain[:k])
                attr = chain[k] if k < len(chain) else None
                if k + 1 < len(chain):
                    continue  # only allow one trailing attribute
                out.append((m, attr))
    return out


# ----------------------------------------------------------------- module


@dataclass
class Module:
    path: str  # as passed (usually repo-relative)
    name: str  # dotted module name, e.g. torcheval_tpu_torch.metrics._bucket
    source: str
    tree: ast.AST
    is_package: bool = False  # True for an __init__.py
    lines: List[str] = field(default_factory=list)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    imports: List[ImportedName] = field(default_factory=list)
    imports_by_local: Dict[str, List[ImportedName]] = field(
        default_factory=dict
    )

    @classmethod
    def load(
        cls, path: str, name: str, display: Optional[str] = None
    ) -> "Module":
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
        attach_parents(tree)
        mod = cls(
            path=display or path,
            name=name,
            source=source,
            tree=tree,
            is_package=os.path.basename(path) == "__init__.py",
            lines=source.splitlines(),
        )
        from ._suppress import collect_suppressions

        mod.suppressions = collect_suppressions(source)
        mod.imports = collect_imports(mod)
        for imp in mod.imports:
            mod.imports_by_local.setdefault(imp.local, []).append(imp)
        return mod

    @property
    def package(self) -> str:
        """The package relative imports resolve against: the module
        itself for an ``__init__``, its parent otherwise."""
        return self.name if self.is_package else self.name.rpartition(".")[0]

    def suppressed(self, lineno: int, code: str) -> bool:
        for ln in (lineno, lineno - 1):
            codes = self.suppressions.get(ln)
            if codes and (code in codes or "*" in codes):
                return True
        return False


def module_name_for(path: str, roots: Sequence[str]) -> str:
    """Dotted module name for a file path.  Files under a recognized
    package root get real package names; anything else gets a
    path-derived pseudo-name (``chip_smoke``) — good enough for
    fingerprints and for the layer rule's "outside the package" bucket.

    The root is matched on a whole path component (the last one equal
    to it), so ``torcheval_tpu/...`` is never taken for
    ``torcheval_tpu_torch/...`` or the other way round.
    """
    norm = path.replace(os.sep, "/")
    parts = norm.split("/")
    for root in roots:
        marker = root.rstrip("/").split("/")[-1]
        hits = [i for i, part in enumerate(parts) if part in (marker, marker + ".py")]
        if hits:
            tail = "/".join(parts[hits[-1]:])
            mod = tail[:-3] if tail.endswith(".py") else tail
            mod = mod.replace("/", ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            return mod
    mod = norm[:-3] if norm.endswith(".py") else norm
    mod = mod.strip("/").replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


# ---------------------------------------------------------------- finding


@dataclass
class Finding:
    code: str
    path: str
    line: int
    message: str
    scope: str = "<module>"
    symbol: str = ""
    occurrence: int = 0  # disambiguates repeats of the same symbol/scope

    @property
    def fingerprint(self) -> str:
        base = f"{self.code}:{_norm(self.path)}:{self.scope}:{self.symbol}"
        return base if self.occurrence == 0 else f"{base}#{self.occurrence}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "code": self.code,
            "path": _norm(self.path),
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return f"{_norm(self.path)}:{self.line}: {self.code} {self.message}"


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def assign_occurrences(findings: List[Finding]) -> None:
    """Number repeated (code, path, scope, symbol) findings so each gets
    a distinct fingerprint (ordered by line: stable under unrelated
    edits, adjacent under local ones)."""
    seen: Dict[str, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        key = f"{f.code}:{_norm(f.path)}:{f.scope}:{f.symbol}"
        n = seen.get(key, 0)
        f.occurrence = n
        seen[key] = n + 1


# ------------------------------------------------------------------ rules


class Rule:
    """One lint rule.  Subclasses set ``code``/``name``/``summary`` and
    implement ``check_module`` (per-file) and/or ``check_program``
    (whole-run: the layer rule needs the global import graph)."""

    code: str = "TPU000"
    name: str = "abstract"
    summary: str = ""

    def check_module(self, mod: Module) -> List[Finding]:
        return []

    def check_program(self, mods: List[Module]) -> List[Finding]:
        return []


_REGISTRY: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.code in _REGISTRY:
        raise ValueError(f"duplicate rule code {rule.code}")
    _REGISTRY[rule.code] = rule
    return rule


def all_rules() -> List[Rule]:
    from . import rules as _rules  # noqa: F401 - triggers registration

    return [r for _, r in sorted(_REGISTRY.items())]


# ------------------------------------------------------------- the engine


@dataclass
class AnalysisResult:
    findings: List[Finding]
    files: List[str]
    errors: List[Finding]  # parse failures, reported as TPU000

    @property
    def all_findings(self) -> List[Finding]:
        return self.errors + self.findings


def iter_python_files(
    paths: Iterable[str], excludes: Sequence[str], root: Optional[str] = None
) -> Tuple[List[str], List[str]]:
    """Expand path arguments into .py files.  Returns (files, missing):
    a nonexistent *argument* is the CLI's exit-2 case; excluded or
    non-Python files inside a directory walk are silently scoped out.

    Excludes match the part of a path below ``root`` (the repo root) when
    the path lies under it, so a checkout that itself sits in an excluded
    directory (``_chip_archive/<commit>/``) still analyzes its own tree.
    """
    files: List[str] = []
    missing: List[str] = []
    base = os.path.abspath(root) + os.sep if root else None

    def excluded(p: str) -> bool:
        ap = os.path.abspath(p)
        n = _norm(ap[len(base):] if base and ap.startswith(base) else p)
        return any(
            n.endswith(_norm(e)) or f"/{_norm(e)}/" in f"/{n}/" for e in excludes
        )

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py") and not excluded(p):
                files.append(p)
            elif not os.path.exists(p):  # pragma: no cover - isfile said yes
                missing.append(p)
            elif not p.endswith(".py") and not excluded(p):
                # An explicit non-Python file argument is unreadable as
                # source — the caller asked for it by name, so fail loud.
                missing.append(p)
        elif os.path.isdir(p):
            for dirpath, dirs, names in os.walk(p):
                dirs[:] = sorted(
                    d
                    for d in dirs
                    if d not in ("__pycache__",)
                    and not d.startswith(".")
                    and not excluded(os.path.join(dirpath, d))
                )
                for fn in sorted(names):
                    full = os.path.join(dirpath, fn)
                    if fn.endswith(".py") and not excluded(full):
                        files.append(full)
        else:
            missing.append(p)
    return files, missing


def analyze_files(
    files: Sequence,
    package_roots: Sequence[str] = ("torcheval_tpu_torch",),
    rule_codes: Optional[AbstractSet[str]] = None,
) -> AnalysisResult:
    """``files``: open paths, or ``(open_path, display_path)`` pairs.
    Display paths (repo-relative) go into findings and fingerprints so
    baselines match regardless of CWD or how targets were spelled.
    ``rule_codes`` restricts the run to that subset of registered rules
    (the CLI's ``--select``/``--ignore``); parse errors (TPU000) are
    reported regardless — an unparsable file silently skipped would
    mean "clean" claims nothing."""
    mods: List[Module] = []
    errors: List[Finding] = []
    display: List[str] = []
    for entry in files:
        open_path, path = (
            entry if isinstance(entry, tuple) else (entry, entry)
        )
        display.append(path)
        name = module_name_for(path, package_roots)
        try:
            mods.append(Module.load(open_path, name, display=path))
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(
                Finding(
                    code="TPU000",
                    path=path,
                    line=getattr(exc, "lineno", 0) or 0,
                    message=f"unparsable source: {exc.__class__.__name__}: {exc}",
                    symbol="parse",
                )
            )
    findings: List[Finding] = []
    for rule in all_rules():
        if rule_codes is not None and rule.code not in rule_codes:
            continue
        for mod in mods:
            for f in rule.check_module(mod):
                if not mod.suppressed(f.line, f.code):
                    findings.append(f)
        by_path = {m.path: m for m in mods}
        for f in rule.check_program(mods):
            m = by_path.get(f.path)
            if m is None or not m.suppressed(f.line, f.code):
                findings.append(f)
    assign_occurrences(findings)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return AnalysisResult(findings=findings, files=display, errors=errors)


# ------------------------------------- interprocedural concurrency model
#
# The concurrency tier (TPU006-TPU009) needs whole-program facts the
# per-module rules above never compute: which functions run on threads,
# which lock guards which field, and which locks are held at a given
# statement.  ``build_concurrency_model`` computes all of it in one
# pass over the module list; the four rules consume the shared model
# via the memoized :func:`concurrency_model`.
#
# Identity conventions (documented in docs/source/analysis.rst):
#
# - A *lock id* is ``(module, owner, attr)`` — owner is the declaring
#   class name, or ``""`` for a module-global lock.  ``self._lock``,
#   ``obj._lock`` and ``cv = self._world._mail_cv; with cv:`` all
#   resolve to the declaring class's id, so aliases and cross-object
#   chains share one identity.
# - A *field id* has the same shape.  Fields never written outside
#   ``__init__`` are immutable-after-init and exempt; attributes bound
#   to sync primitives (locks, events, queues, barriers, threads) are
#   internally thread-safe and exempt.
# - "Concurrent" functions are (a) anything reachable from a resolved
#   ``threading.Thread(target=...)`` / ``Timer`` callback / ``run()``
#   body of a Thread subclass, plus (b) methods of a lock-owning class
#   and module-level functions of a lock-owning module — a lock is a
#   declaration of concurrency intent, and the thread that enters such
#   code often lives behind a callback indirection no static call graph
#   can see.

LockId = Tuple[str, str, str]
FieldId = Tuple[str, str, str]

_SYNC_CTOR_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Semaphore": "lock",
    "BoundedSemaphore": "lock",
    "Event": "event",
    "Barrier": "barrier",
    "Queue": "queue",
    "LifoQueue": "queue",
    "PriorityQueue": "queue",
    "SimpleQueue": "queue",
    "Thread": "thread",
    "Timer": "timer",
}
_LOCKLIKE = ("lock", "rlock", "condition")
_MUTATORS = {
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "pop", "popitem", "popleft", "remove", "reverse",
    "setdefault", "sort", "update",
}
_BLOCKING_COLLECTIVES = {
    "all_gather_bytes", "all_gather_object", "broadcast_object",
    "gather_object", "recv_object", "send_object",
}
_INIT_METHODS = {"__init__", "__new__", "__post_init__"}


def _sync_ctor_kind(mod: "Module", node: ast.AST) -> Optional[str]:
    """Primitive kind when ``node`` is a ``threading.*``/``queue.*``
    constructor call (through any import spelling), else None."""
    if not isinstance(node, ast.Call):
        return None
    dn = dotted_name(node.func)
    if dn is None:
        return None
    kind = _SYNC_CTOR_KINDS.get(dn.split(".")[-1])
    if kind is None:
        return None
    for m, _attr in resolve_chain(mod, node.func):
        if m in ("threading", "queue") or m.startswith(
            ("threading.", "queue.")
        ):
            return kind
    if dn.startswith(("threading.", "queue.")):
        return kind
    return None


@dataclass
class _ModuleDecls:
    """Per-module declaration tables feeding identity resolution."""

    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    attr_owners: Dict[str, Set[str]] = field(default_factory=dict)
    attr_prims: Dict[Tuple[str, str], str] = field(default_factory=dict)
    global_fields: Set[str] = field(default_factory=set)
    global_prims: Dict[str, str] = field(default_factory=dict)
    thread_subclasses: Set[str] = field(default_factory=set)

    def lock_attr_owners(self, attr: str) -> Set[str]:
        return {
            c
            for c in self.attr_owners.get(attr, set())
            if self.attr_prims.get((c, attr)) in _LOCKLIKE
        }


@dataclass
class FuncInfo:
    """One analyzed function (methods and nested defs included)."""

    key: str
    module: str
    path: str
    qualname: str
    name: str
    cls: Optional[str]
    node: Optional[ast.AST]  # None for the module-level pseudo-function
    locals: Set[str] = field(default_factory=set)
    global_decls: Set[str] = field(default_factory=set)
    lock_aliases: Dict[str, LockId] = field(default_factory=dict)
    prim_locals: Dict[str, str] = field(default_factory=dict)

    @property
    def is_init(self) -> bool:
        return (self.cls is not None and self.name in _INIT_METHODS) or (
            self.name == "<module>"
        )


@dataclass
class Access:
    """One read/write of a tracked field."""

    field: FieldId
    path: str
    line: int
    scope: str
    func_key: str
    write: bool
    held: FrozenSet[LockId]
    in_init: bool
    node: ast.AST


@dataclass
class Acquire:
    """One lock acquisition (``with`` or ``.acquire()``)."""

    lock: LockId
    held_before: FrozenSet[LockId]
    func_key: str
    path: str
    line: int
    scope: str


@dataclass
class BlockingCall:
    """A potentially-blocking call (join/queue ops/waits/collectives)."""

    label: str
    exempt: Optional[LockId]  # a Condition waits on itself legally
    held: FrozenSet[LockId]
    func_key: str
    path: str
    line: int
    scope: str


@dataclass
class ThreadSite:
    """One ``threading.Thread``/``Timer`` construction site."""

    kind: str  # "thread" | "timer"
    module: str
    path: str
    line: int
    scope: str
    func_key: str
    daemon: Optional[bool]
    target_key: Optional[str]
    target_name: Optional[str]
    binding: Optional[str]
    binding_is_attr: bool


def _enclosing_class(node: ast.AST) -> Optional[str]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a class nested in a function still owns its methods, but a
            # def nested in a method belongs to the method, not the class
            pass
        cur = parent(cur)
    return None


def _owned_nodes(root: ast.AST) -> Iterable[ast.AST]:
    """Descendants of ``root`` excluding nested def/class bodies (their
    statements belong to their own function scope)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _collect_decls(mod: "Module") -> _ModuleDecls:
    decls = _ModuleDecls()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            decls.classes[node.name] = node
            for base in node.bases:
                bdn = dotted_name(base)
                if bdn and bdn.split(".")[-1] == "Thread":
                    decls.thread_subclasses.add(node.name)
    for node in ast.walk(mod.tree):
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        kind = _sync_ctor_kind(mod, value) if value is not None else None
        in_func = enclosing_function(node) is not None
        cls = _enclosing_class(node)
        for t in targets:
            if isinstance(t, ast.Name):
                if not in_func and cls is None:
                    # module-level binding
                    if not t.id.startswith("__"):
                        decls.global_fields.add(t.id)
                        if kind:
                            decls.global_prims[t.id] = kind
                elif not in_func and cls is not None:
                    # class-body attribute
                    decls.attr_owners.setdefault(t.id, set()).add(cls)
                    if kind:
                        decls.attr_prims[(cls, t.id)] = kind
            elif (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id in ("self", "cls")
                and cls is not None
            ):
                decls.attr_owners.setdefault(t.attr, set()).add(cls)
                if kind:
                    decls.attr_prims[(cls, t.attr)] = kind
    return decls


class ConcurrencyModel:
    """Whole-program facts for the concurrency rules (TPU006-TPU009)."""

    def __init__(self) -> None:
        self.mods: List[Module] = []
        self.decls: Dict[str, _ModuleDecls] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.by_name: Dict[Tuple[str, str], List[str]] = {}
        self.by_method: Dict[Tuple[str, str, str], List[str]] = {}
        self.calls: Dict[str, Set[str]] = {}
        self.call_sites: Dict[str, List[Tuple[str, ast.AST]]] = {}
        self.locks: Dict[LockId, str] = {}
        self.fields: Dict[FieldId, List[Access]] = {}
        self.guards: Dict[FieldId, FrozenSet[LockId]] = {}
        self.concurrent: Dict[str, str] = {}  # func key -> reason
        self.entry_held: Dict[str, FrozenSet[LockId]] = {}
        self.held_at: Dict[int, FrozenSet[LockId]] = {}
        self.with_locks: Dict[int, FrozenSet[LockId]] = {}
        self.acquisitions: List[Acquire] = []
        self.blocking: List[BlockingCall] = []
        self.thread_sites: List[ThreadSite] = []
        self.joins: Dict[str, Set[str]] = {}  # module -> joined terminals
        self.join_funcs: Set[str] = set()  # funcs containing any join/cancel

    # -------------------------------------------------------- labels

    @staticmethod
    def _short(module: str) -> str:
        return module.rsplit(".", 1)[-1]

    def lock_label(self, lock: LockId) -> str:
        module, owner, attr = lock
        mid = f"{owner}." if owner else ""
        return f"{self._short(module)}.{mid}{attr}"

    def field_label(self, fid: FieldId) -> str:
        return self.lock_label(fid)  # same shape

    # ------------------------------------------------------- queries

    def held(self, func_key: str, node: ast.AST) -> FrozenSet[LockId]:
        """Locks held at ``node``: lexical context plus the intersection
        of what every analyzed caller holds around this function."""
        lex = self.held_at.get(id(node), frozenset())
        return lex | self.entry_held.get(func_key, frozenset())

    def held_for(self, a: Access) -> FrozenSet[LockId]:
        return a.held | self.entry_held.get(a.func_key, frozenset())

    def lock_table(self) -> Dict[str, List[str]]:
        """Inferred guard table: lock label -> sorted field labels it
        guards (the TPU006 association, exported for docs/tests)."""
        table: Dict[str, Set[str]] = {}
        for fid, guards in self.guards.items():
            for lock in guards:
                table.setdefault(self.lock_label(lock), set()).add(
                    self.field_label(fid)
                )
        return {k: sorted(v) for k, v in sorted(table.items())}

    # ------------------------------------------------------ resolution

    def _module_key(self, mod: Module) -> str:
        return f"{mod.name}::<module>"

    def _lock_from_chain(
        self, mod: Module, fi: FuncInfo, expr: ast.AST
    ) -> Optional[LockId]:
        """Resolve an expression to a lock identity: a local alias, a
        module-global lock, or a (possibly cross-object) attribute chain
        ending in a lock attribute with a unique declaring class."""
        dn = dotted_name(expr)
        if dn is None:
            return None
        parts = dn.split(".")
        decls = self.decls[mod.name]
        if len(parts) == 1:
            name = parts[0]
            if name in fi.lock_aliases:
                return fi.lock_aliases[name]
            if name in fi.prim_locals and fi.prim_locals[name] in _LOCKLIKE:
                return (mod.name, fi.qualname, name)
            if (
                name not in fi.locals
                and decls.global_prims.get(name) in _LOCKLIKE
            ):
                return (mod.name, "", name)
            return None
        tail = parts[-1]
        owners = decls.lock_attr_owners(tail)
        if not owners:
            return None
        if parts[0] in ("self", "cls") and len(parts) == 2:
            if fi.cls in owners:
                return (mod.name, fi.cls, tail)  # type: ignore[return-value]
        if len(owners) == 1:
            return (mod.name, next(iter(owners)), tail)
        return None

    def _field_from_parts(
        self, mod: Module, fi: FuncInfo, parts: List[str]
    ) -> Optional[FieldId]:
        """Field identity for an access chain.  ``self``/``cls``/class
        rooted chains key on the terminal attribute's declaring class;
        a chain rooted at a module-global name keys on the root."""
        decls = self.decls[mod.name]
        root = parts[0]
        if root in ("self", "cls") or root in decls.classes:
            if len(parts) < 2:
                return None
            tail = parts[-1]
            owners = decls.attr_owners.get(tail, set())
            if root in decls.classes and len(parts) == 2:
                owner = root
            elif fi.cls in owners and len(parts) == 2:
                owner = fi.cls  # type: ignore[assignment]
            elif len(owners) == 1:
                owner = next(iter(owners))
            elif len(parts) == 2 and root in ("self", "cls") and fi.cls:
                owner = fi.cls
            else:
                return None
            if decls.attr_prims.get((owner, tail)):
                return None  # sync primitives are internally safe
            return (mod.name, owner, tail)
        if (
            root in decls.global_fields
            and root not in fi.locals
            and root not in mod.imports_by_local
        ):
            if root in decls.global_prims:
                return None
            return (mod.name, "", root)
        return None

    def _resolve_callable(
        self, mod: Module, fi: FuncInfo, expr: ast.AST
    ) -> Optional[str]:
        """Function key for a callable reference (thread targets)."""
        dn = dotted_name(expr)
        if dn is None:
            return None
        parts = dn.split(".")
        if len(parts) == 1:
            keys = self.by_name.get((mod.name, parts[0]), [])
            if keys:
                return keys[0]
        if parts[0] in ("self", "cls") and len(parts) == 2 and fi.cls:
            keys = self.by_method.get((mod.name, fi.cls, parts[1]), [])
            if keys:
                return keys[0]
        for m, attr in resolve_chain(mod, expr):
            if attr:
                keys = self.by_name.get((m, attr), [])
                for k in keys:
                    if self.functions[k].cls is None:
                        return k
        return None

    def _call_targets(
        self, mod: Module, fi: FuncInfo, call: ast.Call
    ) -> List[str]:
        """Call-graph edges for one call, module/class aware: bare names
        bind in-module, ``self.m()``/``cls.m()`` bind to the enclosing
        class, imported chains bind cross-module."""
        dn = dotted_name(call.func)
        if dn is None:
            return []
        parts = dn.split(".")
        out: List[str] = []
        if parts[0] in ("self", "cls") and len(parts) == 2 and fi.cls:
            out.extend(self.by_method.get((mod.name, fi.cls, parts[1]), []))
        elif len(parts) == 1:
            out.extend(self.by_name.get((mod.name, parts[0]), []))
            if not out:
                for m, attr in resolve_chain(mod, call.func):
                    if attr:
                        out.extend(
                            k
                            for k in self.by_name.get((m, attr), [])
                            if self.functions[k].cls is None
                        )
        else:
            for m, attr in resolve_chain(mod, call.func):
                if attr:
                    out.extend(
                        k
                        for k in self.by_name.get((m, attr), [])
                        if self.functions[k].cls is None
                    )
        return out

    # ----------------------------------------------------- build: scan

    def _collect_functions(self, mod: Module) -> None:
        decls = self.decls[mod.name]
        mkey = self._module_key(mod)
        self.functions[mkey] = FuncInfo(
            key=mkey,
            module=mod.name,
            path=mod.path,
            qualname="<module>",
            name="<module>",
            cls=None,
            node=None,
        )
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qn = scope_qualname(node)
            key = f"{mod.name}::{qn}"
            cls = _enclosing_class(node)
            fi = FuncInfo(
                key=key,
                module=mod.name,
                path=mod.path,
                qualname=qn,
                name=node.name,
                cls=cls,
                node=node,
            )
            self.functions[key] = fi
            self.by_name.setdefault((mod.name, node.name), []).append(key)
            if cls:
                self.by_method.setdefault(
                    (mod.name, cls, node.name), []
                ).append(key)
        # lock table: declared sync attrs + module globals
        for (cls, attr), kind in decls.attr_prims.items():
            if kind in _LOCKLIKE:
                self.locks[(mod.name, cls, attr)] = kind
        for name, kind in decls.global_prims.items():
            if kind in _LOCKLIKE:
                self.locks[(mod.name, "", name)] = kind

    def _prescan_function(self, mod: Module, fi: FuncInfo) -> None:
        """Locals, ``global`` decls, lock aliases, primitive locals —
        flow-insensitive, good enough for the alias idioms in use
        (``cv = self._world._mail_cv``, ``done = threading.Event()``)."""
        if fi.node is None:
            root: ast.AST = mod.tree
        else:
            root = fi.node
            args = fi.node.args  # type: ignore[union-attr]
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ):
                fi.locals.add(a.arg)
        for n in _owned_nodes(root):
            if isinstance(n, ast.Global):
                fi.global_decls.update(n.names)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                if n.id not in fi.global_decls:
                    fi.locals.add(n.id)
        fi.locals -= fi.global_decls
        for n in _owned_nodes(root):
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
            ):
                name = n.targets[0].id
                kind = _sync_ctor_kind(mod, n.value)
                if kind:
                    fi.prim_locals[name] = kind
                    continue
                lk = self._lock_from_chain(mod, fi, n.value)
                if lk:
                    fi.lock_aliases[name] = lk

    def _scan_held(self, mod: Module, fi: FuncInfo) -> None:
        """Lexical held-lock stamping over one function body, recording
        acquisition order edges along the way.  ``with``/``acquire``-
        ``release`` within one statement list is the supported shape;
        acquisitions inside a branch do not leak past it."""
        scope = fi.qualname

        def stamp(node: ast.AST, held: FrozenSet[LockId]) -> None:
            self.held_at[id(node)] = held
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                     ast.ClassDef),
                ):
                    self.held_at[id(child)] = held
                    continue
                stamp(child, held)

        def on_acquire(
            lock: LockId, held: FrozenSet[LockId], node: ast.AST
        ) -> None:
            self.acquisitions.append(
                Acquire(
                    lock=lock,
                    held_before=held,
                    func_key=fi.key,
                    path=mod.path,
                    line=getattr(node, "lineno", 0),
                    scope=scope,
                )
            )

        def walk(stmts: Sequence[ast.stmt], held0: FrozenSet[LockId]) -> None:
            held = set(held0)
            for stmt in stmts:
                cur = frozenset(held)
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    acquired: Set[LockId] = set()
                    for item in stmt.items:
                        stamp(item.context_expr, cur)
                        lk = self._lock_from_chain(
                            mod, fi, item.context_expr
                        )
                        if lk is not None:
                            acquired.add(lk)
                            on_acquire(lk, cur, item.context_expr)
                            if isinstance(item.optional_vars, ast.Name):
                                fi.lock_aliases[item.optional_vars.id] = lk
                    self.held_at[id(stmt)] = cur
                    if acquired:
                        self.with_locks[id(stmt)] = frozenset(acquired)
                    walk(stmt.body, frozenset(held | acquired))
                    continue
                if isinstance(stmt, ast.Expr) and isinstance(
                    stmt.value, ast.Call
                ):
                    call = stmt.value
                    if (
                        isinstance(call.func, ast.Attribute)
                        and call.func.attr in ("acquire", "release")
                    ):
                        lk = self._lock_from_chain(mod, fi, call.func.value)
                        if lk is not None:
                            stamp(stmt, cur)
                            if call.func.attr == "acquire":
                                on_acquire(lk, cur, stmt)
                                held.add(lk)
                            else:
                                held.discard(lk)
                            continue
                if isinstance(stmt, (ast.If, ast.While)):
                    stamp(stmt.test, cur)
                    self.held_at[id(stmt)] = cur
                    walk(stmt.body, cur)
                    walk(stmt.orelse, cur)
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    stamp(stmt.target, cur)
                    stamp(stmt.iter, cur)
                    self.held_at[id(stmt)] = cur
                    walk(stmt.body, cur)
                    walk(stmt.orelse, cur)
                    continue
                if isinstance(stmt, ast.Try):
                    self.held_at[id(stmt)] = cur
                    walk(stmt.body, cur)
                    for h in stmt.handlers:
                        self.held_at[id(h)] = cur
                        if h.type is not None:
                            stamp(h.type, cur)
                        walk(h.body, cur)
                    walk(stmt.orelse, cur)
                    walk(stmt.finalbody, cur)
                    continue
                if isinstance(
                    stmt,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    self.held_at[id(stmt)] = cur
                    continue
                stamp(stmt, cur)

        if fi.node is None:
            body = [
                s
                for s in mod.tree.body  # type: ignore[attr-defined]
                if not isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                )
            ]
            walk(body, frozenset())
        else:
            walk(fi.node.body, frozenset())  # type: ignore[union-attr]

    def _prim_kind_of(
        self, mod: Module, fi: FuncInfo, expr: ast.AST
    ) -> Optional[str]:
        """Sync-primitive kind of a receiver expression, if known:
        a primitive local, a declared primitive attribute (any chain
        depth), or a module-global primitive."""
        dn = dotted_name(expr)
        if dn is None:
            return None
        parts = dn.split(".")
        decls = self.decls[mod.name]
        if len(parts) == 1:
            if parts[0] in fi.prim_locals:
                return fi.prim_locals[parts[0]]
            if (
                parts[0] not in fi.locals
                and parts[0] in decls.global_prims
            ):
                return decls.global_prims[parts[0]]
            return None
        tail = parts[-1]
        owners = decls.attr_owners.get(tail, set())
        kinds = {
            decls.attr_prims[(c, tail)]
            for c in owners
            if (c, tail) in decls.attr_prims
        }
        if len(kinds) == 1:
            return next(iter(kinds))
        return None

    @staticmethod
    def _is_write_ctx(node: ast.Attribute) -> bool:
        """Store/Del on the attribute itself, or on a subscript chain
        hanging off it (``self._mail[k] = v`` mutates ``_mail``)."""
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        cur: ast.AST = node
        p = parent(node)
        while isinstance(p, ast.Subscript) and p.value is cur:
            if isinstance(p.ctx, (ast.Store, ast.Del)):
                return True
            cur, p = p, parent(p)
        return False

    def _scan_accesses(self, mod: Module, fi: FuncInfo) -> None:
        """Field accesses, blocking calls, join sites, and thread
        construction sites in one owned-node sweep."""
        root: ast.AST = mod.tree if fi.node is None else fi.node
        decls = self.decls[mod.name]
        scope = fi.qualname

        def add_access(
            fid: FieldId, node: ast.AST, write: bool
        ) -> None:
            self.fields.setdefault(fid, []).append(
                Access(
                    field=fid,
                    path=mod.path,
                    line=getattr(node, "lineno", 0),
                    scope=scope,
                    func_key=fi.key,
                    write=write,
                    held=self.held_at.get(id(node), frozenset()),
                    in_init=fi.is_init,
                    node=node,
                )
            )

        for n in _owned_nodes(root):
            if isinstance(n, ast.Attribute) and not isinstance(
                parent(n), ast.Attribute
            ):
                dn = dotted_name(n)
                if dn is None:
                    continue
                parts = dn.split(".")
                p = parent(n)
                is_call = isinstance(p, ast.Call) and p.func is n
                if is_call:
                    # method call: the receiver chain is the access
                    recv = parts[:-1]
                    if not recv:
                        continue
                    fid = self._field_from_parts(mod, fi, recv)
                    if fid is not None:
                        add_access(fid, n, parts[-1] in _MUTATORS)
                else:
                    fid = self._field_from_parts(mod, fi, parts)
                    if fid is not None:
                        add_access(fid, n, self._is_write_ctx(n))
            elif isinstance(n, ast.Name) and not isinstance(
                parent(n), ast.Attribute
            ):
                if (
                    n.id in decls.global_fields
                    and n.id not in decls.global_prims
                    and n.id not in fi.locals
                    and n.id not in mod.imports_by_local
                ):
                    if isinstance(n.ctx, ast.Load):
                        write = False
                        cur: ast.AST = n
                        p = parent(n)
                        while isinstance(p, ast.Subscript) and p.value is cur:
                            if isinstance(p.ctx, (ast.Store, ast.Del)):
                                write = True
                                break
                            cur, p = p, parent(p)
                        add_access((mod.name, "", n.id), n, write)
                    elif n.id in fi.global_decls or fi.node is None:
                        add_access((mod.name, "", n.id), n, True)
            if not isinstance(n, ast.Call):
                continue
            # ---- thread construction sites
            kind = _sync_ctor_kind(mod, n)
            if kind in ("thread", "timer"):
                self._record_thread_site(mod, fi, n, kind)
                continue
            if not isinstance(n.func, ast.Attribute):
                continue
            attr = n.func.attr
            recv_expr = n.func.value
            held = self.held_at.get(id(n), frozenset())
            if attr in ("join", "cancel"):
                rdn = dotted_name(recv_expr)
                rkind = self._prim_kind_of(mod, fi, recv_expr)
                if rkind in ("thread", "timer"):
                    if rdn:
                        self.joins.setdefault(mod.name, set()).add(
                            rdn.split(".")[-1]
                        )
                    if attr == "join":
                        self.blocking.append(
                            BlockingCall(
                                label=f"{rdn or '?'}.join()",
                                exempt=None,
                                held=held,
                                func_key=fi.key,
                                path=mod.path,
                                line=n.lineno,
                                scope=scope,
                            )
                        )
                elif rdn:
                    # unresolved receiver: still count the join for the
                    # lifecycle rule (loop vars over thread lists)
                    self.joins.setdefault(mod.name, set()).add(
                        rdn.split(".")[-1]
                    )
                self.join_funcs.add(fi.key)
                continue
            blocked: Optional[str] = None
            exempt: Optional[LockId] = None
            if attr == "wait":
                lk = self._lock_from_chain(mod, fi, recv_expr)
                rkind = self._prim_kind_of(mod, fi, recv_expr)
                if lk is not None:
                    blocked, exempt = "Condition.wait", lk
                elif rkind in ("event", "barrier"):
                    blocked = f"{rkind.capitalize()}.wait"
            elif attr in ("get", "put"):
                if self._prim_kind_of(mod, fi, recv_expr) == "queue":
                    blocked = f"queue.{attr}"
            elif attr in _BLOCKING_COLLECTIVES:
                blocked = f"{attr}()"
            elif attr == "sleep":
                for m, _a in resolve_chain(mod, n.func):
                    if m == "time":
                        blocked = "time.sleep"
                        break
            if blocked:
                self.blocking.append(
                    BlockingCall(
                        label=blocked,
                        exempt=exempt,
                        held=held,
                        func_key=fi.key,
                        path=mod.path,
                        line=n.lineno,
                        scope=scope,
                    )
                )

    def _record_thread_site(
        self, mod: Module, fi: FuncInfo, call: ast.Call, kind: str
    ) -> None:
        daemon: Optional[bool] = None
        target_expr: Optional[ast.AST] = None
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
            elif kw.arg in ("target", "function"):
                target_expr = kw.value
        if kind == "timer" and target_expr is None and len(call.args) >= 2:
            target_expr = call.args[1]
        target_key = (
            self._resolve_callable(mod, fi, target_expr)
            if target_expr is not None
            else None
        )
        binding: Optional[str] = None
        binding_is_attr = False
        p: Optional[ast.AST] = parent(call)
        while p is not None and not isinstance(p, ast.stmt):
            p = parent(p)
        if isinstance(p, ast.Assign) and len(p.targets) == 1:
            t = p.targets[0]
            if isinstance(t, ast.Name):
                binding = t.id
            elif isinstance(t, ast.Attribute):
                binding = t.attr
                binding_is_attr = True
        if binding is not None and daemon is None:
            # `t.daemon = True` after construction, anywhere in the fn
            root = mod.tree if fi.node is None else fi.node
            for n in _owned_nodes(root):
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Attribute)
                    and n.targets[0].attr == "daemon"
                    and dotted_name(n.targets[0].value) is not None
                    and dotted_name(n.targets[0].value).split(".")[-1]
                    == binding
                    and isinstance(n.value, ast.Constant)
                ):
                    daemon = bool(n.value.value)
        self.thread_sites.append(
            ThreadSite(
                kind=kind,
                module=mod.name,
                path=mod.path,
                line=call.lineno,
                scope=fi.qualname,
                func_key=fi.key,
                daemon=daemon,
                target_key=target_key,
                target_name=(
                    dotted_name(target_expr)
                    if target_expr is not None
                    else None
                ),
                binding=binding,
                binding_is_attr=binding_is_attr,
            )
        )

    # ---------------------------------------------------- build: graph

    def _build_call_graph(self) -> None:
        for mod in self.mods:
            for fi in list(self.functions.values()):
                if fi.module != mod.name:
                    continue
                root = mod.tree if fi.node is None else fi.node
                for n in _owned_nodes(root):
                    if not isinstance(n, ast.Call):
                        continue
                    for tgt in self._call_targets(mod, fi, n):
                        if tgt == fi.key:
                            continue
                        self.calls.setdefault(fi.key, set()).add(tgt)
                        self.call_sites.setdefault(tgt, []).append(
                            (fi.key, n)
                        )

    def _mark_concurrent(self) -> None:
        """Thread-entry reachability plus the lock-owner heuristic."""
        entries: Dict[str, str] = {}
        for site in self.thread_sites:
            if site.target_key is not None:
                entries.setdefault(
                    site.target_key,
                    f"thread target at {_norm(site.path)}:{site.line}",
                )
        for mod in self.mods:
            decls = self.decls[mod.name]
            for cls in decls.thread_subclasses:
                for key in self.by_method.get((mod.name, cls, "run"), []):
                    entries.setdefault(key, f"{cls}.run (Thread subclass)")
            lock_classes = {
                c
                for (c, _a), kind in decls.attr_prims.items()
                if kind in _LOCKLIKE
            }
            module_locked = any(
                kind in _LOCKLIKE for kind in decls.global_prims.values()
            )
            for fi in self.functions.values():
                if fi.module != mod.name or fi.node is None:
                    continue
                if fi.cls in lock_classes and fi.name not in _INIT_METHODS:
                    entries.setdefault(
                        fi.key, f"method of lock-owning class {fi.cls}"
                    )
                elif (
                    module_locked
                    and fi.cls is None
                    and "." not in fi.qualname
                ):
                    entries.setdefault(
                        fi.key,
                        f"function of lock-owning module "
                        f"{self._short(mod.name)}",
                    )
        # BFS over the call graph
        pending = list(entries)
        self.concurrent.update(entries)
        while pending:
            cur = pending.pop()
            for nxt in self.calls.get(cur, ()):
                if nxt not in self.concurrent:
                    self.concurrent[nxt] = (
                        f"called from concurrent "
                        f"`{self.functions[cur].qualname}`"
                    )
                    pending.append(nxt)
        self._thread_entries = set(entries)

    def _propagate_entry_held(self) -> None:
        """entry_held(f) = intersection over analyzed call sites of the
        locks held around the call.  Thread targets are forced empty (a
        thread starts with nothing); functions without analyzed callers
        default empty (external callers are unknown)."""
        forced_empty = {
            s.target_key
            for s in self.thread_sites
            if s.target_key is not None
        }
        self.entry_held = {k: frozenset() for k in self.functions}
        for _ in range(4):
            changed = False
            for callee, sites in self.call_sites.items():
                if callee in forced_empty or callee not in self.functions:
                    continue
                acc: Optional[FrozenSet[LockId]] = None
                for caller, node in sites:
                    site_held = self.held_at.get(
                        id(node), frozenset()
                    ) | self.entry_held.get(caller, frozenset())
                    acc = (
                        site_held if acc is None else (acc & site_held)
                    )
                new = acc or frozenset()
                if new != self.entry_held.get(callee):
                    self.entry_held[callee] = new
                    changed = True
            if not changed:
                break

    def _infer_guards(self) -> None:
        """TPU006's association: a mutable field is guarded by the locks
        observed held at any of its non-init accesses.  Fields never
        written outside ``__init__`` (immutable-after-publication) and
        fields never accessed under any lock (lock-free by design) stay
        out of the table."""
        for fid, accesses in self.fields.items():
            live = [a for a in accesses if not a.in_init]
            if not any(a.write for a in live):
                continue
            guards: Set[LockId] = set()
            for a in live:
                guards |= self.held_for(a)
            if guards:
                self.guards[fid] = frozenset(guards)


_MODEL_CACHE: List[Tuple[Tuple[Module, ...], "ConcurrencyModel"]] = []


def build_concurrency_model(mods: List[Module]) -> ConcurrencyModel:
    model = ConcurrencyModel()
    model.mods = list(mods)
    for mod in mods:
        model.decls[mod.name] = _collect_decls(mod)
    for mod in mods:
        model._collect_functions(mod)
    by_module: Dict[str, Module] = {m.name: m for m in mods}
    for fi in model.functions.values():
        model._prescan_function(by_module[fi.module], fi)
    for fi in model.functions.values():
        model._scan_held(by_module[fi.module], fi)
    for fi in model.functions.values():
        model._scan_accesses(by_module[fi.module], fi)
    model._build_call_graph()
    model._mark_concurrent()
    model._propagate_entry_held()
    model._infer_guards()
    return model


def concurrency_model(mods: List[Module]) -> ConcurrencyModel:
    """Memoized :func:`build_concurrency_model` so the four concurrency
    rules share one model per analyzer run.  The key holds the Module
    objects themselves (not their ids): a strong reference pins each
    object, so a recycled id can never alias a stale model onto a
    different module list."""
    key = tuple(mods)
    for k, m in _MODEL_CACHE:
        if len(k) == len(key) and all(a is b for a, b in zip(k, key)):
            return m
    model = build_concurrency_model(mods)
    _MODEL_CACHE.append((key, model))
    del _MODEL_CACHE[:-4]
    return model


# ============================================================== dataflow
# Intraprocedural abstract interpretation for the dataflow tier
# (TPU010 mask-discipline, TPU011 pad-neutrality, TPU012 dtype-stability).
#
# The interpreter runs a forward walk over one function body on a product
# lattice per value:
#
# * **provenance** — which of {"raw", "mask"} the value derives from.
#   Mask parameters seed {"mask"}; every other parameter seeds {"raw"}
#   (in a mask-accepting function the data arguments are, by the
#   bucketing contract, padded batch rows).  A full reduction over a
#   value whose provenance is raw-without-mask means the validity mask
#   was dropped on that path (TPU010).
# * **numeric abstraction** — the all-masked evaluation used for the
#   pad-neutrality proof (TPU011): the mask is ZERO, ``sum(mask) > 0``
#   is FALSE, ``where(FALSE, a, b)`` is ``b``, and a read of the state
#   being written is IDENT.  A read-modify-write whose right-hand side
#   evaluates to anything but IDENT is not a no-op on a fully-masked
#   pad step.
# * **dtype abstraction** — literal casts (``torch.float32`` /
#   ``.to(dtype)`` / ``.float()`` and numpy's ``astype``) and promotion
#   on arithmetic, enough to spot int-state arithmetic against float
#   factors (TPU012's sanctioned-cast check).
#
# The vocabulary is torch's beside numpy's: ``torch.where``, the
# reducers in function and method form (``dim=`` or ``axis=``),
# ``index_add_`` / ``scatter_add_`` / ``torch.bincount`` and the port's
# ``_scatter.at_add`` as segment reducers, and the pass-through shape
# and placement calls (``view``, ``unsqueeze``, ``.to(device)``, ...).
#
# Path sensitivity is exactly one bit: the walk is specialized to the
# *mask-present* world, so ``if mask is None:`` branches (the unmasked
# fast paths, which owe no mask discipline) are skipped and ``if mask
# is not None:`` branches are always taken.  Everything the analysis
# cannot prove joins toward TOP / impure, which silences the checks —
# the rules only fire on facts the lattice actually proves.

#: Parameter names that make a function "mask-accepting": its data
#: arguments are padded batch rows and every full reduction must thread
#: the mask.  Locals derived from ``kwargs.get("mask")`` /
#: ``kwargs.pop("mask", ...)`` count too (``collection._trace_update``).
MASK_PARAM_NAMES = frozenset(
    {
        "mask",
        "masks",
        "row_mask",
        "valid_mask",
        "base_mask",
        "stacked_mask",
        "step_mask",
        "smask",
        "any_valid",
        "validity",
    }
)

_FuncDefT = (ast.FunctionDef, ast.AsyncFunctionDef)

# Full-array reducers (module attribute or method form).  Builtin host
# reducers (bare ``sum``/``max`` over Python lists) are deliberately
# excluded: the mask contract governs device reductions over padded
# arrays, not host bookkeeping.
_REDUCER_NAMES = frozenset(
    {
        "sum",
        "mean",
        "max",
        "min",
        "prod",
        "any",
        "all",
        "count_nonzero",
        "nansum",
        "nanmean",
        "nanmax",
        "nanmin",
        "median",
        "std",
        "var",
        "average",
    }
)
_SEGMENT_REDUCERS = frozenset(
    {"segment_sum", "segment_max", "segment_min", "segment_prod", "bincount"}
)
# In-place / out-of-place scatters into a state tensor:
# ``state.index_add_(dim, index, source)`` and
# ``state.scatter_add_(dim, index, src)`` reduce their third argument.
_SCATTER_METHODS = frozenset(
    {"index_add_", "index_add", "scatter_add_", "scatter_add",
     "scatter_reduce_", "scatter_reduce"}
)
_SCATTER_SOURCE_KW = ("source", "src")
# The port's ``metrics/functional/_scatter.at_add(length, index, values)``:
# JAX's ``zeros(length).at[index].add(values)`` spelled once.
_AT_ADD_NAMES = frozenset({"at_add"})

_WHERE_CHAINS = frozenset(
    {"np.where", "numpy.where", "torch.where"}
)

# dtype tags: f64/f32/f16/bf16 (strong floats), i32/i64 (strong ints),
# b (bool), wf/wi (weak Python float/int scalars), None = unknown.
_FLOAT_DTS = frozenset({"f64", "f32", "f16", "bf16", "wf"})
_DTYPE_CHAINS = {
    "np.float64": "f64",
    "numpy.float64": "f64",
    "np.float32": "f32",
    "numpy.float32": "f32",
    "np.int32": "i32",
    "np.int64": "i64",
    "np.bool_": "b",
    "torch.float64": "f64",
    "torch.double": "f64",
    "torch.float32": "f32",
    "torch.float": "f32",
    "torch.float16": "f16",
    "torch.half": "f16",
    "torch.bfloat16": "bf16",
    "torch.int32": "i32",
    "torch.int": "i32",
    "torch.int64": "i64",
    "torch.long": "i64",
    "torch.bool": "b",
}
# Tensor cast methods with no argument: ``x.double()`` and friends.
_CAST_METHODS = {
    "double": "f64",
    "float": "f32",
    "half": "f16",
    "bfloat16": "bf16",
    "int": "i32",
    "long": "i64",
    "bool": "b",
}
_DTYPE_STRINGS = {
    "float64": "f64",
    "double": "f64",
    "float32": "f32",
    "float16": "f16",
    "bfloat16": "bf16",
    "int32": "i32",
    "int64": "i64",
    "bool": "b",
}
_DT_ORDER = ("f64", "f32", "bf16", "f16", "i64", "i32", "b", "wf", "wi")

# Pass-through calls: shape/cast ops whose result keeps the operand's
# provenance and numeric abstraction (``astype`` additionally retags the
# dtype; handled at the call site).
_TRANSPARENT_CALLS = frozenset(
    {
        "np.asarray",
        "np.array",
        "torch.as_tensor",
        "torch.tensor",
        "torch.asarray",
        "torch.reshape",
        "torch.broadcast_to",
        "torch.unsqueeze",
        "torch.squeeze",
        "torch.flatten",
        "torch.ravel",
        "torch.abs",
        "torch.neg",
        "torch.negative",
        "torch.transpose",
    }
)
_TRANSPARENT_METHODS = frozenset(
    {
        "reshape", "broadcast_to", "squeeze", "ravel", "flatten",
        "transpose", "view", "view_as", "reshape_as", "unsqueeze",
        "contiguous", "expand", "expand_as",
    }
)
# Module heads whose reducer attributes are the function form
# (``torch.sum(x)``), not a method on a value.
_REDUCER_MODULES = frozenset(
    {"np", "numpy", "math", "torch"}
)
_ZEROS_CHAINS = frozenset(
    {"np.zeros", "np.zeros_like", "torch.zeros", "torch.zeros_like"}
)
_ONES_CHAINS = frozenset(
    {"np.ones", "np.ones_like", "torch.ones", "torch.ones_like"}
)
_PURE_BUILTINS = frozenset(
    {
        "int",
        "float",
        "bool",
        "str",
        "len",
        "tuple",
        "list",
        "dict",
        "set",
        "abs",
        "round",
        "zip",
        "enumerate",
        "range",
        "isinstance",
        "hasattr",
        "sorted",
        "reversed",
    }
)


@dataclass(frozen=True)
class AbstractValue:
    """One point of the product lattice (provenance × numeric × dtype),
    plus a purity bit: ``pure=False`` marks values routed through an
    unresolved call, which exempts read-modify-writes from the
    neutrality verdict (the callee owns the proof)."""

    prov: frozenset = frozenset()
    num: str = "top"  # zero|one|false|true|const|ident|none|top
    dt: Optional[str] = None
    pure: bool = True
    elts: Optional[Tuple["AbstractValue", ...]] = None

    def with_(self, **kw) -> "AbstractValue":
        merged = {
            "prov": self.prov,
            "num": self.num,
            "dt": self.dt,
            "pure": self.pure,
            "elts": self.elts,
        }
        merged.update(kw)
        return AbstractValue(**merged)


_TOP = AbstractValue()


def _av_join(a: AbstractValue, b: AbstractValue) -> AbstractValue:
    return AbstractValue(
        prov=a.prov | b.prov,
        num=a.num if a.num == b.num else "top",
        dt=a.dt if a.dt == b.dt else None,
        pure=a.pure and b.pure,
    )


def _dt_promote(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None or b is None:
        return None
    for dt in _DT_ORDER:
        if a == dt or b == dt:
            return dt
    return None


def _num_mul(a: str, b: str) -> str:
    if "zero" in (a, b):
        return "zero"
    if a == "one":
        return b
    if b == "one":
        return a
    if "ident" in (a, b):
        return "top"
    if a == b == "const":
        return "const"
    return "top"


def _num_add(a: str, b: str) -> str:
    if a == "zero":
        return b
    if b == "zero":
        return a
    if "ident" in (a, b):
        return "top"
    if a == b == "const":
        return "const"
    return "top"


@dataclass
class RawReduction:
    """A full reduction whose operand is raw-without-mask (TPU010)."""

    node: ast.AST
    symbol: str
    operand: str


@dataclass
class NonNeutralWrite:
    """A read-modify-write whose all-masked value is not IDENT
    (TPU011)."""

    node: ast.AST
    symbol: str
    detail: str


@dataclass
class FloatStateMult:
    """A read-modify-write multiplying state by a float-typed factor —
    TPU012's int-state hazard when the owning class lacks the
    sanctioned float32 normalization."""

    node: ast.AST
    symbol: str


@dataclass
class DataflowSummary:
    """The per-function output of the mask-present abstract walk."""

    func: ast.AST
    mask_names: Set[str]
    raw_reductions: List[RawReduction] = field(default_factory=list)
    nonneutral_writes: List[NonNeutralWrite] = field(default_factory=list)
    float_state_mults: List[FloatStateMult] = field(default_factory=list)


def mask_param_names(func: ast.AST) -> Set[str]:
    """Parameters of ``func`` whose names mark them as validity masks."""
    args = func.args
    every = (
        list(args.posonlyargs)
        + list(args.args)
        + list(args.kwonlyargs)
        + ([args.vararg] if args.vararg else [])
    )
    return {a.arg for a in every if a.arg in MASK_PARAM_NAMES}


def kwargs_mask_locals(func: ast.AST) -> Set[str]:
    """Local names bound from ``<dict>.get("mask")`` / ``<dict>.pop(
    "mask", ...)`` — the keyword-threading form of mask acceptance."""
    out: Set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        call = node.value
        if (
            isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr in ("get", "pop")
            and call.args
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value in MASK_PARAM_NAMES
        ):
            out.add(target.id)
    return out


def is_mask_accepting(func: ast.AST) -> bool:
    return bool(mask_param_names(func) or kwargs_mask_locals(func))


def _param_names(func: ast.AST) -> List[str]:
    args = func.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _operand_desc(node: ast.AST) -> str:
    name = dotted_name(node)
    if name:
        return name
    if isinstance(node, ast.Call):
        inner = dotted_name(node.func)
        return f"{inner}(...)" if inner else "<call>"
    return "<expr>"


class _MaskInterp:
    """The mask-present abstract walk over one function body."""

    def __init__(self, func: ast.AST, mask_names: Set[str]) -> None:
        self.func = func
        self.mask_names = set(mask_names)
        self.summary = DataflowSummary(func=func, mask_names=self.mask_names)
        self.nested: Dict[str, ast.AST] = {
            st.name: st
            for st in ast.walk(func)
            if isinstance(st, _FuncDefT) and st is not func
        }
        # Read-modify-write pattern currently being evaluated: a dotted
        # attribute chain, and (for setattr/getattr form) the dumped
        # name expression.
        self._ident_attr: Optional[str] = None
        self._ident_pair: Optional[Tuple[str, str]] = None
        self._seen_reductions: Set[int] = set()

    # ----------------------------------------------------------- driver
    def run(self) -> DataflowSummary:
        env: Dict[str, AbstractValue] = {}
        mask_value = AbstractValue(
            prov=frozenset({"mask"}), num="zero", dt="i32"
        )
        for name in _param_names(self.func):
            if name in self.mask_names:
                env[name] = mask_value
            elif name in ("self", "cls"):
                env[name] = _TOP
            else:
                env[name] = AbstractValue(prov=frozenset({"raw"}))
        self._walk(self.func.body, env)
        return self.summary

    # ------------------------------------------------------- statements
    def _walk(self, stmts: List[ast.stmt], env: Dict[str, AbstractValue]) -> bool:
        """Walk statements in ``env`` (mutated in place).  Returns True
        when the block definitely terminates (return/raise)."""
        for st in stmts:
            if isinstance(st, (ast.Return,)):
                if st.value is not None:
                    self._eval(st.value, env)
                return True
            if isinstance(st, ast.Raise):
                return True
            if isinstance(st, _FuncDefT + (ast.ClassDef,)):
                continue
            if isinstance(st, ast.Assign):
                self._assign(st, env)
            elif isinstance(st, ast.AugAssign):
                self._aug_assign(st, env)
            elif isinstance(st, ast.AnnAssign):
                if st.value is not None:
                    value = self._eval(st.value, env)
                    if isinstance(st.target, ast.Name):
                        env[st.target.id] = value
            elif isinstance(st, ast.Expr):
                self._eval_stmt_call(st.value, env)
            elif isinstance(st, ast.If):
                truth = self._truth(st.test, env)
                if truth is None:
                    self._eval(st.test, env)
                    body_env = dict(env)
                    else_env = dict(env)
                    body_done = self._walk(st.body, body_env)
                    else_done = self._walk(st.orelse, else_env)
                    if body_done and else_done:
                        return True
                    if body_done:
                        env.clear()
                        env.update(else_env)
                    elif else_done:
                        env.clear()
                        env.update(body_env)
                    else:
                        merged = {
                            k: _av_join(body_env[k], else_env[k])
                            if k in else_env
                            else body_env[k]
                            for k in body_env
                        }
                        for k in else_env:
                            merged.setdefault(k, else_env[k])
                        env.clear()
                        env.update(merged)
                elif truth:
                    if self._walk(st.body, env):
                        return True
                else:
                    if self._walk(st.orelse, env):
                        return True
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                iter_value = self._eval(st.iter, env)
                self._bind_target(
                    st.target,
                    AbstractValue(prov=iter_value.prov, pure=iter_value.pure),
                    env,
                )
                self._walk(st.body, env)
                self._walk(st.orelse, env)
            elif isinstance(st, ast.While):
                self._eval(st.test, env)
                self._walk(st.body, env)
                self._walk(st.orelse, env)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    value = self._eval(item.context_expr, env)
                    if item.optional_vars is not None:
                        self._bind_target(item.optional_vars, value, env)
                if self._walk(st.body, env):
                    return True
            elif isinstance(st, ast.Try):
                self._walk(st.body, env)
                for handler in st.handlers:
                    self._walk(handler.body, env)
                self._walk(st.orelse, env)
                self._walk(st.finalbody, env)
            elif isinstance(st, ast.Assert):
                self._eval(st.test, env)
            elif isinstance(st, (ast.Delete, ast.Global, ast.Nonlocal)):
                pass
            elif isinstance(st, (ast.Break, ast.Continue, ast.Pass)):
                pass
            else:  # Import, Match, ... — evaluate nothing
                pass
        return False

    def _bind_target(
        self,
        target: ast.AST,
        value: AbstractValue,
        env: Dict[str, AbstractValue],
    ) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = value.elts
            for i, sub in enumerate(target.elts):
                if elts is not None and i < len(elts):
                    self._bind_target(sub, elts[i], env)
                else:
                    self._bind_target(
                        sub, AbstractValue(prov=value.prov, pure=value.pure), env
                    )
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, value, env)
        # Attribute / Subscript stores don't enter the local env.

    def _assign(self, st: ast.Assign, env: Dict[str, AbstractValue]) -> None:
        if len(st.targets) == 1 and isinstance(st.targets[0], ast.Attribute):
            target = st.targets[0]
            dotted = dotted_name(target)
            if dotted and self._contains_attr(st.value, dotted):
                self._check_rmw(
                    st, dotted, None, st.value, env, symbol=dotted
                )
                return
        value = self._eval(st.value, env)
        for target in st.targets:
            self._bind_target(target, value, env)

    def _aug_assign(self, st: ast.AugAssign, env: Dict[str, AbstractValue]) -> None:
        if isinstance(st.target, ast.Name):
            old = env.get(st.target.id, _TOP)
            rhs = self._eval(st.value, env)
            env[st.target.id] = self._binop_value(st.op, old, rhs)
            return
        if isinstance(st.target, ast.Attribute):
            dotted = dotted_name(st.target)
            if dotted:
                prev = self._ident_attr
                self._ident_attr = dotted
                try:
                    rhs = self._eval(st.value, env)
                    ident = AbstractValue(num="ident")
                    new = self._binop_value(st.op, ident, rhs)
                finally:
                    self._ident_attr = prev
                self._verdict_rmw(st, dotted, new)
                return
        self._eval(st.value, env)

    # ------------------------------------------------ read-modify-write
    def _contains_attr(self, expr: ast.AST, dotted: str) -> bool:
        return any(
            isinstance(n, ast.Attribute)
            and isinstance(n.ctx, ast.Load)
            and dotted_name(n) == dotted
            for n in ast.walk(expr)
        )

    @staticmethod
    def _getattr_pattern(call: ast.Call) -> Optional[Tuple[str, str]]:
        """(dotted obj, dumped name expr) for a 2/3-arg ``getattr``."""
        if (
            isinstance(call.func, ast.Name)
            and call.func.id == "getattr"
            and len(call.args) >= 2
        ):
            obj = dotted_name(call.args[0])
            if obj:
                return obj, ast.dump(call.args[1])
        return None

    def _check_rmw(
        self,
        st: ast.stmt,
        ident_attr: Optional[str],
        ident_pair: Optional[Tuple[str, str]],
        rhs: ast.AST,
        env: Dict[str, AbstractValue],
        symbol: str,
    ) -> None:
        prev_attr, prev_pair = self._ident_attr, self._ident_pair
        self._ident_attr, self._ident_pair = ident_attr, ident_pair
        try:
            value = self._eval(rhs, env)
        finally:
            self._ident_attr, self._ident_pair = prev_attr, prev_pair
        self._verdict_rmw(st, symbol, value)

    def _verdict_rmw(
        self, st: ast.stmt, symbol: str, value: AbstractValue
    ) -> None:
        if not value.pure:
            return  # routed through a call — the callee owns the proof
        if value.num != "ident":
            self.summary.nonneutral_writes.append(
                NonNeutralWrite(
                    node=st,
                    symbol=symbol,
                    detail=value.num,
                )
            )

    def _eval_stmt_call(
        self, expr: ast.AST, env: Dict[str, AbstractValue]
    ) -> None:
        """A bare expression statement: check the setattr-RMW form, else
        evaluate normally (reductions inside still get checked)."""
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Name)
            and expr.func.id == "setattr"
            and len(expr.args) == 3
        ):
            obj = dotted_name(expr.args[0])
            name_dump = ast.dump(expr.args[1])
            rhs = expr.args[2]
            if obj is not None:
                matches = any(
                    isinstance(n, ast.Call)
                    and self._getattr_pattern(n) == (obj, name_dump)
                    for n in ast.walk(rhs)
                )
                if matches:
                    label = (
                        expr.args[1].id
                        if isinstance(expr.args[1], ast.Name)
                        else _operand_desc(expr.args[1])
                    )
                    self._check_rmw(
                        expr,
                        None,
                        (obj, name_dump),
                        rhs,
                        env,
                        symbol=f"{obj}.<{label}>",
                    )
                    return
        self._eval(expr, env)

    # ------------------------------------------------------ expressions
    def _truth(
        self, test: ast.AST, env: Dict[str, AbstractValue]
    ) -> Optional[bool]:
        """Resolve a branch condition under the mask-present
        specialization, or None when unknown."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = self._truth(test.operand, env)
            return None if inner is None else not inner
        if isinstance(test, ast.Constant):
            return bool(test.value)
        if (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Is, ast.IsNot))
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
            and isinstance(test.left, ast.Name)
        ):
            name = test.left.id
            if name in self.mask_names:
                is_none = False
            else:
                value = env.get(name)
                if value is None or value.num != "none":
                    return None
                is_none = True
            return is_none if isinstance(test.ops[0], ast.Is) else not is_none
        return None

    def _eval(self, node: ast.AST, env: Dict[str, AbstractValue]) -> AbstractValue:
        if isinstance(node, ast.Name):
            if node.id in self.mask_names:
                return AbstractValue(
                    prov=frozenset({"mask"}), num="zero", dt="i32"
                )
            return env.get(node.id, _TOP)
        if isinstance(node, ast.Constant):
            value = node.value
            if value is None:
                return AbstractValue(num="none")
            if value is True:
                return AbstractValue(num="true", dt="b")
            if value is False:
                return AbstractValue(num="false", dt="b")
            if isinstance(value, (int, float)):
                num = (
                    "zero"
                    if value == 0
                    else "one"
                    if value == 1
                    else "const"
                )
                return AbstractValue(
                    num=num, dt="wi" if isinstance(value, int) else "wf"
                )
            return AbstractValue(num="const")
        if isinstance(node, ast.Attribute):
            if self._ident_attr and dotted_name(node) == self._ident_attr:
                return AbstractValue(num="ident")
            dotted = dotted_name(node)
            if dotted in _DTYPE_CHAINS:
                return AbstractValue(num="const")
            base = self._eval(node.value, env)
            if node.attr in ("shape", "size", "ndim", "dtype"):
                # Array metadata: static under jit, never pad-dependent.
                return AbstractValue(num="const", pure=base.pure)
            # Attribute reads (self._decay, obj.field) are trace-time
            # constants from the neutrality proof's viewpoint.
            return AbstractValue(prov=base.prov, num="const", pure=base.pure)
        if isinstance(node, ast.BinOp):
            left = self._eval(node.left, env)
            right = self._eval(node.right, env)
            return self._binop_node(node, left, right)
        if isinstance(node, ast.UnaryOp):
            operand = self._eval(node.operand, env)
            if isinstance(node.op, ast.USub) and operand.num in (
                "zero",
                "const",
            ):
                return operand.with_(num=operand.num)
            return AbstractValue(
                prov=operand.prov, dt=operand.dt, pure=operand.pure
            )
        if isinstance(node, ast.BoolOp):
            values = [self._eval(v, env) for v in node.values]
            out = values[0]
            for v in values[1:]:
                out = _av_join(out, v)
            return out
        if isinstance(node, ast.Compare):
            left = self._eval(node.left, env)
            rights = [self._eval(c, env) for c in node.comparators]
            prov = left.prov
            pure = left.pure
            for r in rights:
                prov |= r.prov
                pure = pure and r.pure
            num = "top"
            if (
                len(node.ops) == 1
                and left.num == "zero"
                and isinstance(node.comparators[0], ast.Constant)
                and node.comparators[0].value == 0
            ):
                op = node.ops[0]
                if isinstance(op, (ast.Gt, ast.NotEq, ast.Lt)):
                    num = "false"
                elif isinstance(op, (ast.GtE, ast.LtE, ast.Eq)):
                    num = "true"
            return AbstractValue(prov=prov, num=num, dt="b", pure=pure)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env)
        if isinstance(node, ast.IfExp):
            truth = self._truth(node.test, env)
            if truth is True:
                return self._eval(node.body, env)
            if truth is False:
                return self._eval(node.orelse, env)
            self._eval(node.test, env)
            return _av_join(
                self._eval(node.body, env), self._eval(node.orelse, env)
            )
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value, env)
            self._eval(node.slice, env)
            return AbstractValue(prov=base.prov, dt=base.dt, pure=base.pure)
        if isinstance(node, (ast.Tuple, ast.List)):
            elts = tuple(self._eval(e, env) for e in node.elts)
            prov = frozenset().union(*(e.prov for e in elts)) if elts else frozenset()
            pure = all(e.pure for e in elts)
            return AbstractValue(prov=prov, pure=pure, elts=elts)
        if isinstance(node, (ast.Set, ast.Dict)):
            prov: frozenset = frozenset()
            pure = True
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    v = self._eval(child, env)
                    prov |= v.prov
                    pure = pure and v.pure
            return AbstractValue(prov=prov, pure=pure)
        if isinstance(
            node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
        ):
            comp_env = dict(env)
            for gen in node.generators:
                iter_value = self._eval(gen.iter, comp_env)
                self._bind_target(
                    gen.target,
                    AbstractValue(prov=iter_value.prov, pure=iter_value.pure),
                    comp_env,
                )
                for cond in gen.ifs:
                    self._eval(cond, comp_env)
            if isinstance(node, ast.DictComp):
                key = self._eval(node.key, comp_env)
                value = self._eval(node.value, comp_env)
                out = _av_join(key, value)
            else:
                out = self._eval(node.elt, comp_env)
            return AbstractValue(prov=out.prov, pure=out.pure)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self._eval(v.value, env)
            return AbstractValue(num="const")
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env)
        if isinstance(node, ast.Lambda):
            return _TOP
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self._eval(part, env)
            return AbstractValue(num="const")
        return _TOP

    def _binop_node(
        self, node: ast.BinOp, left: AbstractValue, right: AbstractValue
    ) -> AbstractValue:
        prov = left.prov | right.prov
        pure = left.pure and right.pure
        dt = _dt_promote(left.dt, right.dt)
        if isinstance(node.op, ast.Mult):
            num = _num_mul(left.num, right.num)
            # The int-state hazard: state (IDENT) scaled by a
            # float-typed factor.  Whether it matters depends on the
            # owning class's sanctioned cast — the rule decides.
            factor = right if left.num == "ident" else left
            if "ident" in (left.num, right.num) and factor.dt in _FLOAT_DTS:
                symbol = self._ident_attr or (
                    self._ident_pair[0] if self._ident_pair else "<state>"
                )
                self.summary.float_state_mults.append(
                    FloatStateMult(node=node, symbol=symbol)
                )
        elif isinstance(node.op, ast.Add):
            num = _num_add(left.num, right.num)
        elif isinstance(node.op, ast.Sub):
            if right.num == "zero":
                num = left.num
            elif left.num == right.num == "const":
                num = "const"
            else:
                num = "top"
        elif isinstance(node.op, (ast.Div, ast.FloorDiv)):
            num = left.num if right.num == "one" else "top"
            if isinstance(node.op, ast.Div):
                dt = _dt_promote(dt, "wf")
        else:
            num = "top"
        return AbstractValue(prov=prov, num=num, dt=dt, pure=pure)

    def _binop_value(
        self, op: ast.operator, left: AbstractValue, right: AbstractValue
    ) -> AbstractValue:
        shim = ast.BinOp(left=ast.Constant(0), op=op, right=ast.Constant(0))
        return self._binop_node(shim, left, right)

    # ------------------------------------------------------------ calls
    def _axis_exempts(self, call: ast.Call, method: bool) -> bool:
        """True when the reduction has an explicit constant axis that is
        not the leading (batch) axis — per-row reductions (``axis=1`` /
        ``dim=-1``) don't collapse padded rows into live ones."""
        axis: Optional[ast.AST] = None
        for kw in call.keywords:
            if kw.arg in ("axis", "dim"):
                axis = kw.value
        if axis is None:
            pos = 0 if method else 1
            if len(call.args) > pos:
                axis = call.args[pos]
        if axis is None:
            return False
        if isinstance(axis, ast.Constant):
            return axis.value is not None and axis.value != 0
        if isinstance(axis, ast.UnaryOp) and isinstance(axis.op, ast.USub):
            inner = axis.operand
            return isinstance(inner, ast.Constant)  # axis=-k, k>=1
        if isinstance(axis, (ast.Tuple, ast.List)):
            return all(
                isinstance(e, ast.Constant) and e.value != 0
                for e in axis.elts
            )
        return False

    def _record_reduction(
        self,
        call: ast.Call,
        reducer: str,
        operand_node: ast.AST,
        operand: AbstractValue,
    ) -> None:
        if id(call) in self._seen_reductions:
            return
        if "raw" in operand.prov and "mask" not in operand.prov:
            self._seen_reductions.add(id(call))
            self.summary.raw_reductions.append(
                RawReduction(
                    node=call,
                    symbol=f"{reducer}({_operand_desc(operand_node)})",
                    operand=_operand_desc(operand_node),
                )
            )

    def _eval_call(
        self, call: ast.Call, env: Dict[str, AbstractValue]
    ) -> AbstractValue:
        func = call.func
        dotted = dotted_name(func) or ""

        # getattr-of-the-state (the setattr RMW pattern's read side).
        if isinstance(func, ast.Name) and func.id == "getattr":
            pattern = self._getattr_pattern(call)
            if pattern is not None and pattern == self._ident_pair:
                return AbstractValue(num="ident")
            args = [self._eval(a, env) for a in call.args]
            prov = args[0].prov if args else frozenset()
            return AbstractValue(prov=prov)

        # kwargs.get("mask") / kwargs.pop("mask", default).
        if (
            isinstance(func, ast.Attribute)
            and func.attr in ("get", "pop")
            and call.args
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value in MASK_PARAM_NAMES
        ):
            return AbstractValue(prov=frozenset({"mask"}), num="zero", dt="i32")

        # where: the one gate the neutrality proof resolves exactly.
        if dotted in _WHERE_CHAINS and len(call.args) == 3:
            cond = self._eval(call.args[0], env)
            a = self._eval(call.args[1], env)
            b = self._eval(call.args[2], env)
            if cond.num == "false":
                return b.with_(prov=b.prov | cond.prov)
            if cond.num == "true":
                return a.with_(prov=a.prov | cond.prov)
            joined = _av_join(a, b)
            return joined.with_(prov=joined.prov | cond.prov)

        # Literal dtype casts: np.float32(x) and friends.
        if dotted in _DTYPE_CHAINS and len(call.args) == 1:
            arg = self._eval(call.args[0], env)
            return arg.with_(dt=_DTYPE_CHAINS[dotted])

        # astype: retag dtype, keep provenance/numeric value.
        if isinstance(func, ast.Attribute) and func.attr == "astype":
            base = self._eval(func.value, env)
            dt = None
            if call.args:
                dt_node = call.args[0]
                dt = _DTYPE_CHAINS.get(dotted_name(dt_node) or "")
                if (
                    dt is None
                    and isinstance(dt_node, ast.Constant)
                    and isinstance(dt_node.value, str)
                ):
                    dt = _DTYPE_STRINGS.get(dt_node.value)
                self._eval(dt_node, env)
            return base.with_(dt=dt)

        # Tensor casts: x.double() / x.float() / x.long() / x.int() ...
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _CAST_METHODS
            and not call.args
            and not call.keywords
        ):
            base = self._eval(func.value, env)
            return base.with_(dt=_CAST_METHODS[func.attr])

        # x.to(dtype) retags; x.to(device) / x.to(other) keeps the
        # operand (a placement move is a pass-through).
        if isinstance(func, ast.Attribute) and func.attr == "to":
            base = self._eval(func.value, env)
            dt = base.dt
            for a in call.args:
                self._eval(a, env)
                tag = _dtype_tag(a)
                if tag is not None:
                    dt = tag
                elif isinstance(a, ast.Attribute) and a.attr == "dtype":
                    dt = None
            for kw in call.keywords:
                self._eval(kw.value, env)
                if kw.arg == "dtype":
                    dt = _dtype_tag(kw.value)
            return base.with_(dt=dt)

        # Transparent shape/array ops.
        if dotted in _TRANSPARENT_CALLS and call.args:
            base = self._eval(call.args[0], env)
            for extra in call.args[1:]:
                self._eval(extra, env)
            dt = base.dt
            for kw in call.keywords:
                value = self._eval(kw.value, env)
                if kw.arg == "dtype":
                    dt = _dtype_tag(kw.value)
            return base.with_(dt=dt)
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _TRANSPARENT_METHODS
        ):
            base = self._eval(func.value, env)
            for a in call.args:
                self._eval(a, env)
            for kw in call.keywords:
                self._eval(kw.value, env)
            return base

        # zeros/ones builders.
        if dotted in _ZEROS_CHAINS:
            for a in call.args:
                self._eval(a, env)
            return AbstractValue(num="zero")
        if dotted in _ONES_CHAINS:
            for a in call.args:
                self._eval(a, env)
            return AbstractValue(num="one")

        # Full reductions — the TPU010 check sites.
        if isinstance(func, ast.Attribute) and func.attr in _REDUCER_NAMES:
            head = func.value
            head_dotted = dotted_name(head) or ""
            module_form = head_dotted in _REDUCER_MODULES
            if module_form:
                if not call.args:
                    return _TOP
                operand_node = call.args[0]
                operand = self._eval(operand_node, env)
                for extra in call.args[1:]:
                    self._eval(extra, env)
                for kw in call.keywords:
                    self._eval(kw.value, env)
                if not self._axis_exempts(call, method=False):
                    self._record_reduction(call, func.attr, operand_node, operand)
            else:
                operand_node = head
                operand = self._eval(head, env)
                for a in call.args:
                    self._eval(a, env)
                for kw in call.keywords:
                    self._eval(kw.value, env)
                if not self._axis_exempts(call, method=True):
                    self._record_reduction(call, func.attr, operand_node, operand)
            num = operand.num
            if num == "zero" and func.attr in ("any", "all"):
                num = "false"
            elif num not in ("zero",):
                num = "top"
            return AbstractValue(
                prov=operand.prov, num=num, dt=operand.dt, pure=operand.pure
            )

        # torch.bincount(idx, weights=w): the weights, when given, are
        # what the counts sum, so a masked weight makes the call clean.
        if dotted == "torch.bincount" and call.args:
            operand_node = call.args[0]
            operand = self._eval(operand_node, env)
            for extra in call.args[1:]:
                self._eval(extra, env)
            for kw in call.keywords:
                value = self._eval(kw.value, env)
                if kw.arg == "weights":
                    operand_node, operand = kw.value, value
            self._record_reduction(call, "bincount", operand_node, operand)
            return AbstractValue(
                prov=operand.prov, num=operand.num, dt=operand.dt,
                pure=operand.pure,
            )
        # Segment reductions / scatter-adds.
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _SEGMENT_REDUCERS
            and call.args
        ):
            operand_node = call.args[0]
            operand = self._eval(operand_node, env)
            for extra in call.args[1:]:
                self._eval(extra, env)
            for kw in call.keywords:
                self._eval(kw.value, env)
            self._record_reduction(call, func.attr, operand_node, operand)
            return AbstractValue(
                prov=operand.prov, num=operand.num, dt=operand.dt,
                pure=operand.pure,
            )
        # state.index_add_(dim, idx, v) / state.scatter_add_(dim, idx, v):
        # scatter-accumulate the third argument into the state.
        if isinstance(func, ast.Attribute) and func.attr in _SCATTER_METHODS:
            base = self._eval(func.value, env)
            source_node: Optional[ast.AST] = (
                call.args[2] if len(call.args) > 2 else None
            )
            for a in call.args[:2]:
                self._eval(a, env)
            for kw in call.keywords:
                if kw.arg in _SCATTER_SOURCE_KW:
                    source_node = kw.value
                elif kw.value is not source_node:
                    self._eval(kw.value, env)
            if source_node is None:
                return AbstractValue(prov=base.prov, pure=False)
            operand = self._eval(source_node, env)
            self._record_reduction(call, func.attr, source_node, operand)
            num = base.num if operand.num == "zero" else "top"
            return AbstractValue(
                prov=base.prov | operand.prov, num=num,
                pure=base.pure and operand.pure,
            )
        # _scatter.at_add(length, idx, v): the port's spelling of
        # zeros(length).at[idx].add(v).
        if (dotted.split(".")[-1] in _AT_ADD_NAMES) and len(call.args) >= 3:
            for a in call.args[:2]:
                self._eval(a, env)
            operand_node = call.args[2]
            operand = self._eval(operand_node, env)
            self._record_reduction(call, "at_add", operand_node, operand)
            return AbstractValue(
                prov=operand.prov, num=operand.num, pure=operand.pure
            )
        # x.at[idx].add(v) — scatter-accumulate into state.
        if (
            isinstance(func, ast.Attribute)
            and func.attr in ("add", "max", "min")
            and isinstance(func.value, ast.Subscript)
            and isinstance(func.value.value, ast.Attribute)
            and func.value.value.attr == "at"
            and call.args
        ):
            base = self._eval(func.value.value.value, env)
            self._eval(func.value.slice, env)
            operand_node = call.args[0]
            operand = self._eval(operand_node, env)
            self._record_reduction(call, f"at.{func.attr}", operand_node, operand)
            num = base.num if operand.num == "zero" else "top"
            return AbstractValue(
                prov=base.prov | operand.prov, num=num,
                pure=base.pure and operand.pure,
            )

        # A call to a function nested in this one: union the arguments
        # with the free names its body reads (closure capture).
        if isinstance(func, ast.Name) and func.id in self.nested:
            prov: frozenset = frozenset()
            for a in call.args:
                prov |= self._eval(a, env).prov
            for kw in call.keywords:
                prov |= self._eval(kw.value, env).prov
            nested = self.nested[func.id]
            for n in ast.walk(nested):
                if (
                    isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Load)
                    and (n.id in env or n.id in self.mask_names)
                ):
                    prov |= self._eval(
                        ast.copy_location(ast.Name(id=n.id, ctx=ast.Load()), n),
                        env,
                    ).prov
            return AbstractValue(prov=prov, pure=False)

        # Anything else: opaque.  Union the argument provenances (a
        # callee handed the mask is presumed to thread it) and drop
        # purity so RMW verdicts defer to the callee.
        prov = frozenset()
        pure = isinstance(func, ast.Name) and func.id in _PURE_BUILTINS
        for a in call.args:
            v = self._eval(a, env)
            prov |= v.prov
        for kw in call.keywords:
            v = self._eval(kw.value, env)
            prov |= v.prov
        if isinstance(func, (ast.Attribute, ast.Subscript, ast.Call)):
            v = self._eval(func, env)
            prov |= v.prov
        return AbstractValue(prov=prov, pure=pure)


def _dtype_tag(node: ast.AST) -> Optional[str]:
    """dtype tag of a dtype spelling (``torch.float32``, ``np.int32``,
    ``"float64"``), else None."""
    tag = _DTYPE_CHAINS.get(dotted_name(node) or "")
    if tag is None and isinstance(node, ast.Constant) and isinstance(
        node.value, str
    ):
        tag = _DTYPE_STRINGS.get(node.value)
    return tag


def analyze_mask_dataflow(func: ast.AST) -> Optional[DataflowSummary]:
    """Run the mask-present abstract walk over ``func``; None when the
    function is not mask-accepting (no mask to drop → no discipline to
    check)."""
    names = mask_param_names(func) | kwargs_mask_locals(func)
    if not names:
        return None
    return _MaskInterp(func, names).run()


_DATAFLOW_CACHE: List[Tuple[Module, List[DataflowSummary]]] = []


def module_dataflow(mod: Module) -> List[DataflowSummary]:
    """Dataflow summaries for every mask-accepting function in ``mod``,
    memoized per module object so the three dataflow rules share one
    walk.  The cache entry holds the Module itself (not its id): a
    strong reference pins the object, so identity cannot be recycled
    onto a different module between rule runs."""
    for k, cached in _DATAFLOW_CACHE:
        if k is mod:
            return cached
    out: List[DataflowSummary] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, _FuncDefT):
            summary = analyze_mask_dataflow(node)
            if summary is not None:
                out.append(summary)
    _DATAFLOW_CACHE.append((mod, out))
    # Enough for a whole run: each rule walks every module before the
    # next one starts, so a smaller cache would never hit.
    del _DATAFLOW_CACHE[:-1024]
    return out


# Float64-widening spellings (TPU012's other prong): literal float64
# casts or dtype arguments inside traced regions.
_F64_CHAINS = frozenset(
    {
        "np.float64", "numpy.float64", "torch.float64", "torch.double",
    }
)


def find_float64_widening(func: ast.AST) -> List[Tuple[ast.AST, str]]:
    """(node, spelled) for every literal float64 widening in ``func``:
    ``np.float64(x)`` calls, ``x.double()``, ``.to(torch.float64)`` /
    ``.astype(float64)``, and ``dtype=torch.float64`` keywords (dotted or
    string spelling)."""
    out: List[Tuple[ast.AST, str]] = []

    def is_f64(node: ast.AST) -> Optional[str]:
        spelled = dotted_name(node)
        if spelled in _F64_CHAINS:
            return spelled
        if isinstance(node, ast.Constant) and node.value in (
            "float64",
            "double",
        ):
            return repr(node.value)
        return None

    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        spelled = dotted_name(node.func)
        if spelled in _F64_CHAINS:
            out.append((node, spelled))
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "double"
            and not node.args
            and not node.keywords
        ):
            out.append((node, "double()"))
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("astype", "to")
            and node.args
        ):
            hit = next(filter(None, (is_f64(a) for a in node.args)), None)
            if hit:
                out.append((node, f"{node.func.attr}({hit})"))
                continue
        for kw in node.keywords:
            if kw.arg == "dtype":
                hit = is_f64(kw.value)
                if hit:
                    out.append((node, f"dtype={hit}"))
    return out
