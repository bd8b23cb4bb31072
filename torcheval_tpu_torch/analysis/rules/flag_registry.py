"""TPU013 flag-registry: every ``TORCHEVAL_TPU_*`` environment variable
is read through :mod:`torcheval_tpu_torch._flags`, nowhere else.

Scattered ``os.environ.get("TORCHEVAL_TPU_TORCH_...")`` reads each
reinvent truthiness parsing, skip validation, are invisible to the
registry's ``snapshot_non_default()`` and drift out of the docs.  The
typed registry declares each flag once — kind, default, validation
policy — and every consumer calls ``_flags.get(name)`` (writers go
through ``_flags.overridden(name, raw)``).

The rule flags any environment read or write whose key expression
carries the ``TORCHEVAL_TPU_`` prefix — the port's own
``TORCHEVAL_TPU_TORCH_*`` flags and the JAX package's flags alike, which
the port must never read — in any of the spellings:

* ``os.environ.get(...)`` / ``os.environ.pop(...)`` / ``os.getenv(...)``
* ``os.environ["..."]`` subscripts (read or write)
* ``"..." in os.environ`` membership tests

Prefix detection walks the key expression, so concatenations like
``"TORCHEVAL_TPU_TORCH_" + name`` and f-strings with the prefix fire
too, as does a key built from the registry's own constant
(``_flags.PREFIX + "CM_ROW_CHUNK"``).  The registry module itself
(``torcheval_tpu_torch/_flags.py``) is exempt — it is the one
sanctioned reader.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .._core import (
    Finding,
    Module,
    Rule,
    dotted_name,
    register,
    scope_qualname,
)

PREFIX = "TORCHEVAL_TPU_"

_ENV_GET_CHAINS = {
    "os.environ.get",
    "os.environ.pop",
    "os.environ.setdefault",
    "environ.get",
    "environ.pop",
    "os.getenv",
    "getenv",
}
_ENV_CHAINS = {"os.environ", "environ"}

#: Module paths allowed to read the environment directly: the registry.
EXEMPT_SUFFIXES = ("torcheval_tpu_torch/_flags.py",)

#: The registry's prefix constant: ``<anything>.PREFIX`` (or a bare
#: ``PREFIX``) in a key expression stands for the port's flag prefix.
_PREFIX_CONSTANT = "PREFIX"
_PORT_PREFIX = "TORCHEVAL_TPU_TORCH_"


def _prefixed_literal(node: ast.AST) -> Optional[str]:
    """The flag name a key expression spells: the first string literal
    under ``node`` carrying the prefix, or the registry's ``PREFIX``
    constant joined to the literal beside it."""
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Constant)
            and isinstance(sub.value, str)
            and sub.value.startswith(PREFIX)
        ):
            return sub.value
    for sub in ast.walk(node):
        dn = dotted_name(sub)
        if dn is not None and dn.split(".")[-1] == _PREFIX_CONSTANT:
            rest = next(
                (
                    c.value
                    for c in ast.walk(node)
                    if isinstance(c, ast.Constant) and isinstance(c.value, str)
                ),
                "",
            )
            return _PORT_PREFIX + rest
    return None


def _env_read_key(node: ast.AST) -> Optional[ast.AST]:
    """The key expression if ``node`` is an environment read/write."""
    if isinstance(node, ast.Call):
        if dotted_name(node.func) in _ENV_GET_CHAINS and node.args:
            return node.args[0]
        return None
    if isinstance(node, ast.Subscript):
        if dotted_name(node.value) in _ENV_CHAINS:
            return node.slice
        return None
    if (
        isinstance(node, ast.Compare)
        and len(node.ops) == 1
        and isinstance(node.ops[0], (ast.In, ast.NotIn))
        and dotted_name(node.comparators[0]) in _ENV_CHAINS
    ):
        return node.left
    return None


class FlagRegistryRule(Rule):
    code = "TPU013"
    name = "flag-registry"
    summary = (
        "TORCHEVAL_TPU_* environment variables are read only through "
        "the typed registry in torcheval_tpu_torch._flags"
    )

    def check_module(self, mod: Module) -> List[Finding]:
        path = mod.path.replace("\\", "/")
        if any(path.endswith(suffix) for suffix in EXEMPT_SUFFIXES):
            return []
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            key = _env_read_key(node)
            if key is None:
                continue
            literal = _prefixed_literal(key)
            if literal is None:
                continue
            findings.append(
                Finding(
                    code=self.code,
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"direct environment read of {literal} bypasses "
                        f"the typed flag registry; declare the flag in "
                        f"torcheval_tpu_torch._flags and call "
                        f"_flags.get(...) so parsing, validation, and "
                        f"snapshot coverage stay centralized"
                    ),
                    scope=scope_qualname(node),
                    symbol=literal,
                )
            )
        return findings


register(FlagRegistryRule())
