"""``# tpulint: disable=CODE`` suppression comments.

A suppression on a line silences findings reported on that line or the
line directly below it (so a comment can sit above a long statement):

    _health.inspect(stats)  # tpulint: disable=TPU001 -- guarded by build flag

    # tpulint: disable=TPU003,TPU005 -- closed-form test fixture
    value = float(x)

``disable=all`` (or ``*``) silences every rule.  Text after ``--`` is a
free-form justification; tpulint ignores it but reviewers should not.

Comments are found with ``tokenize`` so string literals containing the
marker never register.
"""

from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, Set

_PATTERN = re.compile(
    r"#\s*tpulint:\s*disable=([A-Za-z0-9*,\s]+?)(?:\s*--.*)?$"
)


def parse_codes(comment: str) -> Set[str]:
    m = _PATTERN.search(comment)
    if not m:
        return set()
    codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return {"*"} if ("all" in codes or "*" in codes) else codes


def collect_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map line number -> set of suppressed codes for one file."""
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                codes = parse_codes(tok.string)
                if codes:
                    out.setdefault(tok.start[0], set()).update(codes)
    except tokenize.TokenizeError:  # pragma: no cover - parse rejects first
        pass
    return out
