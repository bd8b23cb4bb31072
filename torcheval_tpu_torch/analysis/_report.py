"""tpulint reporters: human text, machine JSON, and SARIF 2.1.0.

All consume the same post-baseline split so the CLI's exit code, the
text summary, and the machine payloads can never disagree about what
counts as *new*.  The SARIF reporter emits grandfathered findings with
an ``external`` suppression so code-scanning UIs show them as reviewed
rather than re-raising them on every push.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, TextIO

from ._core import Finding


def render_text(
    new: Sequence[Finding],
    grandfathered: Sequence[Finding],
    stale: Sequence[str],
    files_checked: int,
    out: TextIO,
) -> None:
    for f in new:
        out.write(f.render() + "\n")
    if new:
        out.write("\n")
    counts: Dict[str, int] = {}
    for f in new:
        counts[f.code] = counts.get(f.code, 0) + 1
    summary = ", ".join(f"{c} {n}" for c, n in sorted(counts.items()))
    out.write(
        f"tpulint: {len(new)} new finding(s)"
        + (f" ({summary})" if summary else "")
        + f" in {files_checked} file(s)"
    )
    if grandfathered:
        out.write(f"; {len(grandfathered)} baselined")
    if stale:
        out.write(f"; {len(stale)} stale baseline entrie(s)")
    out.write("\n")
    for fp in stale:
        out.write(f"  stale (fixed? prune from baseline): {fp}\n")


def render_json(
    new: Sequence[Finding],
    grandfathered: Sequence[Finding],
    stale: Sequence[str],
    files_checked: int,
    out: TextIO,
) -> None:
    payload = {
        "version": 1,
        "files_checked": files_checked,
        "new": [f.as_dict() for f in new],
        "grandfathered": [f.as_dict() for f in grandfathered],
        "stale_baseline": list(stale),
        "summary": _summary(new),
    }
    json.dump(payload, out, indent=2, sort_keys=True)
    out.write("\n")


def _summary(new: Sequence[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in new:
        counts[f.code] = counts.get(f.code, 0) + 1
    counts["total"] = len(new)
    return counts


def _sarif_result(f: Finding, suppressed: bool) -> Dict[str, object]:
    result: Dict[str, object] = {
        "ruleId": f.code,
        "level": "warning",
        "message": {"text": f.message},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.as_dict()["path"],
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(f.line, 1)},
                }
            }
        ],
        "partialFingerprints": {"tpulint/v1": f.fingerprint},
    }
    if suppressed:
        result["suppressions"] = [
            {
                "kind": "external",
                "justification": "grandfathered in tpulint.baseline",
            }
        ]
    return result


def render_sarif(
    new: Sequence[Finding],
    grandfathered: Sequence[Finding],
    rules: Sequence,
    out: TextIO,
) -> None:
    """SARIF 2.1.0 for GitHub code scanning (``--sarif``).  One run, one
    driver; rule metadata comes from the live registry so ``--select``
    subsets stay self-describing."""
    payload = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "tpulint",
                        "rules": [
                            {
                                "id": r.code,
                                "name": r.name,
                                "shortDescription": {"text": r.summary},
                            }
                            for r in rules
                        ],
                    }
                },
                "results": (
                    [_sarif_result(f, False) for f in new]
                    + [_sarif_result(f, True) for f in grandfathered]
                ),
            }
        ],
    }
    json.dump(payload, out, indent=2, sort_keys=True)
    out.write("\n")


def render_rule_table(rules: List, out: TextIO) -> None:
    width = max((len(r.code) for r in rules), default=6)
    for r in rules:
        out.write(f"{r.code:<{width}}  {r.name}: {r.summary}\n")
