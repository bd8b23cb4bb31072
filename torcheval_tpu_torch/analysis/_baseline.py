"""Checked-in baseline of grandfathered findings.

Format — one fingerprint per line, ``#`` comments carry the mandatory
one-line justification::

    # tpulint baseline
    TPU001:torcheval_tpu_torch/metrics/collection.py:MetricCollection.fused_update:health.inspect  # gated by health_stats, non-None only under _health.ENABLED

Fingerprints are line-independent (``code:path:scope:symbol[#n]``), so
the baseline survives unrelated edits.  A baselined finding that stops
firing is *stale*; the CLI reports stale entries so the file shrinks
instead of rotting (stale entries never fail the run — deleting code
that fixes a finding must not break CI).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple

from ._core import Finding


def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> justification (empty string when none given)."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "#" in line:
                fp, _, just = line.partition("#")
                out[fp.strip()] = just.strip()
            else:
                out[line] = ""
    return out


def write_baseline(
    path: str,
    findings: Iterable[Finding],
    existing: Dict[str, str] = None,
) -> None:
    """Rewrite the baseline; justifications already recorded in
    ``existing`` survive the regeneration."""
    existing = existing or {}
    lines = [
        "# tpulint baseline — grandfathered findings.",
        "# One fingerprint per line; add a one-line justification after `#`.",
        "# Regenerate with: python -m torcheval_tpu_torch.analysis --write-baseline",
        "",
    ]
    for f in sorted(findings, key=lambda f: f.fingerprint):
        just = existing.get(f.fingerprint) or f"TODO: justify ({f.message})"
        lines.append(f"{f.fingerprint}  # {just}")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def split_by_baseline(
    findings: List[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[Finding], Set[str]]:
    """(new, grandfathered, stale_fingerprints)."""
    new: List[Finding] = []
    old: List[Finding] = []
    seen: Set[str] = set()
    for f in findings:
        if f.fingerprint in baseline:
            old.append(f)
            seen.add(f.fingerprint)
        else:
            new.append(f)
    stale = set(baseline) - seen
    return new, old, stale
