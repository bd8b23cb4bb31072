"""tpulint for the PyTorch port — the JAX package's static analyzer
re-derived for torch, with JAX's rule codes, suppression syntax and
fingerprint format.

Proves the port's contract families at parse time, before any card
sees the code:

- **hot-path**: every telemetry/health/faults/perfscope/trace/
  flight-recorder/quality/metering/autotune hook call is dominated by
  its ``ENABLED`` branch (TPU001);
- **layering**: module-level imports respect the layer DAG and stay
  acyclic, and nothing in the port imports jax or the JAX package
  (TPU002);
- **capture-safety**: no host reads (TPU003) and no wall-clock/RNG
  constants (TPU005) in code reachable from a CUDA-graph capture.
  TPU004 (donation-safety) is out of scope: torch never deletes a
  tensor handed to a call (``rules/donation.py`` says more);
- **concurrency**: inferred lock-guard discipline (TPU006), lock-order
  and blocking-while-holding deadlock potential (TPU007), thread
  lifecycle (TPU008), and check-then-act races (TPU009), built on an
  interprocedural call graph with thread-entry reachability and
  held-lock propagation (see ``_core``);
- **dataflow**: an intraprocedural abstract interpreter over
  mask-accepting update paths proves mask discipline on reductions
  (TPU010), pad-neutrality of state writes under the all-masked
  abstraction (TPU011), and dtype stability (TPU012); plus the
  typed-flag-registry boundary — every ``TORCHEVAL_TPU_*`` env read
  goes through ``torcheval_tpu_torch._flags`` (TPU013).

Run it::

    python -m torcheval_tpu_torch.analysis [paths] [--json | --sarif]
        [--baseline FILE] [--select CODES] [--ignore CODES]

or without importing torch, by loading this directory by path under a
synthetic package name (``chip_smoke.py`` does so on the GPU host).
Exit codes: 0 clean, 1 new findings, 2 unreadable path argument or
unknown rule code.

This subpackage is stdlib-only and uses relative imports exclusively —
it must run where neither jax nor torch is importable and must never
import the code it analyzes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

from ._baseline import load_baseline, split_by_baseline, write_baseline
from ._config import (
    BASELINE_PATH,
    DEFAULT_EXCLUDES,
    DEFAULT_TARGETS,
    REPO_ROOT,
    Config,
)
from ._core import (
    AnalysisResult,
    Finding,
    Module,
    all_rules,
    analyze_files,
    iter_python_files,
    module_name_for,
)
from ._report import (
    render_json,
    render_rule_table,
    render_sarif,
    render_text,
)
from .rules.donation import OUT_OF_SCOPE
from .rules.hook_guard import discover_hook_sites

__all__ = [
    "Finding",
    "AnalysisResult",
    "analyze",
    "hook_entry_points",
    "hook_site_map",
    "main",
]


def _display_path(path: str) -> str:
    """Repo-relative display path (fingerprints must not depend on CWD
    or on how the target argument was spelled)."""
    ap = os.path.abspath(path)
    root = REPO_ROOT + os.sep
    if ap.startswith(root):
        return os.path.relpath(ap, REPO_ROOT).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def _expand(
    paths: Sequence[str], excludes: Sequence[str]
) -> Tuple[List[Tuple[str, str]], List[str]]:
    files, missing = iter_python_files(paths, excludes, root=REPO_ROOT)
    return [(f, _display_path(f)) for f in files], missing


def analyze(
    paths: Optional[Sequence[str]] = None,
    excludes: Optional[Sequence[str]] = None,
) -> AnalysisResult:
    """Programmatic entry point: analyze ``paths`` (default: the repo's
    configured targets) and return the raw result, pre-baseline."""
    cfg = Config.with_defaults()
    entries, _ = _expand(
        list(paths) if paths else cfg.paths,
        list(excludes) if excludes is not None else cfg.excludes,
    )
    return analyze_files(entries)


def _load_modules(
    paths: Sequence[str], excludes: Sequence[str]
) -> List[Module]:
    entries, _ = _expand(paths, excludes)
    mods: List[Module] = []
    for open_path, disp in entries:
        try:
            mods.append(
                Module.load(
                    open_path,
                    module_name_for(disp, ("torcheval_tpu_torch",)),
                    display=disp,
                )
            )
        except (SyntaxError, UnicodeDecodeError):
            continue
    return mods


def hook_site_map(
    paths: Optional[Sequence[str]] = None,
) -> Dict[str, List[str]]:
    """Statically discovered hook call sites keyed by runtime-namespace
    hook name (``record_sync``, ``health.inspect``, ...), each mapping
    to its ``path:line`` list.  Default scope: the port's package only
    — the set ``chip_smoke.py``'s hook-map phase covers with counting
    wrappers."""
    target = list(paths) if paths else [
        os.path.join(REPO_ROOT, "torcheval_tpu_torch")
    ]
    return discover_hook_sites(
        _load_modules(target, list(DEFAULT_EXCLUDES))
    )


def hook_entry_points(
    paths: Optional[Sequence[str]] = None,
) -> List[str]:
    """Sorted runtime-namespace hook names with at least one call site
    in the tree — the coverage floor for the overhead harness."""
    return sorted(hook_site_map(paths))


_EPILOG = """\
exit codes:
  0  clean (no findings beyond the baseline)
  1  new findings
  2  an argument path does not exist or is not analyzable source, or an
     unknown rule code (TPU004 is out of scope in the port)

scoped-out files (config, see torcheval_tpu_torch/analysis/_config.py):
  _chip_archive/ (other checkouts unpacked for A/B runs) is excluded
  from directory walks.  tests/ is not a default target (tests call hook entry points
  directly with the bus enabled on purpose); lint it by passing tests/
  explicitly.

suppressions:
  # tpulint: disable=TPU001 -- one-line justification
  on the finding's line or the line above silences that code there.
  Grandfathered findings live in torcheval_tpu_torch/analysis/
  tpulint.baseline (fingerprints are line-independent);
  --write-baseline regenerates it.
"""


def main(
    argv: Optional[Sequence[str]] = None,
    stdout: Optional[TextIO] = None,
    stderr: Optional[TextIO] = None,
) -> int:
    out = stdout if stdout is not None else sys.stdout
    err = stderr if stderr is not None else sys.stderr
    parser = argparse.ArgumentParser(
        prog="tpulint",
        description=(
            "Static analysis for the torcheval_tpu_torch contracts: hook "
            "guards (TPU001), layer order and the no-JAX boundary "
            "(TPU002), host reads in CUDA-graph captures (TPU003), "
            "capture determinism "
            "(TPU005), lock discipline (TPU006), lock order (TPU007), "
            "thread lifecycle (TPU008), check-then-act (TPU009), mask "
            "discipline (TPU010), pad-neutrality (TPU011), dtype "
            "stability (TPU012), flag registry (TPU013)."
        ),
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=(
            "files or directories to analyze (default: "
            + ", ".join(DEFAULT_TARGETS)
            + " under the repo root)"
        ),
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    parser.add_argument(
        "--sarif",
        action="store_true",
        help=(
            "SARIF 2.1.0 output for code-scanning upload (grandfathered "
            "findings carry an external suppression)"
        ),
    )
    parser.add_argument(
        "--select",
        metavar="CODES",
        default=None,
        help=(
            "comma-separated rule codes to run exclusively "
            "(e.g. TPU006,TPU007); unknown codes are an error"
        ),
    )
    parser.add_argument(
        "--ignore",
        metavar="CODES",
        default=None,
        help="comma-separated rule codes to skip (applied after --select)",
    )
    parser.add_argument(
        "--baseline",
        metavar="FILE",
        default=None,
        help=(
            "baseline file of grandfathered fingerprints (default: "
            "torcheval_tpu_torch/analysis/tpulint.baseline when present; "
            "pass an empty string to ignore it)"
        ),
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help=(
            "rewrite the baseline file with every current finding and "
            "exit 0 (then edit in the justifications)"
        ),
    )
    parser.add_argument(
        "--hook-sites",
        action="store_true",
        help=(
            "print the discovered hook-site map (runtime hook name -> "
            "call sites) as JSON and exit"
        ),
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        render_rule_table(all_rules(), out)
        code, name, why = OUT_OF_SCOPE
        out.write(f"{code}  {name}: ({why})\n")
        return 0

    if args.json and args.sarif:
        err.write("tpulint: --json and --sarif are mutually exclusive\n")
        return 2

    rule_codes: Optional[set] = None
    if args.select is not None or args.ignore is not None:
        known = {r.code for r in all_rules()}
        selected = set(known)
        for flag, raw in (("--select", args.select), ("--ignore", args.ignore)):
            if raw is None:
                continue
            codes = {c.strip().upper() for c in raw.split(",") if c.strip()}
            unknown = codes - known
            if unknown:
                err.write(
                    f"tpulint: unknown rule code(s) for {flag}: "
                    + ", ".join(sorted(unknown))
                    + " (see --list-rules)\n"
                )
                return 2
            if flag == "--select":
                selected = codes
            else:
                selected -= codes
        rule_codes = selected

    cfg = Config.with_defaults()
    paths = list(args.paths) if args.paths else cfg.paths
    if args.baseline is None:
        baseline_path = cfg.baseline
    elif args.baseline == "":
        baseline_path = ""
    else:
        baseline_path = args.baseline

    if args.hook_sites:
        import json as _json

        scope = list(args.paths) if args.paths else None
        _json.dump(hook_site_map(scope), out, indent=2)
        out.write("\n")
        return 0

    entries, missing = _expand(paths, cfg.excludes)
    if missing:
        for m in missing:
            err.write(f"tpulint: cannot read {m}\n")
        return 2

    result = analyze_files(entries, rule_codes=rule_codes)
    baseline = load_baseline(baseline_path) if baseline_path else {}
    new, grandfathered, stale = split_by_baseline(
        result.all_findings, baseline
    )

    if args.write_baseline:
        target = baseline_path or BASELINE_PATH
        write_baseline(target, result.all_findings, baseline)
        err.write(
            f"tpulint: wrote {len(result.all_findings)} fingerprint(s) "
            f"to {target}\n"
        )
        return 0

    if args.sarif:
        rules = [
            r
            for r in all_rules()
            if rule_codes is None or r.code in rule_codes
        ]
        render_sarif(new, grandfathered, rules, out)
    elif args.json:
        render_json(new, grandfathered, stale, len(result.files), out)
    else:
        render_text(new, grandfathered, stale, len(result.files), out)
    return 1 if new else 0
