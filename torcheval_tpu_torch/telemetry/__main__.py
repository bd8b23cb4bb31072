"""``python -m torcheval_tpu_torch.telemetry <report.jsonl>``: replay a
saved JSON-lines telemetry dump offline (the port of
``torcheval_tpu/telemetry/__main__.py``; a dump of either package reads).

Default output is the human-readable health summary
(:func:`torcheval_tpu_torch.telemetry.report` text); ``--prometheus``
prints the text-format counter snapshot instead, ``--perfetto out.json``
writes a Chrome/Perfetto trace, ``--trace <trace_id>`` renders the span
tree(s) holding that trace id (exit 1 when the id is not in the dump),
``--flight <bundle_dir>`` validates and renders a flight-recorder bundle
(no report path needed; exit 2 on a corrupt bundle), ``--alerts`` renders
the fired SLO rules of a dump and exits 1 when any fired, and ``--routes``
renders the routing decision table of a dump.  ``--perf`` (perfscope) and
``--tenants`` (serve metering) read modules the port does not have yet and
raise ``NotImplementedError``.  Unknown event kinds are skipped with a
counted warning (``export.read_jsonl``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torcheval_tpu_torch.telemetry",
        description="Pretty-print a saved telemetry JSONL report.",
    )
    parser.add_argument(
        "report",
        nargs="?",
        default=None,
        help="path to a JSON-lines dump from telemetry.export_jsonl "
        "(optional with --flight)",
    )
    parser.add_argument(
        "--prometheus",
        action="store_true",
        help="print the Prometheus text-format snapshot instead",
    )
    parser.add_argument(
        "--perfetto",
        metavar="OUT.json",
        help="write a Chrome/Perfetto trace-event JSON file instead",
    )
    parser.add_argument(
        "--perf",
        action="store_true",
        help="print the perfscope per-route roofline table instead",
    )
    parser.add_argument(
        "--alerts",
        action="store_true",
        help="render fired SLO alert rules; exit 1 when any fired "
        "(for CI consumption)",
    )
    parser.add_argument(
        "--routes",
        action="store_true",
        help="render the measured-cost routing decision table "
        "(route, measured cost, verdict, source) from the dump",
    )
    parser.add_argument(
        "--tenants",
        action="store_true",
        help="render the per-tenant serve metering table (device-time "
        "attribution, shed rate, latency quantiles) from the dump",
    )
    parser.add_argument(
        "--trace",
        metavar="TRACE_ID",
        help="render the causal span tree(s) containing this trace id; "
        "exit 1 when the id does not appear in the dump",
    )
    parser.add_argument(
        "--flight",
        metavar="BUNDLE_DIR",
        help="validate and render a flight-recorder bundle directory; "
        "exit 2 when the bundle is missing or corrupt",
    )
    args = parser.parse_args(argv)

    if args.flight:
        from torcheval_tpu_torch.telemetry import flightrec

        problems = flightrec.validate_bundle(args.flight)
        if problems:
            print(
                f"corrupt flight-recorder bundle {args.flight!r}:",
                file=sys.stderr,
            )
            for problem in problems:
                print(f"  - {problem}", file=sys.stderr)
            return 2
        sys.stdout.write(flightrec.format_bundle(flightrec.read_bundle(args.flight)))
        return 0

    if args.report is None:
        parser.error("a report path is required (except with --flight)")

    from torcheval_tpu_torch.telemetry import events as ev
    from torcheval_tpu_torch.telemetry import export

    try:
        loaded = export.read_jsonl(args.report)
    except OSError as exc:
        print(
            f"error: cannot read report {args.report!r}: {exc}",
            file=sys.stderr,
        )
        return 2

    if args.trace:
        from torcheval_tpu_torch.telemetry import trace as trace_mod

        roots = trace_mod.build_forest(
            [export.event_to_dict(e) for e in loaded]
        )
        selected = trace_mod.select_trace(roots, args.trace)
        if not selected:
            print(
                f"trace {args.trace!r} not found in {args.report!r} "
                f"({len(roots)} trace tree(s) in dump)",
                file=sys.stderr,
            )
            return 1
        print(trace_mod.format_forest(selected))
        return 0

    # Replay into a private bus sized to hold everything: re-emitting
    # rebuilds the exact aggregates (they are pure folds of the events),
    # and the saved time/callsite/thread stamps are non-defaults so
    # emit() preserves them.
    ev.clear()
    if loaded and ev.capacity() < len(loaded):
        ev.enable(capacity=len(loaded))
    for event in loaded:
        ev.emit(event)

    if args.routes:
        decisions = ev.aggregates()["route_decisions"]
        if not decisions:
            print("no route decisions recorded")
            return 0
        print(f"{len(decisions)} route decision row(s):")
        header = (
            f"  {'decision':<14} {'route':<10} {'verdict':<11} "
            f"{'signature':<17} {'count':>5} {'cost_ms':>10} "
            f"{'alt_ms':>10}  source"
        )
        print(header)
        for (decision, route, verdict) in sorted(decisions):
            entry = decisions[(decision, route, verdict)]
            cost = (
                f"{entry['seconds'] * 1e3:.4f}"
                if verdict == "measured"
                else "-"
            )
            alt = (
                f"{entry['alt_seconds'] * 1e3:.4f}"
                if verdict == "measured"
                else "-"
            )
            print(
                f"  {decision:<14} {route:<10} {verdict:<11} "
                f"{entry['signature'] or '-':<17} {entry['count']:>5} "
                f"{cost:>10} {alt:>10}  {entry['source']}"
            )
        return 0

    if args.tenants:
        raise NotImplementedError(
            "--tenants renders telemetry/tenants.py's metering table, which comes "
            "with the serve layer (ROADMAP queue 1 item 8)."
        )

    if args.alerts:
        alerts = ev.aggregates()["alerts"]
        if not alerts:
            print("no alerts fired")
            return 0
        total = sum(entry["count"] for entry in alerts.values())
        print(f"{total} alert(s) fired across {len(alerts)} rule(s):")
        for rule, entry in sorted(alerts.items()):
            print(
                f"  {rule}: {entry['count']}x "
                f"(last value {entry['value']:.4g} vs threshold "
                f"{entry['threshold']:.4g}) — {entry['message']}"
            )
        return 1
    if args.perfetto:
        trace = export.to_perfetto(loaded)
        with open(args.perfetto, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        print(
            f"wrote {len(trace['traceEvents'])} trace events "
            f"({len(loaded)} telemetry events) to {args.perfetto}"
        )
    elif args.prometheus:
        sys.stdout.write(export.prometheus_text())
    elif args.perf:
        raise NotImplementedError(
            "--perf renders telemetry/perfscope.py's explain_perf, which the port does "
            "not have yet (ROADMAP queue 1 item 4)."
        )
    else:
        import torcheval_tpu_torch.telemetry as telemetry

        sys.stdout.write(telemetry.report(as_text=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
