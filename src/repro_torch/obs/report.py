"""Markdown run reports over a grid telemetry trace (stdlib-only).

Renders one traced run — JSONL export or in-memory Tracer — as a
human-readable report: the per-phase critical-path table from
``obs/analyze.py``, straggler attribution, the tier wire ledger
(re-summed from the ``tier_upload`` billing instants the ``CommReport``
emitted, so it IS the ledger), the epsilon curve with burn rates, and
fault/quarantine/shock/checkpoint counts. With ``--metrics`` (a
``MetricsRegistry.snapshot()`` JSON) the report cross-checks the trace
against the registry's counters.

CLI (the CI ``telemetry`` job uploads the output as an artifact):

    python -m repro_torch.obs.report run.jsonl --metrics snap.json -o report.md
"""
from __future__ import annotations

import json
from typing import Any, Iterable, List, Optional, Union

from repro_torch.obs import analyze as analyze_lib

_MB = 1024 * 1024


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(headers: List[str], rows: List[List[Any]]) -> List[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "---|" * len(headers)]
    for r in rows:
        out.append("| " + " | ".join(_fmt(c) for c in r) + " |")
    out.append("")
    return out


def _counter(snap: Optional[dict], name: str) -> Optional[float]:
    if not snap:
        return None
    c = snap.get("counters", {}).get(name)
    return None if c is None else c.get("value")


def build_report(source: Union[str, Iterable],
                 metrics: Optional[dict] = None,
                 title: str = "Grid run report",
                 max_rows: int = 20) -> str:
    """The full markdown report for one trace source (JSONL path,
    Tracer, or record iterable). ``metrics`` is an optional decoded
    ``MetricsRegistry.snapshot()`` dict for cross-checks."""
    a = analyze_lib.analyze(source)
    lines: List[str] = [f"# {title}", ""]
    n_events = sum(a.counts["kinds"].values())
    unit = "rounds" if a.mode == "sync" else "flushes"
    lines += [f"- mode: **{a.mode}** · {len(a.breakdowns)} {unit} · "
              f"{n_events} trace events",
              f"- virtual wall time: **{a.virtual_seconds:.4g} s**", ""]

    # --- critical path ---------------------------------------------------
    wall = sum(b.span for b in a.breakdowns)
    lines += ["## Critical path", ""]
    if wall > 0:
        rows = [[k, f"{v:.4g}", f"{100.0 * v / wall:.1f}%"]
                for k, v in a.phase_totals.items()]
        lines += _table(["phase", "virtual s", "% of wall"], rows)
        ident = all(b.check_identity(1e-6) for b in a.breakdowns)
        lines += [f"- phase identity (phases sum to each {unit[:-2]}'s "
                  f"span): **{'holds' if ident else 'VIOLATED'}**", ""]
    else:
        lines += ["(no rounds/flushes in the trace)", ""]
    if a.breakdowns:
        shown = a.breakdowns[:max_rows]
        rows = []
        for b in shown:
            who = "—"
            if b.bounded_by is not None:
                who = f"cid {b.bounded_by['cid']}"
                if b.bounded_by.get("tier") is not None:
                    who += f" / tier {b.bounded_by['tier']}"
                if b.bounded_by.get("region") is not None:
                    who += f" / region {b.bounded_by['region']}"
            rows.append([b.index, f"{b.start:.4g}", f"{b.span:.4g}",
                         f"{b.phases['downlink']:.4g}",
                         f"{b.phases['compute']:.4g}",
                         f"{b.phases['uplink']:.4g}",
                         f"{b.phases['retry']:.4g}",
                         f"{b.phases['wait']:.4g}", who])
        lines += _table(["#", "start", "span", "down", "compute", "up",
                         "retry", "wait", "bounded by"], rows)
        if len(a.breakdowns) > max_rows:
            lines += [f"({len(a.breakdowns) - max_rows} more {unit} "
                      "not shown)", ""]

    # --- stragglers ------------------------------------------------------
    lines += ["## Straggler attribution", ""]
    any_strag = False
    for key, label in (("by_cid", "cid"), ("by_tier", "tier"),
                       ("by_region", "region")):
        slots = a.stragglers.get(key, {})
        if not slots:
            continue
        any_strag = True
        top = sorted(slots.items(), key=lambda kv: -kv[1]["seconds"])
        rows = [[k, v["count"], f"{v['seconds']:.4g}"]
                for k, v in top[:10]]
        lines += [f"**Bounded {unit} by {label}:**", ""]
        lines += _table([label, unit + " bounded", "virtual s"], rows)
    if a.stragglers.get("unattributed"):
        lines += [f"- {a.stragglers['unattributed']} {unit} unattributed "
                  "(deadline-bound, dark-window, or pre-v4 trace)", ""]
    if not any_strag and not a.stragglers.get("unattributed"):
        lines += ["(nothing bounded the clock — empty trace?)", ""]

    # --- wire ledger -----------------------------------------------------
    if a.wire:
        lines += ["## Wire ledger (per tier, from tier_upload billing)",
                  ""]
        rows = [[name, f"{rec['down_bytes'] / _MB:.3f}",
                 f"{rec['up_bytes'] / _MB:.3f}", rec["transfers"],
                 rec["uploads"]]
                for name, rec in sorted(a.wire.items())]
        lines += _table(["tier", "down MB", "up MB", "transfers",
                         "uploads"], rows)

    # --- metrics cross-check --------------------------------------------
    if metrics is not None:
        lines += ["## Metrics cross-check", ""]
        rows = []
        trace_uploads = a.counts["kinds"].get("upload", 0) \
            + a.counts["faults"].get("duplicate_upload", 0)
        reg_uploads = _counter(metrics, "uploads")
        if reg_uploads is not None:
            ok = "OK" if trace_uploads <= reg_uploads else "MISMATCH"
            rows.append(["uploads (trace incl. duplicates vs registry)",
                         trace_uploads, int(reg_uploads), ok])
        for kind, cname in (("dispatch", "dispatches"),
                            ("retry", "retries"),
                            ("quarantine", "quarantined"),
                            ("checkpoint", "checkpoints")):
            reg = _counter(metrics, cname)
            if reg is None:
                continue
            tr = a.counts["kinds"].get(kind, 0)
            rows.append([cname, tr, int(reg),
                         "OK" if tr == int(reg) else "MISMATCH"])
        if rows:
            lines += _table(["quantity", "trace", "registry", "check"],
                            rows)
        else:
            lines += ["(no comparable counters in the snapshot)", ""]

    # --- privacy ---------------------------------------------------------
    if a.privacy:
        lines += ["## Privacy budget", ""]
        rows = [[p["flush"], f"{p['t']:.4g}", f"{p['epsilon']:.4g}",
                 f"{p['burn_rate']:.4g}"] for p in a.privacy[:max_rows]]
        lines += _table(["flush", "t (s)", "epsilon", "burn (eps/s)"],
                        rows)
        lines += [f"- final epsilon: **{a.privacy[-1]['epsilon']:.4g}** "
                  f"after {len(a.privacy)} accounted flushes", ""]

    # --- events ----------------------------------------------------------
    lines += ["## Events", ""]
    rows = [[k, v] for k, v in sorted(a.counts["kinds"].items())]
    lines += _table(["kind", "count"], rows)
    if a.counts["faults"]:
        rows = [[k, v] for k, v in sorted(a.counts["faults"].items())]
        lines += ["**Injected faults:**", ""]
        lines += _table(["fault", "count"], rows)
    if a.counts["quarantine"]:
        rows = [[k, v] for k, v in sorted(a.counts["quarantine"].items())]
        lines += ["**Quarantined rows:**", ""]
        lines += _table(["cause", "count"], rows)
    return "\n".join(lines).rstrip() + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Render a grid telemetry JSONL trace as a markdown "
                    "run report (critical path, stragglers, wire ledger, "
                    "privacy curve, fault counts).")
    ap.add_argument("jsonl", help="JSONL trace file")
    ap.add_argument("--metrics", default=None, metavar="SNAPSHOT_JSON",
                    help="MetricsRegistry.snapshot() JSON to cross-check "
                         "the trace against")
    ap.add_argument("-o", "--out", default=None, metavar="MD",
                    help="write the report here (default: stdout)")
    ap.add_argument("--title", default="Grid run report")
    args = ap.parse_args(argv)
    metrics = None
    if args.metrics:
        with open(args.metrics) as f:
            metrics = json.load(f)
    text = build_report(args.jsonl, metrics=metrics, title=args.title)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({len(text.splitlines())} lines)")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
