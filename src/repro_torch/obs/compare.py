"""Diff two grid runs — JSONL traces and/or metrics snapshots — as flat
scalar tables, with CI-gating thresholds (stdlib-only).

Each input is flattened to ``name -> number``:

* a ``MetricsRegistry.snapshot()`` JSON becomes ``counter.<name>`` (plus
  ``counter.<name>/<label>`` per label), ``gauge.<name>`` and
  ``hist.<name>.count|mean|min|max``;
* a telemetry JSONL trace is run through ``obs/analyze.py`` and becomes
  ``kind.<k>`` / ``fault.<k>`` / ``quarantine.<k>`` counts,
  ``phase.<k>`` critical-path totals, ``virtual_seconds``, ``rounds``,
  ``wire.<tier>.up_bytes|down_bytes|transfers|uploads`` and
  ``privacy.epsilon_final`` / ``privacy.flushes``.

The two sides need not be the same kind of file — any overlapping names
diff; one-sided names show as added/removed.

``--fail-on 'PAT[:RELTOL]'`` (repeatable, fnmatch globs) turns the diff
into a gate: exit 1 if any matching metric differs by more than RELTOL
relative (default 0 = must match exactly), or exists on only one side.

    python -m repro_torch.obs.compare golden.json run.json \
        --fail-on 'counter.dispatches' --fail-on 'counter.tier_*' \
        --fail-on 'phase.*:0.05' -o diff.md
"""
from __future__ import annotations

import fnmatch
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import analyze as analyze_lib


def flatten_snapshot(doc: dict) -> Dict[str, float]:
    """Flat scalars from a MetricsRegistry.snapshot() dict."""
    out: Dict[str, float] = {}
    for kind, prefix in (("counters", "counter"), ("gauges", "gauge")):
        for name, rec in doc.get(kind, {}).items():
            out[f"{prefix}.{name}"] = float(rec.get("value", 0.0))
            for label, v in (rec.get("labels") or {}).items():
                out[f"{prefix}.{name}/{label}"] = float(v)
    for name, summ in doc.get("histograms", {}).items():
        for stat in ("count", "mean", "min", "max"):
            if summ.get(stat) is not None:
                out[f"hist.{name}.{stat}"] = float(summ[stat])
    return out


def flatten_trace(path: str) -> Dict[str, float]:
    """Flat scalars from a telemetry JSONL trace via obs/analyze."""
    a = analyze_lib.analyze(path)
    out: Dict[str, float] = {"virtual_seconds": float(a.virtual_seconds),
                             "rounds": float(len(a.breakdowns))}
    for k, v in a.counts["kinds"].items():
        out[f"kind.{k}"] = float(v)
    for k, v in a.counts["faults"].items():
        out[f"fault.{k}"] = float(v)
    for k, v in a.counts["quarantine"].items():
        out[f"quarantine.{k}"] = float(v)
    for k, v in a.phase_totals.items():
        out[f"phase.{k}"] = float(v)
    for tier, rec in a.wire.items():
        for field, v in rec.items():
            out[f"wire.{tier}.{field}"] = float(v)
    if a.privacy:
        out["privacy.epsilon_final"] = float(a.privacy[-1]["epsilon"])
        out["privacy.flushes"] = float(len(a.privacy))
    return out


def flatten(path: str) -> Dict[str, float]:
    """Flatten one input file, sniffing its format: a JSON object with
    a ``counters``/``gauges`` key is a metrics snapshot, anything else
    is treated as a JSONL trace."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and ("counters" in doc or "gauges" in doc):
            return flatten_snapshot(doc)
    except (json.JSONDecodeError, UnicodeDecodeError):
        pass  # multi-line JSONL (or not JSON at all): fall through
    return flatten_trace(path)


def parse_fail_on(patterns: List[str]) -> List[Tuple[str, float]]:
    """'PAT' or 'PAT:RELTOL' -> (glob, reltol). A bare PAT means exact
    match required (reltol 0)."""
    out = []
    for p in patterns:
        if ":" in p:
            pat, tol = p.rsplit(":", 1)
            out.append((pat, float(tol)))
        else:
            out.append((p, 0.0))
    return out


def diff(a: Dict[str, float], b: Dict[str, float],
         fail_on: Optional[List[Tuple[str, float]]] = None
         ) -> Tuple[List[dict], List[str]]:
    """Rows over the union of metric names, plus the list of gate
    violations (empty when nothing matched --fail-on or all matches
    were within tolerance)."""
    rows: List[dict] = []
    violations: List[str] = []
    for name in sorted(set(a) | set(b)):
        va, vb = a.get(name), b.get(name)
        if va is None or vb is None:
            delta = rel = float("nan")
        else:
            delta = vb - va
            rel = delta / max(abs(va), abs(vb), 1e-12)
        rows.append({"name": name, "a": va, "b": vb,
                     "delta": delta, "rel": rel})
        for pat, tol in (fail_on or []):
            if not fnmatch.fnmatch(name, pat):
                continue
            if va is None or vb is None:
                violations.append(
                    f"{name}: present on only one side "
                    f"(a={va!r}, b={vb!r}) [{pat}]")
            elif abs(rel) > tol:
                violations.append(
                    f"{name}: {va:g} -> {vb:g} "
                    f"(rel {rel:+.3%} > tol {tol:.3%}) [{pat}]")
            break  # first matching pattern wins
    return rows, violations


def render(rows: List[dict], label_a: str, label_b: str,
           violations: Optional[List[str]] = None,
           changed_only: bool = False) -> str:
    lines = [f"# Run diff: `{label_a}` vs `{label_b}`", ""]
    shown = [r for r in rows
             if not changed_only or r["delta"] != 0.0]
    n_same = len(rows) - len(shown)
    lines += [f"| metric | {label_a} | {label_b} | delta | rel |",
              "|---|---|---|---|---|"]
    for r in shown:
        fa = "—" if r["a"] is None else f"{r['a']:g}"
        fb = "—" if r["b"] is None else f"{r['b']:g}"
        if r["a"] is None or r["b"] is None:
            fd, fr = "—", "—"
        else:
            fd, fr = f"{r['delta']:+g}", f"{r['rel']:+.2%}"
        lines.append(f"| {r['name']} | {fa} | {fb} | {fd} | {fr} |")
    lines.append("")
    if changed_only and n_same:
        lines += [f"({n_same} unchanged metrics hidden)", ""]
    if violations:
        lines += ["## Gate violations", ""]
        lines += [f"- {v}" for v in violations]
        lines.append("")
    elif violations is not None:
        lines += ["All gated metrics within tolerance.", ""]
    return "\n".join(lines).rstrip() + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Diff two runs (telemetry JSONL traces and/or "
                    "metrics-snapshot JSON) as flat scalars; --fail-on "
                    "turns matching metrics into a CI gate.")
    ap.add_argument("a", help="baseline: trace JSONL or snapshot JSON")
    ap.add_argument("b", help="candidate: trace JSONL or snapshot JSON")
    ap.add_argument("--fail-on", action="append", default=[],
                    metavar="PAT[:RELTOL]",
                    help="fnmatch glob over metric names; exit 1 if a "
                         "matching metric differs by more than RELTOL "
                         "relative (default 0 = exact). Repeatable; "
                         "first matching pattern wins per metric.")
    ap.add_argument("--changed-only", action="store_true",
                    help="hide rows with zero delta")
    ap.add_argument("-o", "--out", default=None, metavar="MD",
                    help="write the diff table here (default: stdout)")
    args = ap.parse_args(argv)
    fa, fb = flatten(args.a), flatten(args.b)
    gates = parse_fail_on(args.fail_on) or None
    rows, violations = diff(fa, fb, gates)
    text = render(rows, args.a, args.b,
                  violations if gates else None,
                  changed_only=args.changed_only)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({len(rows)} metrics, "
              f"{len(violations)} violations)")
    else:
        print(text)
    if violations:
        for v in violations:
            print(f"FAIL {v}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
