"""Event-record schema for the grid's telemetry stream (stdlib-only).

Every record a :class:`repro_torch.obs.trace.Tracer` emits serializes to one
JSON object carrying the schema version, the event kind, its virtual-time
start ``t`` (seconds), an optional duration ``dur`` (seconds; ``null`` or
absent for instant events), and a kind-specific payload. This module is
the single source of truth for what those payloads look like: the JSONL
exporter writes records of this shape, the CI ``telemetry`` job validates
every emitted line against it, and the live-server path (ROADMAP) is
expected to reuse the same stream.

Deliberately dependency-free (``json`` + ``math`` only) so the validator
can run anywhere — including the CLI form the CI job uses:

    python -m repro_torch.obs.schema trace.jsonl --perfetto trace.json \
        --require dispatch flush
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

SCHEMA_VERSION = 4
# schema v2 added the fault/quarantine/checkpoint kinds; v3 added the
# edge_flush/shock kinds and the optional region field on
# dispatch/upload (sim/topology.py); v4 added the top-level causal ids
# ``seq`` (monotone per-tracer emission id) / ``parent`` (seq of the
# causally-upstream record) and the optional ``t_down``/``t_comp``/
# ``t_up`` phase components on dispatch spans. Earlier streams are
# strict subsets and stay valid.
ACCEPTED_VERSIONS = (1, 2, 3, 4)

_NUM = (int, float)
_INT = (int,)
_STR = (str,)
_BOOL = (bool,)

# kind -> (required payload fields, optional payload fields); each field
# maps to the tuple of accepted Python types (post-json.loads). ``None``
# is accepted for any *optional* field — "measured but not applicable"
# is an explicit null, never a missing-vs-zero ambiguity.
EVENT_SCHEMA: Dict[str, Tuple[Dict[str, tuple], Dict[str, tuple]]] = {
    # one client round trip attempt, dispatch -> upload-complete (span;
    # dur is null when the client never finishes: sync dropout)
    "dispatch": ({"cid": _INT},
                 {"tier": _INT, "region": _INT, "down_bytes": _INT,
                  "up_bytes": _INT, "version": _INT, "outcome": _STR,
                  # v4: per-phase virtual-time components of the round
                  # trip (downlink transfer, client compute, uplink
                  # transfer), so analyze.py can split the span without
                  # re-deriving link models
                  "t_down": _NUM, "t_comp": _NUM, "t_up": _NUM}),
    # a delta arriving at the server (instant)
    "upload": ({"cid": _INT, "up_bytes": _INT},
               {"tier": _INT, "region": _INT, "staleness": _INT,
                "rtt": _NUM, "participant": _BOOL}),
    # a dispatch slot parked by a dark availability window (instant)
    "retry": ({}, {"backoff": _NUM}),
    # one buffered async server update (instant at apply time)
    "flush": ({"version": _INT, "buffer_fill": _NUM},
              {"staleness_mean": _NUM, "staleness_max": _NUM}),
    # one synchronous cohort round (span over the round's virtual time)
    "round": ({"round": _INT},
              {"participants": _NUM, "cohort": _INT, "loss": _NUM}),
    # one FlushAccountant composition step (instant)
    "dp_flush": ({"flush": _INT, "n_real": _INT, "multiplicity": _INT},
                 {"sigma": _NUM, "epsilon": _NUM, "delta": _NUM,
                  "padded": _BOOL}),
    # tier-sliced wire billing from the comm ledger (instant)
    "tier_upload": ({"tier_name": _STR, "down_bytes": _INT,
                     "up_bytes": _INT},
                    {"transfers": _INT, "uploads": _INT}),
    # --- schema v2 ---
    # one injected fault firing (sim/faults.py): crash_compute,
    # truncate_upload (frac/up_bytes = what arrived), corrupt_nan,
    # corrupt_bitflip, duplicate_upload (instant)
    "fault": ({"fault": _STR},
              {"cid": _INT, "tier": _INT, "frac": _NUM, "up_bytes": _INT}),
    # one row quarantined by the sanitize screen (core/sanitize.py)
    # before aggregation: cause is "nonfinite" or "norm-outlier"
    # (instant at the flush/round that screened it)
    "quarantine": ({"cause": _STR},
                   {"cid": _INT, "tier": _INT, "norm": _NUM,
                    "flush": _INT, "round": _INT}),
    # one grid-state snapshot written (checkpoint/grid_state.py)
    "checkpoint": ({"path": _STR},
                   {"applied": _INT, "round": _INT, "mode": _STR,
                    "buffer_fill": _NUM, "events_in_flight": _INT}),
    # --- schema v3 (sim/topology.py) ---
    # one edge aggregator forwarding its pre-reduced flat buffer
    # upstream (instant at the flush/round that drained it): fill = how
    # many client rows it reduced, up_bytes = the buffer's wire size
    "edge_flush": ({"region": _INT},
                   {"fill": _INT, "up_bytes": _INT, "norm": _NUM,
                    "round": _INT, "flush": _INT}),
    # one correlated region outage firing (sim/dynamics.RegionShocks):
    # the region's clients' availability is scaled by residual until
    # virtual time ``until`` (instant at the outage start)
    "shock": ({"region": _INT},
              {"duration": _NUM, "residual": _NUM, "until": _NUM}),
}

KINDS = tuple(EVENT_SCHEMA)


def _type_ok(value: Any, types: tuple) -> bool:
    # bool is an int subclass; never let a bool satisfy an int/num field
    if isinstance(value, bool):
        return bool in types or _BOOL == types
    if float in types and isinstance(value, _NUM):
        return True
    return isinstance(value, types)


def validate_record(rec: Any) -> List[str]:
    """Errors for one decoded JSONL record ([] = valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errs: List[str] = []
    v = rec.get("v")
    if v not in ACCEPTED_VERSIONS:
        errs.append(f"v={v!r} (expected one of {ACCEPTED_VERSIONS})")
    kind = rec.get("kind")
    if kind not in EVENT_SCHEMA:
        return errs + [f"unknown kind {kind!r}"]
    t = rec.get("t")
    if not (isinstance(t, _NUM) and not isinstance(t, bool)
            and math.isfinite(t) and t >= 0.0):
        errs.append(f"t={t!r} is not a finite non-negative number")
    dur = rec.get("dur")
    if dur is not None and not (isinstance(dur, _NUM)
                                and not isinstance(dur, bool)
                                and math.isfinite(dur) and dur >= 0.0):
        errs.append(f"dur={dur!r} is not null or a finite non-negative "
                    "number")
    # v4 causal ids are top-level (not payload) and optional — pre-v4
    # streams simply omit them.
    for name in ("seq", "parent"):
        val = rec.get(name)
        if val is not None and not (isinstance(val, int)
                                    and not isinstance(val, bool)
                                    and val >= 0):
            errs.append(f"{name}={val!r} is not null or a non-negative "
                        "integer")
    required, optional = EVENT_SCHEMA[kind]
    payload = {k: val for k, val in rec.items()
               if k not in ("v", "kind", "t", "dur", "seq", "parent")}
    for name, types in required.items():
        if name not in payload:
            errs.append(f"{kind}: missing required field {name!r}")
        elif payload[name] is None or not _type_ok(payload[name], types):
            errs.append(f"{kind}: field {name!r}={payload[name]!r} has "
                        "the wrong type")
    for name, val in payload.items():
        if name in required:
            continue
        if name not in optional:
            errs.append(f"{kind}: unexpected field {name!r}")
        elif val is not None and not _type_ok(val, optional[name]):
            errs.append(f"{kind}: field {name!r}={val!r} has the wrong "
                        "type")
    return errs


def validate_records(records: Iterable[Any]) -> List[str]:
    """All errors across a record stream, prefixed with the 1-based
    record index."""
    errs = []
    for i, rec in enumerate(records):
        errs.extend(f"record {i + 1}: {e}" for e in validate_record(rec))
    return errs


def validate_causal_ids(records: Iterable[Any]) -> List[str]:
    """v4 id-integrity errors for a decoded record stream: every record
    must carry a ``seq``, seqs must be strictly increasing (one tracer,
    emission order), every non-null ``parent`` must reference an
    already-emitted seq, and at least one parent link must exist (a
    stream with ids but no edges is a broken chain, not a graph)."""
    errs: List[str] = []
    seen: set = set()
    prev = -1
    any_parent = False
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            continue
        seq = rec.get("seq")
        if not (isinstance(seq, int) and not isinstance(seq, bool)):
            errs.append(f"record {i + 1}: missing seq (ids required)")
            continue
        if seq <= prev:
            errs.append(f"record {i + 1}: seq={seq} not strictly "
                        f"increasing (previous {prev})")
        prev = max(prev, seq)
        parent = rec.get("parent")
        if parent is not None:
            any_parent = True
            if parent not in seen:
                errs.append(f"record {i + 1}: parent={parent} does not "
                            "reference an earlier seq")
        seen.add(seq)
    if prev >= 0 and not any_parent:
        errs.append("no parent link anywhere in the stream")
    return errs


def validate_jsonl(path: str) -> Tuple[int, List[str]]:
    """(record count, errors) for a JSONL trace file."""
    n = 0
    errs: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {i + 1}: not valid JSON ({e})")
                continue
            errs.extend(f"line {i + 1}: {e}" for e in validate_record(rec))
    return n, errs


def validate_perfetto(path: str,
                      require: Iterable[str] = ()) -> Tuple[int, List[str]]:
    """(event count, errors) for a Chrome/Perfetto ``trace_event`` JSON
    export: the file must be loadable JSON with a ``traceEvents`` list,
    and must contain at least one non-metadata event named after each
    kind in ``require``."""
    errs: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return 0, [f"not loadable JSON: {e}"]
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        return 0, ["missing 'traceEvents' list"]
    # metadata ("M") and v4 causal flow-link pairs ("s"/"f") are derived
    # decoration, not records — the count must match the JSONL stream
    named = [e for e in events
             if isinstance(e, dict) and e.get("ph") not in ("M", "s", "f")]
    for e in named:
        ts = e.get("ts")
        if not (isinstance(ts, _NUM) and not isinstance(ts, bool)
                and math.isfinite(ts) and ts >= 0.0):
            errs.append(f"event {e.get('name')!r}: ts={ts!r} is not a "
                        "finite non-negative number")
    for kind in require:
        if not any(e.get("name") == kind for e in named):
            errs.append(f"no {kind!r} event in the trace")
    return len(named), errs


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate a grid telemetry JSONL stream (and "
                    "optionally its Perfetto export) against the event "
                    "schema.")
    ap.add_argument("jsonl", help="JSONL trace file (one record per line)")
    ap.add_argument("--perfetto", default=None, metavar="JSON",
                    help="also validate a Chrome/Perfetto trace_event "
                         "export")
    ap.add_argument("--require", nargs="*", default=[], metavar="KIND",
                    help="event kinds that must appear in BOTH files")
    ap.add_argument("--require-ids", action="store_true",
                    help="require v4 causal ids: every record carries a "
                         "strictly-monotone seq, parents resolve, and at "
                         "least one parent link exists")
    args = ap.parse_args(argv)
    n, errs = validate_jsonl(args.jsonl)
    if n == 0:
        errs.append("no records in the JSONL stream")
    seen = set()
    decoded = []
    with open(args.jsonl) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                decoded.append(rec)
                if isinstance(rec, dict):
                    seen.add(rec.get("kind"))
    for kind in args.require:
        if kind not in seen:
            errs.append(f"jsonl: no {kind!r} record in the stream")
    if args.require_ids:
        errs.extend(f"jsonl: {e}" for e in validate_causal_ids(decoded))
    print(f"{args.jsonl}: {n} records, {len(errs)} error(s)")
    if args.perfetto:
        pn, perrs = validate_perfetto(args.perfetto, require=args.require)
        print(f"{args.perfetto}: {pn} events, {len(perrs)} error(s)")
        errs.extend(perrs)
    for e in errs:
        print(f"  ERROR: {e}")
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
