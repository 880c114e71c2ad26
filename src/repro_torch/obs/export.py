"""Trace exporters: schema-versioned JSONL and Chrome/Perfetto JSON.

The Perfetto export renders the grid's *virtual* clock as trace_event
process/thread tracks, so a run opens directly in ``ui.perfetto.dev``
(or ``chrome://tracing``):

* process "server" — round spans, flush and ``checkpoint`` instants on
  one track, ``dp_flush`` accounting instants on a "privacy" track,
  ``tier_upload`` wire-billing instants on a "wire" track, injected
  ``fault`` firings, sanitize ``quarantine`` instants and correlated
  region ``shock`` firings on a "faults" track, ``edge_flush``
  pre-reduce instants on an "edges" track, parked-dispatch ``retry``
  instants alongside the rounds;
* process "clients" — one thread track per client id, carrying that
  client's ``dispatch`` round-trip spans and ``upload`` arrival
  instants.

Virtual seconds map to trace microseconds 1:1 (``ts = t * 1e6``), so
the timeline reads in simulated fleet time, not host wall-clock.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from repro_torch.obs import schema as schema_lib

# server-process thread ids by event kind
_SERVER_PID = 0
_CLIENT_PID = 1
_SERVER_TIDS = {"round": 0, "flush": 0, "retry": 0, "checkpoint": 0,
                "dp_flush": 1, "tier_upload": 2,
                "fault": 3, "quarantine": 3, "shock": 3,
                "edge_flush": 4}
_SERVER_TID_NAMES = {0: "rounds", 1: "privacy", 2: "wire", 3: "faults",
                     4: "edges"}


def record_json(rec) -> Dict[str, Any]:
    """One TraceRecord -> its schema-versioned JSONL object."""
    out: Dict[str, Any] = {"v": schema_lib.SCHEMA_VERSION,
                           "kind": rec.kind, "t": rec.t}
    if rec.dur is not None:
        out["dur"] = rec.dur
    seq = getattr(rec, "seq", None)
    if seq is not None:
        out["seq"] = seq
    parent = getattr(rec, "parent", None)
    if parent is not None:
        out["parent"] = parent
    out.update(rec.payload)
    return out


def write_jsonl(records: Iterable, path: str) -> int:
    """Write one JSON object per record; returns the record count."""
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(record_json(rec)) + "\n")
            n += 1
    return n


def _us(t: float) -> float:
    return t * 1e6


def perfetto_trace(records: Iterable) -> Dict[str, Any]:
    """Chrome trace_event document for a record stream (see module
    docstring for the track layout). Events are stably sorted by
    ``(ts, seq)`` — the monotone v4 seq breaks ties between
    zero-duration instants sharing a virtual timestamp, so the export is
    deterministic regardless of dict/iterator quirks upstream. Records
    with a ``parent`` additionally emit a flow-event pair (``ph: s/f``)
    so causal chains render as arrows in ui.perfetto.dev."""
    keyed: List[tuple] = []           # (ts, tiebreak, event dict)
    coords: Dict[int, tuple] = {}     # seq -> (pid, tid, start_ts, end_ts)
    links: List[tuple] = []           # (child seq, parent seq)
    client_tids = set()
    for i, rec in enumerate(records):
        args = {k: v for k, v in rec.payload.items() if v is not None}
        seq = getattr(rec, "seq", None)
        parent = getattr(rec, "parent", None)
        if seq is not None:
            args["seq"] = seq
        if rec.kind in ("dispatch", "upload"):
            pid, tid = _CLIENT_PID, int(rec.payload["cid"])
            client_tids.add(tid)
        else:
            pid = _SERVER_PID
            tid = _SERVER_TIDS.get(rec.kind, 0)
        ts = _us(rec.t)
        if rec.dur is not None:
            ev = {"name": rec.kind, "cat": rec.kind, "ph": "X",
                  "ts": ts, "dur": _us(rec.dur),
                  "pid": pid, "tid": tid, "args": args}
            end_ts = ts + _us(rec.dur)
        else:
            # instants: flushes & co. render as global markers on the
            # server tracks, client arrivals as thread-scoped ticks
            scope = "t" if pid == _CLIENT_PID else "g"
            ev = {"name": rec.kind, "cat": rec.kind, "ph": "i",
                  "ts": ts, "s": scope,
                  "pid": pid, "tid": tid, "args": args}
            end_ts = ts
        keyed.append((ts, seq if seq is not None else i, ev))
        if seq is not None:
            coords[seq] = (pid, tid, ts, end_ts)
            if parent is not None:
                links.append((seq, parent))
    keyed.sort(key=lambda kv: (kv[0], kv[1]))
    events: List[Dict[str, Any]] = [ev for _, _, ev in keyed]
    # causal arrows: flow start at the parent's end, flow finish (with
    # binding point "enclosing slice start") at the child's start —
    # in child-seq order, so the export stays input-order independent
    for child, parent in sorted(links):
        if parent not in coords or child not in coords:
            continue                     # dangling ref (e.g. post-resume)
        ppid, ptid, _, pend = coords[parent]
        cpid, ctid, cstart, _ = coords[child]
        events.append({"name": "causal", "cat": "causal", "ph": "s",
                       "id": child, "ts": pend, "pid": ppid, "tid": ptid})
        events.append({"name": "causal", "cat": "causal", "ph": "f",
                       "bp": "e", "id": child, "ts": cstart,
                       "pid": cpid, "tid": ctid})
    meta = [
        {"name": "process_name", "ph": "M", "pid": _SERVER_PID,
         "args": {"name": "server"}},
        {"name": "process_name", "ph": "M", "pid": _CLIENT_PID,
         "args": {"name": "clients"}},
    ]
    for tid, name in _SERVER_TID_NAMES.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": _SERVER_PID,
                     "tid": tid, "args": {"name": name}})
    for tid in sorted(client_tids):
        meta.append({"name": "thread_name", "ph": "M", "pid": _CLIENT_PID,
                     "tid": tid, "args": {"name": f"client {tid}"}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"clock": "virtual-seconds",
                          "schema_version": schema_lib.SCHEMA_VERSION}}


def write_perfetto(records: Iterable, path: str) -> int:
    doc = perfetto_trace(records)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"]
               if e.get("ph") not in ("M", "s", "f"))
