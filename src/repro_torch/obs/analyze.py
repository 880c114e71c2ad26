"""Causal-graph analysis over a grid telemetry trace (stdlib-only).

Schema v4 gave every :class:`~repro_torch.obs.trace.TraceRecord` a monotone
``seq`` and an optional ``parent`` id, so a trace is a forest: each
client round trip is a chain ``dispatch -> (fault|retry)* -> upload ->
flush/round -> dp_flush/tier_upload/edge_flush``. This module
reconstructs that graph — from the in-memory record list or from an
exported JSONL file, interchangeably — and computes what the flat event
stream could not answer:

* **Per-round critical paths** (:func:`round_breakdowns`): each sync
  ``round`` span / async ``flush`` window is split into phases —
  downlink transfer, client compute, uplink transfer, retry/backoff,
  server apply, and buffer/idle wait — by walking the round's causal
  chain back through its *bounding* upload (the arrival that closed it)
  to the dispatch span's v4 ``t_down``/``t_comp``/``t_up`` components
  and clipping each segment to the round's window. The phases sum to
  the round's virtual wall time exactly (``wait`` is defined as the
  unattributed remainder, and the chain segments are disjoint and
  clipped, so the remainder is non-negative up to float error), an
  identity the tests hold.
* **Straggler attribution**: which cid/tier/region bounded each round
  or flush, with counts and bounded virtual seconds.
* **Privacy burn rate**: the ``dp_flush`` stream as an
  (epsilon, d(epsilon)/dt) series over virtual time.
* **Wire ledger**: ``tier_upload`` billing instants re-summed per tier,
  cross-checkable against ``CommReport.tier_table()``.

Everything degrades gracefully on pre-v4 traces (no ids -> every round
is "unattributed": its whole window is ``wait``) and on dangling
parents (checkpoint/resume starts a fresh tracer).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

# phase keys, in report order; "apply" is identically 0.0 in the
# virtual clock (the server applies instantaneously at the flush/round
# boundary) but kept so live wall-clock traces (ROADMAP) reuse the keys
PHASES = ("downlink", "compute", "uplink", "retry", "apply", "wait")


@dataclasses.dataclass
class Node:
    """One normalized trace record inside the causal graph."""
    kind: str
    t: float
    dur: Optional[float]
    payload: Dict[str, Any]
    seq: Optional[int] = None
    parent: Optional[int] = None
    children: List[int] = dataclasses.field(default_factory=list)

    @property
    def end(self) -> float:
        return self.t + (self.dur or 0.0)


_TOP_LEVEL = ("v", "kind", "t", "dur", "seq", "parent")


def _normalize(rec: Any) -> Node:
    """TraceRecord or decoded JSONL dict -> Node (payload keys
    identical either way, so JSONL->analyze equals in-memory analyze)."""
    if isinstance(rec, dict):
        return Node(kind=rec["kind"], t=float(rec["t"]),
                    dur=None if rec.get("dur") is None
                    else float(rec["dur"]),
                    payload={k: v for k, v in rec.items()
                             if k not in _TOP_LEVEL},
                    seq=rec.get("seq"), parent=rec.get("parent"))
    return Node(kind=rec.kind, t=rec.t, dur=rec.dur,
                payload=dict(rec.payload),
                seq=getattr(rec, "seq", None),
                parent=getattr(rec, "parent", None))


def load_records(source: Union[str, Iterable]) -> List[Node]:
    """Normalize a trace source: a JSONL path, a Tracer, or an iterable
    of TraceRecords / decoded dicts."""
    if isinstance(source, str):
        out = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(_normalize(json.loads(line)))
        return out
    events = getattr(source, "events", None)
    if events is not None and not isinstance(source, (list, tuple)):
        source = events                       # a Tracer
    return [_normalize(r) for r in source]


@dataclasses.dataclass
class TraceGraph:
    """The causal forest: normalized nodes + seq index + child lists."""
    nodes: List[Node]
    by_seq: Dict[int, Node]

    def of_kind(self, kind: str) -> List[Node]:
        return [n for n in self.nodes if n.kind == kind]

    def get(self, seq: Optional[int]) -> Optional[Node]:
        return None if seq is None else self.by_seq.get(seq)

    def children_of(self, node: Node) -> List[Node]:
        return [self.by_seq[s] for s in node.children]


def build_graph(source: Union[str, Iterable]) -> TraceGraph:
    nodes = load_records(source)
    by_seq = {n.seq: n for n in nodes if n.seq is not None}
    for n in nodes:
        p = by_seq.get(n.parent) if n.parent is not None else None
        if p is not None and n.seq is not None:
            p.children.append(n.seq)
    return TraceGraph(nodes=nodes, by_seq=by_seq)


# ---------------------------------------------------------------------------
# Critical-path phase attribution


def _clip(a: float, b: float, w0: float, w1: float) -> float:
    """Length of [a, b] ∩ [w0, w1]."""
    return max(0.0, min(b, w1) - max(a, w0))


@dataclasses.dataclass
class RoundBreakdown:
    index: int                    # round number / flush number
    kind: str                     # "round" (sync) or "flush" (async)
    start: float                  # window start, virtual seconds
    end: float                    # window end (= the round/flush time)
    phases: Dict[str, float]      # PHASES -> virtual seconds, sums to span
    bounded_by: Optional[Dict[str, Any]]  # cid/tier/region/rtt, or None

    @property
    def span(self) -> float:
        return self.end - self.start

    def check_identity(self, tol: float = 1e-9) -> bool:
        return abs(sum(self.phases.values()) - self.span) \
            <= tol * max(1.0, abs(self.span))


def _chain_phases(graph: TraceGraph, upload: Node, w0: float,
                  w1: float) -> Dict[str, float]:
    """Walk upload -> dispatch -> retry* and lay the chain's phase
    segments onto the window [w0, w1] (clipped — disjoint consecutive
    intervals, so their clipped sum never exceeds the window)."""
    phases = {k: 0.0 for k in PHASES}
    disp = graph.get(upload.parent)
    if disp is None or disp.kind != "dispatch":
        return phases
    p = disp.payload
    t_down = p.get("t_down")
    t_comp = p.get("t_comp")
    t_up = p.get("t_up")
    if t_down is not None and t_comp is not None and t_up is not None:
        a = disp.t
        for key, d in (("downlink", t_down), ("compute", t_comp),
                       ("uplink", t_up)):
            phases[key] += _clip(a, a + d, w0, w1)
            a += d
    elif disp.dur is not None:
        # pre-component trace: the whole round trip counts as uplink-
        # unattributed compute (best effort, identity still holds)
        phases["compute"] += _clip(disp.t, disp.t + disp.dur, w0, w1)
    # parked retries that preceded this dispatch slot: each covers
    # [retry.t, retry.t + backoff], ending where the next attempt starts
    node = graph.get(disp.parent)
    while node is not None and node.kind == "retry":
        b = node.payload.get("backoff") or 0.0
        phases["retry"] += _clip(node.t, node.t + b, w0, w1)
        node = graph.get(node.parent)
    return phases


def _bounded_by(upload: Node) -> Dict[str, Any]:
    p = upload.payload
    return {"cid": p.get("cid"), "tier": p.get("tier"),
            "region": p.get("region"), "rtt": p.get("rtt")}


def round_breakdowns(graph: TraceGraph) -> List[RoundBreakdown]:
    """Per-round critical-path phases. Sync ``round`` spans use their
    own [t, t+dur] window; async ``flush`` instants use the inter-flush
    window [previous flush t (or 0), flush t]. ``wait`` is the window
    time no chain segment claims — deadline tails, buffer idle, and
    everything in unattributed (pre-v4 / resumed) rounds."""
    out: List[RoundBreakdown] = []
    rounds = graph.of_kind("round")
    retries = graph.of_kind("retry")
    for n in rounds:
        w0, w1 = n.t, n.end
        upload = graph.get(n.parent)
        if upload is not None and upload.kind == "upload":
            phases = _chain_phases(graph, upload, w0, w1)
            bounded = _bounded_by(upload)
        else:
            # deadline-bound or dark-window round: no bounding upload.
            # Retry instants inside the window (the sync dark re-poll)
            # claim their backoff; the rest is wait.
            phases = {k: 0.0 for k in PHASES}
            for r in retries:
                if w0 <= r.t < w1 and r.parent is None:
                    b = r.payload.get("backoff") or 0.0
                    phases["retry"] += _clip(r.t, r.t + b, w0, w1)
            bounded = None
        phases["wait"] = (w1 - w0) - sum(
            v for k, v in phases.items() if k != "wait")
        out.append(RoundBreakdown(
            index=int(n.payload.get("round", len(out))), kind="round",
            start=w0, end=w1, phases=phases, bounded_by=bounded))
    if rounds:
        return out
    prev = 0.0
    for n in graph.of_kind("flush"):
        w0, w1 = prev, n.t
        prev = n.t
        upload = graph.get(n.parent)
        if upload is not None and upload.kind == "upload":
            phases = _chain_phases(graph, upload, w0, w1)
            bounded = _bounded_by(upload)
        else:
            phases = {k: 0.0 for k in PHASES}
            bounded = None
        phases["wait"] = (w1 - w0) - sum(
            v for k, v in phases.items() if k != "wait")
        out.append(RoundBreakdown(
            index=int(n.payload.get("version", len(out))), kind="flush",
            start=w0, end=w1, phases=phases, bounded_by=bounded))
    return out


# ---------------------------------------------------------------------------
# Straggler attribution, privacy burn, wire ledger, event counts


def straggler_attribution(breakdowns: List[RoundBreakdown]) -> Dict[str, Any]:
    """Who bounded the clock: counts and bounded virtual seconds keyed
    by cid / tier / region (the bounding upload's payload)."""
    out: Dict[str, Dict[Any, Dict[str, float]]] = {
        "by_cid": {}, "by_tier": {}, "by_region": {}}
    unattributed = 0
    for b in breakdowns:
        if b.bounded_by is None:
            unattributed += 1
            continue
        for key, field in (("by_cid", "cid"), ("by_tier", "tier"),
                           ("by_region", "region")):
            val = b.bounded_by.get(field)
            if val is None:
                continue
            slot = out[key].setdefault(val, {"count": 0, "seconds": 0.0})
            slot["count"] += 1
            slot["seconds"] += b.span
    return {**out, "unattributed": unattributed}


def privacy_series(graph: TraceGraph) -> List[Dict[str, float]]:
    """The dp_flush stream as an epsilon curve with per-step burn rate
    (d(epsilon)/d(virtual time); 0.0 when the clock did not move)."""
    out: List[Dict[str, float]] = []
    prev_t, prev_eps = 0.0, 0.0
    for n in graph.of_kind("dp_flush"):
        eps = n.payload.get("epsilon")
        if eps is None:
            continue
        dt = n.t - prev_t
        out.append({"t": n.t, "flush": n.payload.get("flush", len(out)),
                    "epsilon": float(eps),
                    "burn_rate": (float(eps) - prev_eps) / dt
                    if dt > 0 else 0.0})
        prev_t, prev_eps = n.t, float(eps)
    return out


def wire_ledger(graph: TraceGraph) -> Dict[str, Dict[str, int]]:
    """tier_upload billing instants re-summed per tier name."""
    out: Dict[str, Dict[str, int]] = {}
    for n in graph.of_kind("tier_upload"):
        p = n.payload
        rec = out.setdefault(p["tier_name"],
                             {"down_bytes": 0, "up_bytes": 0,
                              "transfers": 0, "uploads": 0})
        rec["down_bytes"] += int(p.get("down_bytes") or 0)
        rec["up_bytes"] += int(p.get("up_bytes") or 0)
        rec["transfers"] += int(p.get("transfers") or 0)
        rec["uploads"] += int(p.get("uploads") or 0)
    return out


def event_counts(graph: TraceGraph) -> Dict[str, Any]:
    counts: Dict[str, int] = {}
    for n in graph.nodes:
        counts[n.kind] = counts.get(n.kind, 0) + 1
    faults: Dict[str, int] = {}
    for n in graph.of_kind("fault"):
        f = n.payload.get("fault", "?")
        faults[f] = faults.get(f, 0) + 1
    quarantine: Dict[str, int] = {}
    for n in graph.of_kind("quarantine"):
        c = n.payload.get("cause", "?")
        quarantine[c] = quarantine.get(c, 0) + 1
    return {"kinds": counts, "faults": faults, "quarantine": quarantine}


# ---------------------------------------------------------------------------
# One-call rollup


@dataclasses.dataclass
class RunAnalysis:
    mode: str                                 # "sync" | "async" | "empty"
    breakdowns: List[RoundBreakdown]
    phase_totals: Dict[str, float]
    virtual_seconds: float
    stragglers: Dict[str, Any]
    privacy: List[Dict[str, float]]
    wire: Dict[str, Dict[str, int]]
    counts: Dict[str, Any]

    def to_json(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "virtual_seconds": self.virtual_seconds,
            "phase_totals": self.phase_totals,
            "rounds": [{"index": b.index, "kind": b.kind,
                        "start": b.start, "end": b.end,
                        "phases": b.phases, "bounded_by": b.bounded_by}
                       for b in self.breakdowns],
            "stragglers": self.stragglers,
            "privacy": self.privacy,
            "wire": self.wire,
            "counts": self.counts,
        }


def analyze(source: Union[str, Iterable]) -> RunAnalysis:
    """Full rollup for a trace source (JSONL path, Tracer, or record
    iterable): graph -> breakdowns -> totals/stragglers/privacy/wire."""
    graph = build_graph(source)
    breakdowns = round_breakdowns(graph)
    mode = ("empty" if not graph.nodes
            else "sync" if graph.of_kind("round") else "async")
    totals = {k: 0.0 for k in PHASES}
    for b in breakdowns:
        for k, v in b.phases.items():
            totals[k] += v
    vs = max((b.end for b in breakdowns), default=0.0)
    return RunAnalysis(
        mode=mode, breakdowns=breakdowns, phase_totals=totals,
        virtual_seconds=vs,
        stragglers=straggler_attribution(breakdowns),
        privacy=privacy_series(graph), wire=wire_ledger(graph),
        counts=event_counts(graph))
