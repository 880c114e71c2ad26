"""Structured event tracing for the simulation grid.

A :class:`Tracer` collects typed span/event records (kinds defined in
``obs/schema.py``: ``dispatch``, ``upload``, ``retry``, ``flush``,
``round``, ``dp_flush``, ``tier_upload``) stamped in *virtual* seconds,
emitted from the scheduler, the grid loop, the per-flush DP
accountant, and the comm ledger's tier billing. Exporters
(``obs/export.py``) turn the stream into schema-versioned JSONL or a
Chrome/Perfetto timeline.

The whole layer is a no-op by default: ``GridConfig.telemetry=None``
routes every emission through the module-level :data:`NULL_TRACER`,
whose ``span``/``instant`` are empty methods — no record allocation, no
extra PRNG draws, and (test-enforced) bit-identical run histories. This
mirrors the repo's ``resolve_dynamics`` / one-tier-plan "trivial case is
exact" discipline: instrumentation you don't ask for costs nothing and
changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.obs import export as export_lib
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import schema as schema_lib

KINDS = schema_lib.KINDS


@dataclasses.dataclass
class TraceRecord:
    kind: str                       # one of schema.KINDS
    t: float                        # virtual-time start (seconds)
    dur: Optional[float]            # virtual duration; None = instant
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # --- schema v4 causal ids ---
    # seq: monotone per-Tracer emission id; parent: seq of the record
    # this one is causally downstream of (dispatch -> upload -> flush ->
    # dp_flush, ...). Both optional so positional construction and
    # pre-v4 streams stay valid.
    seq: Optional[int] = None
    parent: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        return export_lib.record_json(self)


@dataclasses.dataclass
class TelemetryConfig:
    """What to do with the event stream a traced run produces.

    With both paths ``None`` the events just accumulate on
    ``Tracer.events`` (and ``GridResult.telemetry``) for in-process
    inspection/export. ``profile=True`` additionally wraps the round,
    lane step and server tail in ``torch.profiler`` ranges
    (``obs/profiling.py``) so a wall-time profile captured around the
    run lines up with the virtual-time spans."""
    jsonl_path: Optional[str] = None
    perfetto_path: Optional[str] = None
    profile: bool = False


class NullTracer:
    """The telemetry=None fast path: every emission is a no-op. A
    single shared instance (:data:`NULL_TRACER`) stands in everywhere a
    tracer is threaded, so call sites never branch."""

    enabled = False
    events: tuple = ()

    def span(self, kind: str, t: float, dur: Optional[float],
             parent: Optional[int] = None, **payload) -> None:
        pass

    def instant(self, kind: str, t: float,
                parent: Optional[int] = None, **payload) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Collects TraceRecords in emission order (which is virtual-time
    order for the event-driven engines) and exports them on demand."""

    enabled = True

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        self.config = config or TelemetryConfig()
        self.metrics = metrics or metrics_lib.MetricsRegistry()
        self.events: List[TraceRecord] = []
        self._next_seq = 0

    def span(self, kind: str, t: float, dur: Optional[float],
             parent: Optional[int] = None, **payload) -> int:
        seq = self._next_seq
        self._next_seq = seq + 1
        self.events.append(TraceRecord(
            kind, float(t), None if dur is None else float(dur), payload,
            seq=seq, parent=parent))
        return seq

    def instant(self, kind: str, t: float,
                parent: Optional[int] = None, **payload) -> int:
        return self.span(kind, t, None, parent=parent, **payload)

    # --- inspection -----------------------------------------------------
    def kind_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for rec in self.events:
            counts[rec.kind] = counts.get(rec.kind, 0) + 1
        return counts

    def of_kind(self, kind: str) -> List[TraceRecord]:
        return [rec for rec in self.events if rec.kind == kind]

    # --- export ---------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        return export_lib.write_jsonl(self.events, path)

    def export_perfetto(self, path: str) -> int:
        return export_lib.write_perfetto(self.events, path)

    def flush_outputs(self) -> None:
        """Write whatever the config asked for (called once at the end
        of a traced grid run)."""
        if self.config.jsonl_path:
            self.export_jsonl(self.config.jsonl_path)
        if self.config.perfetto_path:
            self.export_perfetto(self.config.perfetto_path)


def resolve_telemetry(spec: Any) -> Optional[TelemetryConfig]:
    """GridConfig.telemetry -> TelemetryConfig or None (= NULL_TRACER).

    Accepts ``None`` (off), a ``TelemetryConfig``, ``True`` / ``"on"`` /
    ``"memory"`` (trace in memory, export manually), or a dict of
    TelemetryConfig fields."""
    if spec is None:
        return None
    if isinstance(spec, TelemetryConfig):
        return spec
    if spec is True or spec in ("on", "memory"):
        return TelemetryConfig()
    if isinstance(spec, dict):
        return TelemetryConfig(**spec)
    raise ValueError(f"unknown telemetry spec {spec!r} (expected None, "
                     "a TelemetryConfig, True/'on'/'memory', or a dict "
                     "of TelemetryConfig fields)")
