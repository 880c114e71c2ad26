"""Grid telemetry: structured event tracing, a metrics registry, and
trace exporters (schema-versioned JSONL + Chrome/Perfetto timelines).

The schema, export, metrics, trace, analyze, report and compare modules
are copies of the stdlib-only ``repro/obs`` modules; ``profiling`` is
ported onto ``torch.profiler``. ``GridConfig.telemetry=None`` (the
default) routes tracing through :data:`NULL_TRACER` — a strict no-op
with bit-identical run histories — while the metrics registry is always
live and backs ``GridResult.scheduler_stats`` / ``tier_stats`` as its
dict views.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, SNAPSHOT_VERSION)
from repro_torch.obs.schema import (EVENT_SCHEMA, KINDS, SCHEMA_VERSION,
                                    validate_jsonl, validate_perfetto,
                                    validate_record, validate_records)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, TelemetryConfig,
                                   TraceRecord, Tracer, resolve_telemetry)
from repro_torch.obs import export
