"""Metrics registry: counters, gauges and histograms with a snapshot API.

One :class:`MetricsRegistry` instance rides along with every grid run —
telemetry on or off — and is the single source of truth for the run's
scalar observables: the scheduler's dispatch/upload/dropout/retry
counters, the per-tier wire and timing accumulators, and the per-tier
compute gauges. ``GridResult.scheduler_stats`` / ``tier_stats`` are
*views* over it (the dict values are read back out of the registry), so
consumers can either keep using those dicts or take
``registry.snapshot()`` and get the same numbers plus everything else.

Metrics are plain Python accumulation (no JAX, no locks — the grid is
single-threaded), and each metric optionally splits by a hashable
``label`` (tier index, event kind, ...) on top of its global value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Hashable, Optional

SNAPSHOT_VERSION = 1


class Counter:
    """Monotonic accumulator with an optional per-label breakdown."""

    __slots__ = ("name", "value", "labels")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.labels: Dict[Hashable, Any] = {}

    def inc(self, amount=1, label: Optional[Hashable] = None) -> None:
        self.value += amount
        if label is not None:
            self.labels[label] = self.labels.get(label, 0) + amount

    def get(self, label: Hashable, default=0):
        return self.labels.get(label, default)


class Gauge:
    """Last-written value (plus per-label last-written values)."""

    __slots__ = ("name", "value", "labels")

    def __init__(self, name: str):
        self.name = name
        self.value: Any = None
        self.labels: Dict[Hashable, Any] = {}

    def set(self, value, label: Optional[Hashable] = None) -> None:
        self.value = value
        if label is not None:
            self.labels[label] = value

    def get(self, label: Hashable, default=None):
        return self.labels.get(label, default)


class Histogram:
    """Streaming count/sum/min/max (mean is derived at snapshot time —
    enough for the grid's timing distributions without storing samples)."""

    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}


@dataclasses.dataclass
class MetricsRegistry:
    counters: Dict[str, Counter] = dataclasses.field(default_factory=dict)
    gauges: Dict[str, Gauge] = dataclasses.field(default_factory=dict)
    histograms: Dict[str, Histogram] = dataclasses.field(
        default_factory=dict)

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-serializable dict of every metric's current state.
        Labels are stringified (tier indices become "0", "1", ...) so
        the snapshot round-trips through json without surprises."""
        return {
            "v": SNAPSHOT_VERSION,
            "counters": {
                n: {"value": c.value,
                    "labels": {str(k): v for k, v in c.labels.items()}}
                for n, c in sorted(self.counters.items())},
            "gauges": {
                n: {"value": g.value,
                    "labels": {str(k): v for k, v in g.labels.items()}}
                for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self.histograms.items())},
        }

    def state_dict(self) -> Dict[str, Any]:
        """Exact restorable state — unlike :meth:`snapshot`, labels are
        kept as ``[key, value]`` pairs so integer label keys (tier
        indices) survive a JSON round trip, and histograms keep their
        raw accumulators (min/max stored as ``None`` when empty)."""
        return {
            "counters": {
                n: [c.value, [[k, v] for k, v in c.labels.items()]]
                for n, c in self.counters.items()},
            "gauges": {
                n: [g.value, [[k, v] for k, v in g.labels.items()]]
                for n, g in self.gauges.items()},
            "histograms": {
                n: [h.count, h.total,
                    None if h.count == 0 else h.min,
                    None if h.count == 0 else h.max]
                for n, h in self.histograms.items()},
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore in place from a :meth:`state_dict` blob (metrics not
        named in the blob are left untouched — a restored run registers
        the same names anyway)."""
        for n, (value, labels) in state.get("counters", {}).items():
            c = self.counter(n)
            c.value = value
            c.labels = {k: v for k, v in labels}
        for n, (value, labels) in state.get("gauges", {}).items():
            g = self.gauge(n)
            g.value = value
            g.labels = {k: v for k, v in labels}
        for n, (count, total, lo, hi) in state.get(
                "histograms", {}).items():
            h = self.histogram(n)
            h.count = int(count)
            h.total = float(total)
            h.min = math.inf if lo is None else float(lo)
            h.max = -math.inf if hi is None else float(hi)
