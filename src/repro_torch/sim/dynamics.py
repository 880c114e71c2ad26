"""Device dynamics for the simulation grid: stochastic links,
trace-driven availability, and correlated region-level shocks.

A plain fleet is a *static* snapshot: every transfer moved at exactly the
profile's base bandwidth and availability was one Bernoulli probability,
frozen for the whole run. Real phone fleets are nothing like that — links
jitter transfer to transfer, every transfer pays a latency floor, and
devices follow diurnal online/offline cycles (charging overnight, dark
during the commute). This module models both, queried at *virtual time*
so async flushes see the clock move:

* :class:`LinkModel` — per-transfer multiplicative **log-normal jitter**
  on top of the profile's base bandwidth, plus a fixed **RTT latency
  floor** per transfer. The jitter is mean-preserving
  (``exp(sigma*z - sigma^2/2)`` with ``z ~ N(0,1)``), so enabling it
  changes variance, not the expected transfer time; ``sigma=0`` maps
  ``z`` to exactly ``1.0`` and the transfer time is bit-for-bit the
  static ``bytes/bps`` (plus the floor, itself 0 by default).

* :class:`AvailabilityTrace` — ``prob(cid, t)`` in ``[0, 1]``,
  *multiplied* into the profile's base availability at dispatch time:
  :class:`AlwaysOn` (trivial, the pre-dynamics behavior),
  :class:`DiurnalTrace` (sinusoid with per-client phase, the diurnal
  preset) and :class:`StepTrace` (arbitrary per-client step functions —
  e.g. a maintenance window where the whole fleet goes dark). Every
  trace also answers ``prob_batch(cids, t)`` — one vectorized query per
  cohort, which is how the sync engine consumes it.

* :class:`RegionShocks` — **correlated** availability shocks over the
  two-level topology (``sim/topology.py``): a Poisson process of
  outages, each downing *one whole edge region* (a cell-tower outage
  takes out its geographic client group together) for ``duration``
  virtual seconds, scaling every member's availability by ``residual``.
  Bound to its own spawned RNG stream (zero draws of any other stream),
  advanced lazily at monotone virtual time, snapshot/restorable.

* :class:`DynamicsConfig` — link + trace + shocks, plus the async
  scheduler's redispatch backoff (how long to wait, in virtual seconds,
  before re-trying dispatch when the trace has everyone offline).
  ``bind``-ing a config to a fleet resolves per-profile ``link_model``
  overrides into per-client sigma/RTT *arrays* (no N-tuple of link
  objects) and draws the per-client trace phases — from the grid's
  *dynamics* RNG stream, an independent child spawned off
  ``device_seed``, so enabling dynamics never perturbs the scheduler's
  fixed-count availability/dropout draws (the trivial-case bit-for-bit
  contract).

The trivial config (static links, always-on, no shocks) resolves to
``None`` in the grid and the schedulers take their exact pre-dynamics
paths.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Union

import numpy as np


# ---------------------------------------------------------------------------
# Stochastic links


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-transfer stochastic model over a profile's base bandwidth.

    ``transfer_seconds`` takes a standard-normal draw ``z`` (drawn by the
    caller from the dynamics stream, one per transfer) and returns

        rtt_seconds + (nbytes / bps) * exp(jitter_sigma*z - jitter_sigma^2/2)

    The log-normal factor has mean exactly 1, so the *expected* transfer
    time is the static time plus the RTT floor; ``jitter_sigma=0`` gives
    the static time bit-for-bit (``exp(0.0) == 1.0``).
    """
    jitter_sigma: float = 0.0     # log-normal sigma on the transfer time
    rtt_seconds: float = 0.0      # fixed latency floor per transfer

    @property
    def trivial(self) -> bool:
        return self.jitter_sigma == 0.0 and self.rtt_seconds == 0.0

    def jitter(self, z: float) -> float:
        """Mean-1 multiplicative jitter factor from a N(0,1) draw."""
        s = self.jitter_sigma
        return math.exp(s * float(z) - 0.5 * s * s)

    def transfer_seconds(self, nbytes: float, bps: float, z: float) -> float:
        return self.rtt_seconds + (nbytes / bps) * self.jitter(z)


# ---------------------------------------------------------------------------
# Availability traces (queried at virtual time)


class AvailabilityTrace:
    """``prob(cid, t) in [0, 1]``, multiplied into the profile's base
    availability at dispatch time. ``bind(num_clients, rng)`` resolves
    any per-client randomness (e.g. diurnal phases) from the dynamics
    stream and returns the bound trace. ``prob_batch(cids, t)`` is the
    vectorized form — subclasses should override it with one array op
    (the base-class fallback loops)."""

    trivial = False

    def bind(self, num_clients: int,
             rng: np.random.Generator) -> "AvailabilityTrace":
        return self

    def prob(self, cid: int, t: float) -> float:
        raise NotImplementedError

    def prob_batch(self, cids: np.ndarray, t: float) -> np.ndarray:
        return np.array([self.prob(int(c), t) for c in np.asarray(cids)],
                        np.float64)


class AlwaysOn(AvailabilityTrace):
    """The pre-dynamics behavior: the trace never gates anyone."""

    trivial = True

    def prob(self, cid: int, t: float) -> float:
        return 1.0

    def prob_batch(self, cids: np.ndarray, t: float) -> np.ndarray:
        return np.ones(len(np.asarray(cids)), np.float64)


@dataclasses.dataclass
class DiurnalTrace(AvailabilityTrace):
    """Sinusoidal online/offline cycle: availability swings between
    ``low`` and ``high`` over ``period`` virtual seconds. Each client
    gets a phase in ``[0, phase_spread)`` drawn at bind time from the
    dynamics stream (``phase_spread=0`` puts the whole fleet on one
    clock — the classic correlated diurnal dip)."""

    period: float = 86_400.0
    low: float = 0.1
    high: float = 1.0
    phase_spread: float = 1.0
    phases: Optional[np.ndarray] = None   # (num_clients,) in [0, 1)

    def __post_init__(self):
        if not 0.0 <= self.low <= self.high <= 1.0:
            raise ValueError(f"need 0 <= low <= high <= 1, got "
                             f"[{self.low}, {self.high}]")
        if self.period <= 0:
            raise ValueError("period must be positive")

    def bind(self, num_clients: int,
             rng: np.random.Generator) -> "DiurnalTrace":
        if self.phases is not None:
            if len(self.phases) != num_clients:
                raise ValueError(f"explicit phases have length "
                                 f"{len(self.phases)}, fleet has "
                                 f"{num_clients} clients")
            return self
        return dataclasses.replace(
            self, phases=rng.random(num_clients) * self.phase_spread)

    def prob(self, cid: int, t: float) -> float:
        ph = float(self.phases[cid]) if self.phases is not None else 0.0
        s = math.sin(2.0 * math.pi * (t / self.period + ph))
        return self.low + (self.high - self.low) * 0.5 * (1.0 + s)

    def prob_batch(self, cids: np.ndarray, t: float) -> np.ndarray:
        cids = np.asarray(cids)
        ph = self.phases[cids] if self.phases is not None \
            else np.zeros(len(cids))
        s = np.sin(2.0 * np.pi * (t / self.period + ph))
        return self.low + (self.high - self.low) * 0.5 * (1.0 + s)


@dataclasses.dataclass
class StepTrace(AvailabilityTrace):
    """Piecewise-constant availability: ``values[..., k]`` holds on
    ``[times[k], times[k+1])``. ``times`` must start at 0 and ascend;
    ``values`` is ``(T,)`` (shared by the fleet) or ``(num_clients, T)``
    (per-client traces). The last value holds forever."""

    times: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        self.times = np.asarray(self.times, np.float64)
        self.values = np.asarray(self.values, np.float64)
        if self.times.ndim != 1 or self.times[0] != 0.0 \
                or np.any(np.diff(self.times) <= 0):
            raise ValueError("times must be 1-D, start at 0 and be "
                             "strictly increasing")
        if self.values.shape[-1] != len(self.times):
            raise ValueError(f"values' last axis ({self.values.shape[-1]}) "
                             f"must match times ({len(self.times)})")
        if np.any(self.values < 0) or np.any(self.values > 1):
            raise ValueError("availability values must lie in [0, 1]")

    def bind(self, num_clients: int,
             rng: np.random.Generator) -> "StepTrace":
        if self.values.ndim == 2 and self.values.shape[0] != num_clients:
            raise ValueError(f"per-client trace has {self.values.shape[0]} "
                             f"rows, fleet has {num_clients} clients")
        return self

    def prob(self, cid: int, t: float) -> float:
        k = int(np.searchsorted(self.times, t, side="right")) - 1
        k = max(k, 0)
        if self.values.ndim == 2:
            return float(self.values[cid, k])
        return float(self.values[k])

    def prob_batch(self, cids: np.ndarray, t: float) -> np.ndarray:
        cids = np.asarray(cids)
        k = max(int(np.searchsorted(self.times, t, side="right")) - 1, 0)
        if self.values.ndim == 2:
            return self.values[cids, k]
        return np.full(len(cids), self.values[k])


# ---------------------------------------------------------------------------
# Correlated region shocks (the topology-aware failure mode)


@dataclasses.dataclass(frozen=True)
class RegionShocks:
    """Poisson process of correlated edge-region outages.

    Inter-arrival times are exponential with mean ``every`` virtual
    seconds; each shock picks one region uniformly and scales every
    member's availability by ``residual`` for ``duration`` seconds
    (``residual=0`` is a full cell-tower outage). Requires a topology
    (``GridConfig.topology``) — a flat grid has no regions to down."""

    every: float = 2_000.0
    duration: float = 300.0
    residual: float = 0.0

    def __post_init__(self):
        if self.every <= 0 or self.duration <= 0:
            raise ValueError("RegionShocks.every/duration must be positive")
        if not 0.0 <= self.residual <= 1.0:
            raise ValueError(f"residual={self.residual} must lie in [0, 1]")

    def bind(self, num_regions: int, rng: np.random.Generator,
             tracer=None) -> "BoundShocks":
        return BoundShocks(self, num_regions, rng, tracer=tracer)


class BoundShocks:
    """A RegionShocks config bound to its own RNG stream (a spawn child
    of the device stream — zero parent draws, like ``sim/faults.py``).

    The outage process is advanced *lazily* at monotone virtual time:
    each shock consumes exactly two draws (a uniform region pick and the
    next exponential gap; the first gap is drawn at bind), so the stream
    position depends only on how far the clock has advanced — never on
    cohort outcomes — and a snapshot (``state_dict``/``load_state``)
    restores the process bit-exactly."""

    def __init__(self, cfg: RegionShocks, num_regions: int,
                 rng: np.random.Generator, tracer=None):
        if num_regions < 1:
            raise ValueError("shocks need >= 1 region")
        self.cfg = cfg
        self.num_regions = int(num_regions)
        self.rng = rng
        self.tracer = tracer
        self.fired = 0
        # every outage ever fired, as [region, start, end] — kept whole
        # (runs are finite) so tests and ops can audit the shock history
        self.outages: List[List[float]] = []
        # the still-live subset, pruned as the (monotone) clock advances
        # — factor queries scan only this, so dense shock schedules stay
        # O(active), not O(history)
        self._active: List[List[float]] = []
        self._t_last = 0.0
        self.next_t = float(rng.exponential(cfg.every))

    def _advance(self, t: float) -> None:
        while self.next_t <= t:
            start = self.next_t
            region = int(self.rng.integers(0, self.num_regions))
            outage = [float(region), start, start + self.cfg.duration]
            self.outages.append(outage)
            self._active.append(outage)
            self.fired += 1
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.instant("shock", start, region=region,
                                    duration=float(self.cfg.duration),
                                    residual=float(self.cfg.residual),
                                    until=start + self.cfg.duration)
            self.next_t = start + float(self.rng.exponential(self.cfg.every))
        if t > self._t_last:
            self._t_last = t
            if self._active:
                self._active = [o for o in self._active if o[2] > t]

    def factor(self, regions: np.ndarray, t: float) -> np.ndarray:
        """Per-member availability multipliers for a cohort whose members
        live in ``regions`` (int array), queried at virtual time ``t``."""
        self._advance(t)
        regions = np.asarray(regions)
        f = np.ones(len(regions), np.float64)
        for r, start, end in self._active:
            if start <= t < end:
                f[regions == int(r)] *= self.cfg.residual
        return f

    def factor_one(self, region: int, t: float) -> float:
        """Scalar form for the async scheduler's per-dispatch check."""
        self._advance(t)
        f = 1.0
        for r, start, end in self._active:
            if int(r) == int(region) and start <= t < end:
                f *= self.cfg.residual
        return f

    def state_dict(self) -> Dict[str, Any]:
        return {"rng": self.rng.bit_generator.state,
                "next_t": float(self.next_t),
                "fired": int(self.fired),
                "t_last": float(self._t_last),
                "outages": [list(o) for o in self.outages]}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.next_t = float(state["next_t"])
        self.fired = int(state["fired"])
        self._t_last = float(state.get("t_last", 0.0))
        self.outages = [list(o) for o in state["outages"]]
        self._active = [o for o in self.outages if o[2] > self._t_last]


# ---------------------------------------------------------------------------
# The config the grid consumes


@dataclasses.dataclass
class DynamicsConfig:
    """Fleet-wide device dynamics: the default link model (per-profile
    ``DeviceProfile.link_model`` overrides it client by client), the
    availability trace, correlated region shocks (needs a topology), and
    the async scheduler's redispatch backoff."""

    link: LinkModel = dataclasses.field(default_factory=LinkModel)
    availability: AvailabilityTrace = dataclasses.field(
        default_factory=AlwaysOn)
    # correlated edge-region outages (sim/topology.py must be active);
    # bound by the grid against the topology with its own spawned stream
    shocks: Optional[RegionShocks] = None
    # async: base virtual seconds to wait before re-trying dispatch when
    # no sampled client passes the availability check (the trace has the
    # fleet dark); sync rounds just close empty at their deadline. The
    # async wait escalates exponentially per consecutive retry
    # (base * growth^k, capped, with deterministic jitter — see
    # BoundDynamics.backoff_seconds); the sync dark-window re-poll uses
    # the flat base.
    redispatch_backoff: float = 30.0
    backoff_growth: float = 2.0           # escalation per consecutive retry
    backoff_cap: float = 1_920.0          # ceiling on one backoff wait
    # async: virtual-seconds budget for one *continuous* dark window —
    # past it the scheduler raises instead of retrying forever (replaces
    # the old raw 100k-consecutive-retry guard)
    retry_budget: float = 1e7

    @property
    def trivial(self) -> bool:
        return (self.link.trivial and self.availability.trivial
                and self.shocks is None)

    def bind(self, fleet, rng: np.random.Generator) -> "BoundDynamics":
        st = fleet.state
        link_sigma = np.where(st.has_link, st.link_sigma,
                              self.link.jitter_sigma)
        link_rtt = np.where(st.has_link, st.link_rtt,
                            self.link.rtt_seconds)
        return BoundDynamics(
            link_sigma=link_sigma, link_rtt=link_rtt,
            trace=self.availability.bind(len(fleet), rng),
            redispatch_backoff=float(self.redispatch_backoff),
            backoff_growth=float(self.backoff_growth),
            backoff_cap=float(self.backoff_cap),
            retry_budget=float(self.retry_budget))


@dataclasses.dataclass(frozen=True, eq=False)
class BoundDynamics:
    """A DynamicsConfig resolved against one fleet: per-client link
    parameters as ``(num_clients,)`` arrays (profile override or the
    config default — no per-client link objects) and a bound trace.
    This is what the schedulers consume."""

    link_sigma: np.ndarray
    link_rtt: np.ndarray
    trace: AvailabilityTrace
    redispatch_backoff: float
    backoff_growth: float = 2.0
    backoff_cap: float = 1_920.0
    retry_budget: float = 1e7

    # jitter the k-th consecutive backoff by a *deterministic* factor in
    # [0.75, 1.25): the golden-ratio low-discrepancy sequence de-phases
    # parked dispatch slots without consuming a single PRNG draw (the
    # zero-draw hygiene rule — backoffs must not move any stream)
    _JITTER_STEP = 0.6180339887498949

    def backoff_seconds(self, k: int) -> float:
        """Virtual seconds to park the k-th consecutive failed dispatch:
        capped exponential escalation with deterministic jitter."""
        base = min(self.redispatch_backoff * self.backoff_growth ** k,
                   self.backoff_cap)
        return base * (0.75 + 0.5 * ((k * self._JITTER_STEP) % 1.0))

    def link_for(self, cid: int) -> LinkModel:
        """Lazy per-client view over the link-parameter arrays."""
        i = int(cid)
        return LinkModel(jitter_sigma=float(self.link_sigma[i]),
                         rtt_seconds=float(self.link_rtt[i]))

    def prob(self, cid: int, t: float) -> float:
        return self.trace.prob(cid, t)

    def prob_batch(self, cids: np.ndarray, t: float) -> np.ndarray:
        return self.trace.prob_batch(cids, t)

    def round_trip_seconds(self, profile, down_bytes: int, up_bytes: int,
                           compute_seconds: float, cid: int,
                           z_down: float, z_up: float) -> float:
        """One full client round trip under the stochastic link: jittered
        download + compute + jittered upload. ``z_down``/``z_up`` are the
        caller's N(0,1) draws from the dynamics stream."""
        lm = self.link_for(cid)
        return (lm.transfer_seconds(down_bytes, profile.downlink_bps, z_down)
                + compute_seconds * profile.compute_multiplier
                + lm.transfer_seconds(up_bytes, profile.uplink_bps, z_up))

    def round_trip_components_batch(self, st, cids: np.ndarray, down_bytes,
                                    up_bytes, compute_seconds,
                                    z_down: np.ndarray, z_up: np.ndarray):
        """The three phase terms of :meth:`round_trip_seconds_batch` —
        ``(down, comp, up)`` arrays whose left-to-right sum is exactly
        the round-trip time. The tracer records them on dispatch spans
        (schema v4 ``t_down``/``t_comp``/``t_up``) so ``obs/analyze.py``
        can split a span into phases without re-deriving link models.
        Consumes zero RNG draws: ``z_down``/``z_up`` are the caller's
        already-drawn N(0,1) values."""
        cids = np.asarray(cids)
        sig = self.link_sigma[cids]
        rtt = self.link_rtt[cids]
        down = (rtt + (np.asarray(down_bytes, np.float64)
                       / st.downlink_bps[cids])
                * np.exp(sig * z_down - 0.5 * sig * sig))
        up = (rtt + (np.asarray(up_bytes, np.float64) / st.uplink_bps[cids])
              * np.exp(sig * z_up - 0.5 * sig * sig))
        comp = (np.asarray(compute_seconds, np.float64)
                * st.compute_multiplier[cids])
        return down, comp, up

    def round_trip_seconds_batch(self, st, cids: np.ndarray, down_bytes,
                                 up_bytes, compute_seconds,
                                 z_down: np.ndarray,
                                 z_up: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`round_trip_seconds` over a cohort — one
        array op per round instead of one LinkModel call per member.
        ``st`` is the fleet's :class:`~repro_torch.sim.devices.FleetState`;
        the float64 expression matches the scalar path's association
        elementwise."""
        down, comp, up = self.round_trip_components_batch(
            st, cids, down_bytes, up_bytes, compute_seconds, z_down, z_up)
        return down + comp + up


# ---------------------------------------------------------------------------
# Presets + resolution


def _preset_diurnal() -> DynamicsConfig:
    # mobile links jitter ~25% transfer to transfer with a 200ms floor;
    # availability swings 10%..100% over a (virtual) 4000-second day —
    # short enough that example/test runs see several cycles
    return DynamicsConfig(
        link=LinkModel(jitter_sigma=0.25, rtt_seconds=0.2),
        availability=DiurnalTrace(period=4_000.0, low=0.1, high=1.0))


def _preset_jitter() -> DynamicsConfig:
    return DynamicsConfig(link=LinkModel(jitter_sigma=0.25, rtt_seconds=0.2))


# "static" is NOT an entry here: it is intercepted by resolve_dynamics
# as the hard off-switch (None even over profile link models) — a dict
# entry would carry the wrong semantics if ever reached via
# FLEET_DEFAULT_DYNAMICS indirection
DYNAMICS_PRESETS: Dict[str, callable] = {
    "jitter": _preset_jitter,
    "diurnal": _preset_diurnal,
}

# fleet presets that imply a dynamics preset when GridConfig.dynamics is
# left at None (the new preset names opt in; existing fleets stay static)
FLEET_DEFAULT_DYNAMICS: Dict[str, str] = {
    "pareto-mobile-diurnal": "diurnal",
}


def resolve_dynamics(spec: Union[None, str, DynamicsConfig],
                     fleet) -> Optional[DynamicsConfig]:
    """GridConfig.dynamics -> DynamicsConfig or None (trivial).

    ``None`` defers to the fleet preset's default (static for every
    pre-dynamics preset); a name looks up :data:`DYNAMICS_PRESETS`; a
    config passes through. A config that is trivial AND rides a fleet
    with no per-profile link models resolves to ``None`` — the signal
    for the schedulers to take the exact pre-dynamics code paths.

    ``"static"`` is a hard off-switch: it resolves to ``None`` even on
    fleets whose profiles carry link models, so it is always the true
    static-link/always-on A/B control (to keep per-profile jitter while
    dropping the trace, pass a ``DynamicsConfig`` explicitly — an
    explicit config honors profile link models).
    """
    if spec == "static":
        return None
    if spec is None:
        name = FLEET_DEFAULT_DYNAMICS.get(getattr(fleet, "name", None))
        cfg = DYNAMICS_PRESETS[name]() if name else None
    elif isinstance(spec, str):
        try:
            cfg = DYNAMICS_PRESETS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown dynamics preset {spec!r}; options: "
                f"{sorted(DYNAMICS_PRESETS) + ['static']}") from None
    elif isinstance(spec, DynamicsConfig):
        cfg = spec
    else:
        raise TypeError(f"dynamics must be None, a preset name or a "
                        f"DynamicsConfig, got {type(spec).__name__}")
    state = getattr(fleet, "state", None)
    if state is not None:
        has_profile_links = bool(np.any(state.has_link))
    else:
        has_profile_links = any(getattr(p, "link_model", None) is not None
                                for p in fleet.profiles)
    if cfg is None and not has_profile_links:
        return None
    if cfg is None:
        cfg = DynamicsConfig()
    if cfg.trivial and not has_profile_links:
        return None
    return cfg
