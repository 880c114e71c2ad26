"""Client population model for the simulation grid.

The fleet is stored as a :class:`FleetState` **struct-of-arrays**: one
numpy array per device attribute (link bandwidths, compute multiplier,
availability, dropout, per-device link-model parameters, tier id) rather
than one Python object per client. At 10^6 clients the arrays cost a few
MB and every fleet-wide query (cohort RTT estimates, capability scoring,
availability screens) is one vectorized op; :class:`DeviceProfile` is
kept as a **lazy per-index view** for callers that want one device.

Profiles are sampled from named **fleet presets**:

``uniform``
    Every client identical, on the paper's measured cross-device links
    (download 0.75 MB/s, upload 0.25 MB/s; Wang et al. 2021b), always
    available, never dropping. The grid in this fleet + sync mode
    reproduces ``fl.runtime.run_federated`` bit-for-bit.

``pareto-mobile``
    Cross-device phones: heavy-tailed (Pareto) link speeds below the
    reference links, log-normal compute multipliers, 80% availability,
    10% mid-round dropout — the regime where straggler deadlines,
    over-selection and buffered async aggregation matter.

``pareto-mobile-diurnal``
    The same phones under device *dynamics* (``sim/dynamics.py``): every
    profile carries a stochastic :class:`~repro_torch.sim.dynamics.LinkModel`
    (per-transfer log-normal jitter over its Pareto base bandwidth plus
    an RTT latency floor), and the grid defaults the fleet onto the
    ``diurnal`` availability trace — links jitter and the fleet follows
    online/offline cycles at virtual time.

``cross-silo``
    A handful of datacenter silos: ~1 Gb/s symmetric links, near-uniform
    compute, always available.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import comm
from repro_torch.sim import dynamics as dyn_lib

MB = 1024.0 * 1024.0


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    downlink_bps: float          # bytes/second the server->client link moves
    uplink_bps: float            # bytes/second client->server
    compute_multiplier: float    # local-step time multiplier (1.0 = reference)
    availability: float = 1.0    # P(online when sampled)
    dropout: float = 0.0         # P(drops mid-round after being dispatched)
    # per-device stochastic link (sim/dynamics.py): overrides the
    # DynamicsConfig's fleet-wide default for this client's transfers;
    # None = use the fleet default (static unless dynamics are on)
    link_model: Optional[dyn_lib.LinkModel] = None

    def round_trip_seconds(self, down_bytes: int, up_bytes: int,
                           compute_seconds: float) -> float:
        """Virtual time for one full client round trip: download the
        trainable payload, run local steps, upload the delta."""
        return (down_bytes / self.downlink_bps
                + compute_seconds * self.compute_multiplier
                + up_bytes / self.uplink_bps)


@dataclasses.dataclass
class FleetState:
    """Struct-of-arrays device state, one ``(num_clients,)`` array per
    attribute. ``link_sigma``/``link_rtt`` hold the per-device
    :class:`~repro_torch.sim.dynamics.LinkModel` parameters where ``has_link``
    is True (0.0 elsewhere); ``tier`` is filled in by
    :func:`assign_tiers` when a trainability plan is active."""

    downlink_bps: np.ndarray
    uplink_bps: np.ndarray
    compute_multiplier: np.ndarray
    availability: np.ndarray
    dropout: np.ndarray
    link_sigma: np.ndarray
    link_rtt: np.ndarray
    has_link: np.ndarray                 # bool: per-device link override?
    tier: Optional[np.ndarray] = None    # (num_clients,) int32 or None

    def __post_init__(self):
        n = len(self.downlink_bps)
        for name in ("downlink_bps", "uplink_bps", "compute_multiplier",
                     "availability", "dropout", "link_sigma", "link_rtt"):
            arr = np.ascontiguousarray(getattr(self, name), np.float64)
            if arr.shape != (n,):
                raise ValueError(f"FleetState.{name} has shape {arr.shape}, "
                                 f"expected ({n},)")
            setattr(self, name, arr)
        self.has_link = np.ascontiguousarray(self.has_link, bool)
        if self.has_link.shape != (n,):
            raise ValueError("FleetState.has_link shape mismatch")

    @classmethod
    def of(cls, num_clients: int, *, downlink_bps, uplink_bps,
           compute_multiplier=1.0, availability=1.0, dropout=0.0,
           link_sigma=0.0, link_rtt=0.0, has_link=False) -> "FleetState":
        """Build a state from scalars or arrays (scalars broadcast)."""
        n = int(num_clients)
        full = lambda v, dt=np.float64: np.full(n, v, dt) \
            if np.ndim(v) == 0 else np.asarray(v, dt)
        return cls(downlink_bps=full(downlink_bps),
                   uplink_bps=full(uplink_bps),
                   compute_multiplier=full(compute_multiplier),
                   availability=full(availability),
                   dropout=full(dropout),
                   link_sigma=full(link_sigma),
                   link_rtt=full(link_rtt),
                   has_link=full(has_link, bool))

    @classmethod
    def from_profiles(cls, profiles: Sequence[DeviceProfile]) -> "FleetState":
        links = [getattr(p, "link_model", None) for p in profiles]
        return cls(
            downlink_bps=np.array([p.downlink_bps for p in profiles],
                                  np.float64),
            uplink_bps=np.array([p.uplink_bps for p in profiles], np.float64),
            compute_multiplier=np.array(
                [p.compute_multiplier for p in profiles], np.float64),
            availability=np.array([p.availability for p in profiles],
                                  np.float64),
            dropout=np.array([p.dropout for p in profiles], np.float64),
            link_sigma=np.array([lm.jitter_sigma if lm else 0.0
                                 for lm in links], np.float64),
            link_rtt=np.array([lm.rtt_seconds if lm else 0.0
                               for lm in links], np.float64),
            has_link=np.array([lm is not None for lm in links], bool))

    def __len__(self) -> int:
        return len(self.downlink_bps)

    def profile(self, cid: int) -> DeviceProfile:
        """Lazy per-index view: materialize one DeviceProfile."""
        i = int(cid)
        lm = dyn_lib.LinkModel(jitter_sigma=float(self.link_sigma[i]),
                               rtt_seconds=float(self.link_rtt[i])) \
            if self.has_link[i] else None
        return DeviceProfile(downlink_bps=float(self.downlink_bps[i]),
                             uplink_bps=float(self.uplink_bps[i]),
                             compute_multiplier=float(
                                 self.compute_multiplier[i]),
                             availability=float(self.availability[i]),
                             dropout=float(self.dropout[i]),
                             link_model=lm)

    def round_trip_seconds(self, down_bytes, up_bytes, compute_seconds,
                           cids: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized static round-trip times; any of the payload/compute
        args may be scalars or per-client arrays. Elementwise this is
        exactly ``DeviceProfile.round_trip_seconds`` (same float64 ops in
        the same association)."""
        if cids is None:
            dl, ul, cm = (self.downlink_bps, self.uplink_bps,
                          self.compute_multiplier)
        else:
            idx = np.asarray(cids)
            dl, ul, cm = (self.downlink_bps[idx], self.uplink_bps[idx],
                          self.compute_multiplier[idx])
        return (np.asarray(down_bytes, np.float64) / dl
                + np.asarray(compute_seconds, np.float64) * cm
                + np.asarray(up_bytes, np.float64) / ul)

    def capability_scores(self) -> np.ndarray:
        """Vectorized :func:`capability_score` over the whole fleet."""
        link = (self.downlink_bps * self.uplink_bps) ** 0.5
        return link / np.maximum(self.compute_multiplier, 1e-9)


class _ProfileView(Sequence):
    """Lazy sequence of DeviceProfile views over a FleetState — supports
    ``len``, indexing (int or slice) and iteration without ever holding
    N profile objects at once."""

    def __init__(self, state: FleetState):
        self._state = state

    def __len__(self) -> int:
        return len(self._state)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._state.profile(j)
                    for j in range(*i.indices(len(self._state)))]
        n = len(self._state)
        j = int(i)
        if j < 0:
            j += n
        if not 0 <= j < n:
            raise IndexError(i)
        return self._state.profile(j)


class Fleet:
    """A named client population. Construct from a ``FleetState``
    (preferred at scale) or from an explicit profile list (the pre-SoA
    API, kept for tests and hand-built fleets); ``.profiles`` is always
    a lazy per-index view over the arrays."""

    def __init__(self, name: str,
                 profiles: Optional[Sequence[DeviceProfile]] = None,
                 state: Optional[FleetState] = None):
        if (profiles is None) == (state is None):
            raise ValueError("Fleet needs exactly one of profiles= / state=")
        self.name = name
        self.state = state if state is not None \
            else FleetState.from_profiles(list(profiles))

    def __repr__(self) -> str:
        return f"Fleet(name={self.name!r}, clients={len(self)})"

    @property
    def profiles(self) -> _ProfileView:
        return _ProfileView(self.state)

    def __len__(self) -> int:
        return len(self.state)

    def profile(self, cid: int) -> DeviceProfile:
        return self.state.profile(cid)

    def round_trip_seconds(self, cid: int, down_bytes: int, up_bytes: int,
                           compute_seconds: float) -> float:
        return self.profile(cid).round_trip_seconds(down_bytes, up_bytes,
                                                    compute_seconds)

    def summary(self) -> Dict[str, float]:
        st = self.state
        return {
            "clients": float(len(st)),
            "downlink_mbps_median": float(np.median(st.downlink_bps)) / MB,
            "uplink_mbps_median": float(np.median(st.uplink_bps)) / MB,
            "compute_mult_p90": float(np.quantile(st.compute_multiplier,
                                                  0.9)),
            "availability_mean": float(np.mean(st.availability)),
        }


# ---------------------------------------------------------------------------
# Presets (each builds a FleetState directly — no per-client objects;
# the RNG call sequences are byte-identical to the old per-object
# builders, so seeded fleets are unchanged)


def _uniform(num_clients: int, rng: np.random.Generator) -> FleetState:
    return FleetState.of(num_clients,
                         downlink_bps=comm.DOWNLINK_MBPS * MB,
                         uplink_bps=comm.UPLINK_MBPS * MB,
                         compute_multiplier=1.0)


def _pareto_mobile(num_clients: int, rng: np.random.Generator) -> FleetState:
    # Pareto(alpha) slowdown factors >= 1 -> bandwidths at or below the
    # reference links, with a heavy tail of very slow phones.
    slow_dl = 1.0 + rng.pareto(2.5, num_clients)
    slow_ul = 1.0 + rng.pareto(2.5, num_clients)
    cmult = np.clip(rng.lognormal(0.25, 0.5, num_clients), 0.5, 10.0)
    return FleetState.of(num_clients,
                         downlink_bps=comm.DOWNLINK_MBPS * MB / slow_dl,
                         uplink_bps=comm.UPLINK_MBPS * MB / slow_ul,
                         compute_multiplier=cmult,
                         availability=0.8, dropout=0.1)


def _pareto_mobile_diurnal(num_clients: int,
                           rng: np.random.Generator) -> FleetState:
    # the pareto-mobile fleet, each phone with its own stochastic link:
    # jitter sigma drawn per device (flaky phones are flakier), one
    # shared 200ms latency floor. The grid pairs this preset with the
    # "diurnal" availability trace by default (dynamics.py).
    base = _pareto_mobile(num_clients, rng)
    sigmas = rng.uniform(0.1, 0.4, num_clients)
    return dataclasses.replace(base, link_sigma=sigmas,
                               link_rtt=np.full(num_clients, 0.2),
                               has_link=np.ones(num_clients, bool))


def _cross_silo(num_clients: int, rng: np.random.Generator) -> FleetState:
    bw = 125.0 * MB  # ~1 Gb/s symmetric
    cmult = rng.uniform(0.8, 1.2, num_clients)
    return FleetState.of(num_clients, downlink_bps=bw, uplink_bps=bw,
                         compute_multiplier=cmult)


# ---------------------------------------------------------------------------
# Capability -> trainability tier assignment (core/plan.py TrainPlan)


def capability_score(p: DeviceProfile) -> float:
    """Scalar capability of a device: geometric-mean link speed over the
    compute slowdown. Higher = more capable = lower (more-trainable)
    tier. Uplink dominates the FedPT round trip (0.25 vs 0.75 MB/s
    reference links), and slow compute delays the upload just the same,
    so both enter the score. The fleet-wide version is the vectorized
    :meth:`FleetState.capability_scores`."""
    link = (p.downlink_bps * p.uplink_bps) ** 0.5
    return link / max(p.compute_multiplier, 1e-9)


def quantile_tiers(scores: np.ndarray, n_tiers: int) -> np.ndarray:
    """Quantile-split scalar capability scores (higher = more capable)
    into ``n_tiers`` equal buckets, tier 0 = most capable. Tier t's
    lower boundary sits at quantile ``1 - (t+1)/n_tiers``; the
    strictly-below comparison sends boundary ties upward, so a
    homogeneous score vector lands entirely in tier 0.

    Shared by the static profile split below and the online re-tiering
    of ``sim/selection.AdaptiveCapabilityPolicy`` (which feeds it
    ``1 / ema_observed_rtt`` instead of profile scores)."""
    scores = np.asarray(scores, np.float64)
    cuts = np.quantile(scores, [1.0 - (t + 1) / n_tiers
                                for t in range(n_tiers - 1)])
    return (scores[:, None] < cuts[None, :]).sum(1).astype(np.int32)


def assign_tiers(fleet: Fleet, n_tiers: int,
                 assignment="capability") -> np.ndarray:
    """(num_clients,) int32 tier index per client, tier 0 = most capable.

    ``assignment`` is ``"capability"`` (quantile-split the fleet's
    capability scores into ``n_tiers`` equal buckets; ties break toward
    the more capable tier, so a homogeneous fleet lands entirely in
    tier 0 — i.e. the plan's ``full`` tier), a callable
    ``profile -> tier index``, or an explicit per-client index sequence.
    The result is also recorded on ``fleet.state.tier``.
    """
    n = len(fleet)
    if callable(assignment):
        tiers = np.asarray([int(assignment(p)) for p in fleet.profiles],
                           np.int32)
    elif isinstance(assignment, str):
        if assignment != "capability":
            raise ValueError(f"unknown tier assignment {assignment!r}; "
                             "options: 'capability', a callable, or an "
                             "explicit per-client index array")
        tiers = quantile_tiers(fleet.state.capability_scores(), n_tiers)
    else:
        tiers = np.asarray(assignment, np.int32)
        if tiers.shape != (n,):
            raise ValueError(f"explicit tier assignment has shape "
                             f"{tiers.shape}, fleet has {n} clients")
    if tiers.size and (tiers.min() < 0 or tiers.max() >= n_tiers):
        raise ValueError(f"tier indices must be in [0, {n_tiers}); got "
                         f"range [{tiers.min()}, {tiers.max()}]")
    fleet.state.tier = tiers
    return tiers


FLEET_PRESETS: Dict[str, Callable[[int, np.random.Generator],
                                  FleetState]] = {
    "uniform": _uniform,
    "pareto-mobile": _pareto_mobile,
    "pareto-mobile-diurnal": _pareto_mobile_diurnal,
    "cross-silo": _cross_silo,
}


def make_fleet(num_clients: int, preset: Union[str, Fleet] = "uniform",
               seed: int = 0) -> Fleet:
    """Sample a client population from a named preset (a Fleet instance
    passes through unchanged)."""
    if isinstance(preset, Fleet):
        return preset
    try:
        builder = FLEET_PRESETS[preset]
    except KeyError:
        raise ValueError(f"unknown fleet preset {preset!r}; "
                         f"options: {sorted(FLEET_PRESETS)}") from None
    rng = np.random.default_rng(seed)
    return Fleet(name=preset, state=builder(num_clients, rng))
