"""Cohort-selection policies for the simulation grid.

A plain grid hard-codes *who trains*: sync cohorts are a uniform
``syn.sample_cohort`` draw and async dispatch a uniform
``rng.integers``. At cross-device scale the server's choice of cohort is
a first-class control knob (the FL communication-practicality survey
names client sampling under dynamic availability as the gap between
simulated and deployed comm savings; FedPLT makes heterogeneity-aware
client/layer assignment the core mechanism). This module makes the
choice pluggable:

``uniform``
    The exact plain-grid behavior — byte-identical RNG consumption, so the
    default grid reproduces the pre-selection traces bit for bit.

``bandwidth-aware``
    Inclusion probability proportional to the *inverse* estimated round
    trip (fast phones train more often), with first-order
    Horvitz-Thompson importance weights ``(1/N) / p_i`` fed into the
    existing aggregation weights so the aggregate stays an unbiased
    estimate of the uniform-cohort update. Under DP the round engine
    forces uniform-among-participants weighting with a fixed
    denominator (that is what calibrates sigma), so the correction is
    dropped there — selection bias under DP is documented, not
    silently corrected (see README).

``tier-rotation``
    FedPLT-style coverage rotation over a ``core/plan.py`` TrainPlan:
    each round the tier->client assignment rotates by one, so every
    client group cycles through every tier's block-group and no block
    is starved of its stragglers' data distribution. Sampling stays
    uniform; only the per-round tier map changes.

``adaptive-capability``
    Closes the ROADMAP item: re-runs the capability->tier split online
    from an EMA of *observed* round-trip times (the scheduler reports
    every completed upload's RTT back via ``observe``), re-tiering the
    fleet every ``refit_every`` rounds with
    ``sim/devices.quantile_tiers`` — devices whose links degraded get
    demoted to lighter tiers even if their static profile looked fast.

A policy is bound to one run (``bind`` resets all state); the grid
resolves names through :func:`resolve_policy` and threads the policy
through both scheduling modes — sync cohorts, async dispatch, the
per-round tier map, aggregation-weight corrections, and observed-RTT
feedback.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.data import synthetic as syn
from repro_torch.sim import devices as dev_lib


class SelectionPolicy:
    """Base policy == ``uniform``: the exact pre-selection behavior.

    The grid calls, in order:

    * ``bind(...)`` once per run (fleet, compiled plan, static tier
      map, per-client RTT estimates);
    * sync: ``select_cohort(data_rng, m)`` per round, then
      ``cohort_weights(sel)`` for the kept cohort slots;
    * async: ``sample_cid(dev_rng)`` per dispatch, ``client_weight``
      per completed client;
    * ``current_tiers()`` whenever a tier map is needed (rotation and
      adaptive policies return a map that changes over rounds);
    * ``observe(cid, rtt)`` for every upload the server actually saw;
    * ``end_round(r)`` after each server update (sync round or async
      flush).

    RNG discipline: ``select_cohort`` draws from the grid's data stream
    and ``sample_cid`` from the device stream, exactly like the plain
    grid's inlined calls — the uniform policy consumes both streams
    byte-identically.
    """

    name = "uniform"
    # trivial policies are skipped for weight corrections entirely, so
    # the default path multiplies nothing into the plain-grid weights
    trivial = True

    def bind(self, *, fleet: dev_lib.Fleet, num_clients: int, cplan=None,
             tiers: Optional[np.ndarray] = None,
             rtt_estimate: Optional[np.ndarray] = None) -> None:
        self.fleet = fleet
        self.num_clients = int(num_clients)
        self.cplan = cplan
        self._tiers = tiers
        self.rtt_estimate = rtt_estimate

    # -- sampling ---------------------------------------------------------

    def select_cohort(self, rng: np.random.Generator, m: int) -> np.ndarray:
        return syn.sample_cohort(rng, self.num_clients, m)

    def sample_cid(self, rng: np.random.Generator) -> int:
        return int(rng.integers(0, self.num_clients))

    # -- importance weights ----------------------------------------------

    def cohort_weights(self, cids: np.ndarray) -> Optional[np.ndarray]:
        """Per-cohort-slot multiplier into the aggregation weights
        (None = uniform, multiply nothing)."""
        return None

    def client_weight(self, cid: int) -> float:
        return 1.0

    # -- feedback ---------------------------------------------------------

    def observe(self, cid: int, rtt_seconds: float) -> None:
        pass

    def end_round(self, round_idx: int) -> None:
        pass

    # -- tier map ---------------------------------------------------------

    def current_tiers(self) -> Optional[np.ndarray]:
        return self._tiers

    # -- checkpointing -----------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable mutable state for mid-run checkpoints.
        Uniform and bandwidth-aware policies carry no mutable state
        beyond what ``bind`` derives, so the base blob is just the
        policy name (used as a resume-time consistency check)."""
        return {"name": self.name}

    def load_state(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(
                f"checkpointed selection policy {state.get('name')!r} "
                f"does not match this run's {self.name!r} — resume with "
                "the same GridConfig.selection")


class UniformPolicy(SelectionPolicy):
    pass


class BandwidthAwarePolicy(SelectionPolicy):
    """Inclusion probability proportional to ``(1/rtt_est)^temperature``,
    with slow scores floored at ``1/max_tilt`` of the fastest so the
    total inclusion spread stays bounded — a heavy-tailed fleet cannot
    starve its slow decile entirely, and one pathological straggler
    cannot collapse the tilt among the healthy phones (flooring the
    slow end preserves the fast end's relative differences; capping
    against the slowest would flatten everyone toward uniform).
    Importance weights are the first-order Horvitz-Thompson correction
    ``(1/N) / p_i`` (unit mean under the sampling distribution): a fast
    phone sampled 4x as often counts 1/4 as much per appearance,
    keeping the aggregate unbiased for the uniform-cohort update."""

    name = "bandwidth-aware"
    trivial = False

    def __init__(self, temperature: float = 1.0, max_tilt: float = 10.0):
        if temperature <= 0 or max_tilt < 1.0:
            raise ValueError("need temperature > 0 and max_tilt >= 1")
        self.temperature = float(temperature)
        self.max_tilt = float(max_tilt)

    def bind(self, **kw) -> None:
        super().bind(**kw)
        if self.rtt_estimate is None:
            raise ValueError("bandwidth-aware selection needs per-client "
                             "round-trip estimates")
        score = (1.0 / np.maximum(self.rtt_estimate, 1e-12)
                 ) ** self.temperature
        score = np.maximum(score, score.max() / self.max_tilt)
        self.probs = score / score.sum()
        # first-order HT weight: uniform inclusion is 1/N, ours is p_i
        self.weights = (1.0 / self.num_clients) / self.probs
        # inverse-CDF sampling: async dispatch (and its availability
        # redraw loop) draws per event — keep it O(log N), not the
        # O(N) rng.choice path
        self._cdf = np.cumsum(self.probs)
        self._cdf[-1] = 1.0

    def select_cohort(self, rng: np.random.Generator, m: int) -> np.ndarray:
        return rng.choice(self.num_clients, size=m, replace=False,
                          p=self.probs)

    def sample_cid(self, rng: np.random.Generator) -> int:
        return int(np.searchsorted(self._cdf, rng.random(), side="right"))

    def cohort_weights(self, cids: np.ndarray) -> np.ndarray:
        return self.weights[np.asarray(cids, np.int64)]

    def client_weight(self, cid: int) -> float:
        return float(self.weights[int(cid)])


class TierRotationPolicy(SelectionPolicy):
    """Rotate the tier->client assignment every ``every`` server updates:
    at update ``r`` client ``c`` trains tier
    ``(base[c] + r // every) % n_tiers``. Over ``n_tiers`` rotations
    every client group trains every tier's block-group (FedPLT-style
    coverage), composed against the plan's existing compiled
    sub-layouts — nothing re-traces, only the runtime tier ids move."""

    name = "tier-rotation"
    trivial = False

    def __init__(self, every: int = 1):
        if every < 1:
            raise ValueError("rotation period must be >= 1 round")
        self.every = int(every)
        self.rotation = 0

    def bind(self, **kw) -> None:
        super().bind(**kw)
        if self.cplan is None or self._tiers is None:
            raise ValueError("tier-rotation needs a trainability plan "
                             "(GridConfig.plan)")
        self.n_tiers = len(self.cplan.tiers)
        self.base = np.asarray(self._tiers, np.int32)
        self.rotation = 0
        self._map = self.base

    def current_tiers(self) -> np.ndarray:
        # cached: the async path queries per dispatch (tier id + compute),
        # the map only moves in end_round
        return self._map

    def end_round(self, round_idx: int) -> None:
        rotation = (round_idx + 1) // self.every
        if rotation != self.rotation:
            self.rotation = rotation
            self._map = (self.base + rotation) % self.n_tiers

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["rotation"] = int(self.rotation)
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.rotation = int(state["rotation"])
        self._map = (self.base + self.rotation) % self.n_tiers


class AdaptiveCapabilityPolicy(SelectionPolicy):
    """Re-tier the fleet online from observed round-trip times.

    The static capability split (``sim/devices.assign_tiers``) trusts
    the profile; this policy trusts the wire. Every completed upload
    updates an EMA of that client's observed RTT (initialized from the
    profile estimate, so unobserved clients keep their static rank);
    every ``refit_every`` server updates the fleet is re-split into
    ``n_tiers`` quantile buckets of ``1/ema_rtt`` — the same rule
    ``assign_tiers`` applies to static capability scores, now fed by
    measurements. Sampling stays uniform."""

    name = "adaptive-capability"
    trivial = False

    def __init__(self, refit_every: int = 5, ema: float = 0.3):
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema weight must be in (0, 1]")
        if refit_every < 1:
            raise ValueError("refit_every must be >= 1 round")
        self.refit_every = int(refit_every)
        self.ema = float(ema)

    def bind(self, **kw) -> None:
        super().bind(**kw)
        if self.cplan is None or self._tiers is None:
            raise ValueError("adaptive-capability needs a trainability "
                             "plan (GridConfig.plan)")
        if self.rtt_estimate is None:
            raise ValueError("adaptive-capability needs per-client "
                             "round-trip estimates to seed the EMA")
        self.n_tiers = len(self.cplan.tiers)
        self.ema_rtt = np.asarray(self.rtt_estimate, np.float64).copy()
        self.observed = np.zeros(self.num_clients, bool)
        self._map = np.asarray(self._tiers, np.int32)
        self.refits = 0
        # EMA snapshot at the last refit: what the current map was
        # actually computed from (observations keep arriving between
        # refits, so ema_rtt itself runs ahead of the map)
        self.refit_ema = self.ema_rtt.copy()

    def observe(self, cid: int, rtt_seconds: float) -> None:
        cid = int(cid)
        self.ema_rtt[cid] = ((1.0 - self.ema) * self.ema_rtt[cid]
                             + self.ema * float(rtt_seconds))
        self.observed[cid] = True

    def current_tiers(self) -> np.ndarray:
        return self._map

    def end_round(self, round_idx: int) -> None:
        if (round_idx + 1) % self.refit_every:
            return
        self._map = dev_lib.quantile_tiers(
            1.0 / np.maximum(self.ema_rtt, 1e-12), self.n_tiers)
        self.refit_ema = self.ema_rtt.copy()
        self.refits += 1

    def state_dict(self) -> dict:
        state = super().state_dict()
        state.update(
            ema_rtt=[float(x) for x in self.ema_rtt],
            observed=[bool(x) for x in self.observed],
            tier_map=[int(x) for x in self._map],
            refits=int(self.refits),
            refit_ema=[float(x) for x in self.refit_ema])
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.ema_rtt = np.asarray(state["ema_rtt"], np.float64)
        self.observed = np.asarray(state["observed"], bool)
        self._map = np.asarray(state["tier_map"], np.int32)
        self.refits = int(state["refits"])
        self.refit_ema = np.asarray(state["refit_ema"], np.float64)


POLICIES = {
    "uniform": UniformPolicy,
    "bandwidth-aware": BandwidthAwarePolicy,
    "tier-rotation": TierRotationPolicy,
    "adaptive-capability": AdaptiveCapabilityPolicy,
}


def resolve_policy(spec: Union[str, SelectionPolicy]) -> SelectionPolicy:
    """GridConfig.selection -> a fresh policy instance (named policies)
    or the caller's instance (assumed un-bound / reusable via bind)."""
    if isinstance(spec, SelectionPolicy):
        return spec
    try:
        return POLICIES[spec]()
    except KeyError:
        raise ValueError(f"unknown selection policy {spec!r}; options: "
                         f"{sorted(POLICIES)}") from None
