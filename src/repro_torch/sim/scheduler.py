"""Event-driven virtual-clock scheduler for the simulation grid.

Two scheduling regimes over a heterogeneous :class:`~repro_torch.sim.devices.Fleet`:

* **Synchronous cohorts** (:func:`plan_sync_round`): the server dispatches
  an (optionally over-selected) cohort, waits for the first
  ``clients_needed`` arrivals, and drops stragglers that miss the round
  deadline. Offline clients (availability draw) never start; dispatched
  clients may drop out mid-round (they consume downlink but never upload).

* **Buffered asynchronous** (:class:`BufferedAsyncScheduler`): FedBuff-style.
  The server keeps ``concurrency`` clients in flight; each completion
  lands in a buffer with its staleness (server version now minus version
  it trained on); once ``goal_count`` deltas are buffered the server
  applies one update and bumps its version. Staleness down-weighting is
  pluggable via ``core.fedpt.get_staleness_fn``.

All time is *virtual* seconds derived from device profiles and measured
wire bytes — the simulation runs as fast as the hardware allows while
reporting cross-device wall-clock.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.sim import devices as dev_lib
from repro_torch.sim import faults as faults_lib


@dataclasses.dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: Dict[str, Any] = dataclasses.field(compare=False,
                                                default_factory=dict)


class EventQueue:
    """Min-heap of events keyed by (virtual time, insertion order) — ties
    resolve in dispatch order, which is what makes the homogeneous sync
    fleet reproduce the plain cohort ordering exactly."""

    def __init__(self):
        self._heap: List[Event] = []
        # a plain int (not itertools.count) so a grid-state snapshot can
        # save and restore the insertion counter exactly
        self._next_seq = 0
        self.now = 0.0

    def push(self, time: float, kind: str, **payload) -> Event:
        ev = Event(time=float(time), seq=self._next_seq, kind=kind,
                   payload=payload)
        self._next_seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        return ev

    def __len__(self) -> int:
        return len(self._heap)


# ---------------------------------------------------------------------------
# Synchronous cohorts


@dataclasses.dataclass
class SyncRoundPlan:
    cids: np.ndarray              # over-selected cohort, dispatch order
    dispatched: np.ndarray        # bool: passed the availability draw
    completed: np.ndarray         # bool: uploaded before the deadline
    participant: np.ndarray       # bool: among the first clients_needed arrivals
    arrival: np.ndarray           # float: upload-complete time (inf if never)
    round_seconds: float          # when the server closed the round
    offline: int                  # failed availability draw
    dropouts: int                 # dropped mid-round after dispatch
    deadline_drops: int           # upload arrives past the deadline
    excess: int                   # on time, but the quota was already filled
    # dark-window re-polls: 1 when nobody dispatched and the deadline-less
    # server advanced the clock by the redispatch backoff (the sync
    # analogue of the async engine's parked-dispatch retries)
    retries: int = 0
    # injected crash-mid-compute faults (sim/faults.py): dispatched,
    # consumed downlink + partial compute, never uploads
    crashes: int = 0
    # trace seq of the upload that closed the round (the slowest counted
    # arrival) — the grid parents its "round" span on it so analyze.py
    # can walk round -> bounding upload -> dispatch. None when the round
    # was deadline-bound (or untraced).
    bound_seq: Optional[int] = None

    def participant_cids(self) -> np.ndarray:
        """Participants in arrival order (dispatch order on ties)."""
        order = np.lexsort((np.arange(len(self.cids)), self.arrival))
        return self.cids[order[self.participant[order]]]


def plan_sync_round(fleet: dev_lib.Fleet, cids: Sequence[int],
                    down_bytes: int, up_bytes, compute_seconds,
                    clients_needed: int, rng: np.random.Generator,
                    deadline: float = math.inf, dynamics=None,
                    dyn_rng: Optional[np.random.Generator] = None,
                    now: float = 0.0,
                    tracer=trace_lib.NULL_TRACER,
                    tiers=None, faults=None,
                    shocks=None, regions=None) -> SyncRoundPlan:
    """Simulate one synchronous round over the cohort `cids` (possibly
    over-selected: len(cids) >= clients_needed) and decide who counts.

    ``up_bytes`` is a scalar, or a per-cohort-member array when clients
    upload tier-sliced payloads of different sizes (core/plan.py): a
    lite-tier phone's smaller delta clears the uplink sooner, and the
    virtual clock sees it. ``compute_seconds`` broadcasts the same way
    (per-tier compute: a lite tier's backward pass is cheaper).

    ``dynamics`` (a ``sim/dynamics.BoundDynamics``) makes the round
    stochastic: the availability trace is queried at ``now`` (the
    round's virtual start time) and multiplied into each profile's base
    availability, and transfer times come from each client's link model
    with per-transfer jitter drawn from ``dyn_rng`` — a child stream
    independent of ``rng``, whose fixed-count availability/dropout
    draws above stay byte-identical whether dynamics are on or off.

    ``tracer`` (an ``obs/trace.Tracer``) records one ``dispatch`` span
    per dispatched member (virtual start ``now``, duration = its round
    trip; dropouts get a null duration — they never finish) and one
    ``upload`` instant per completed upload; ``tiers`` optionally
    supplies the per-member tier indices for those payloads. The
    default NULL_TRACER emits nothing and costs nothing.

    ``faults`` (a ``sim/faults.BoundFaults``) injects crash-mid-compute:
    a fixed-count vector of crash draws from the *fault* stream (zero
    draws of ``rng``/``dyn_rng``, so ``faults=None`` rounds are
    bit-identical) marks cohort members that consume their downlink and
    part of their compute but never upload. Payload faults (truncation,
    corruption, duplicates) are async-only — the sync engine computes
    deltas inside one jitted cohort step and has no per-client wire
    payload to damage — and the grid rejects them before calling here.

    ``shocks`` (a ``sim/dynamics.BoundShocks``) + ``regions`` (the
    cohort members' edge-region indices, from ``sim/topology.py``)
    multiply correlated region-outage factors into the availability
    screen — one whole edge's clients go dark together.

    The round is fully vectorized: one RNG call per draw *kind* per
    cohort and array ops for arrivals/selection — no per-client Python
    objects or events (the arrival-order selection below reproduces the
    old per-member event heap exactly: events were pushed in member
    order, so (time, push-order) heap order == lexsort(arrival, index))."""
    cids = np.asarray(cids, np.int64)
    m = len(cids)
    st = fleet.state
    up_arr = np.broadcast_to(np.asarray(up_bytes, np.int64), (m,))
    comp_arr = np.broadcast_to(np.asarray(compute_seconds, np.float64), (m,))
    # fixed-count rng draws so the stream is deterministic regardless of
    # outcomes (and entirely separate from the data-sampling stream)
    avail_u = rng.random(m)
    drop_u = rng.random(m)
    # fixed-count crash draws from the independent fault stream
    crash = (faults.crash_draws(m) if faults is not None
             else np.zeros(m, bool))
    if dynamics is not None:
        # fixed-count N(0,1) draws from the dynamics stream: one per
        # potential transfer, consumed even for members that never
        # dispatch, so the stream position is outcome-independent
        z_down = dyn_rng.standard_normal(m)
        z_up = dyn_rng.standard_normal(m)

    avail = st.availability[cids]
    if dynamics is not None:
        avail = avail * dynamics.prob_batch(cids, now)
    if shocks is not None:
        avail = avail * shocks.factor(regions, now)
    dispatched = avail_u < avail
    dropped = dispatched & (drop_u < st.dropout[cids])
    crashed = dispatched & ~dropped & crash
    will_complete = dispatched & ~dropped & ~crash
    if dynamics is None:
        t = st.round_trip_seconds(down_bytes, up_arr, comp_arr, cids=cids)
    else:
        t = dynamics.round_trip_seconds_batch(st, cids, down_bytes, up_arr,
                                              comp_arr, z_down, z_up)
    arrival = np.where(will_complete, t, math.inf)

    # the first clients_needed arrivals at or before the deadline, in
    # (arrival, dispatch-order) order — the old event-heap pop loop
    participant = np.zeros(m, bool)
    order = np.lexsort((np.arange(m), arrival))
    comp_order = order[will_complete[order]]
    arr_sorted = arrival[comp_order]
    n_eligible = int(np.searchsorted(arr_sorted, deadline, side="right"))
    taken = min(int(clients_needed), n_eligible)
    participant[comp_order[:taken]] = True
    round_seconds = float(arr_sorted[taken - 1]) if taken else 0.0
    retried = 0
    if taken < clients_needed and math.isfinite(deadline):
        round_seconds = deadline           # server waited the round out
    elif taken == 0 and dynamics is not None:
        # deadline-less server under a dark availability window: nobody
        # even dispatched, so without a clock advance the trace would be
        # re-queried at the same virtual time forever. The server
        # re-polls after the redispatch backoff (the async engine's
        # retry semantics).
        round_seconds = dynamics.redispatch_backoff
        retried = 1
    completed = will_complete & (arrival <= deadline)
    bound_seq = None
    if tracer.enabled:
        # per-phase components for the v4 dispatch spans — recomputed
        # from the already-drawn z values, zero extra PRNG draws
        if dynamics is None:
            t_down = np.asarray(down_bytes, np.float64) \
                / st.downlink_bps[cids]
            t_comp = comp_arr * st.compute_multiplier[cids]
            t_up = up_arr / st.uplink_bps[cids]
        else:
            t_down, t_comp, t_up = dynamics.round_trip_components_batch(
                st, cids, down_bytes, up_arr, comp_arr, z_down, z_up)
        upload_seq = {}               # member index -> upload seq
        for i in range(m):
            if not dispatched[i]:
                continue
            dur = float(arrival[i]) if math.isfinite(arrival[i]) else None
            outcome = ("ok" if will_complete[i]
                       else "crash" if crashed[i] else "dropout")
            dseq = tracer.span(
                "dispatch", now, dur, cid=int(cids[i]),
                tier=None if tiers is None else int(tiers[i]),
                region=None if regions is None else int(regions[i]),
                down_bytes=int(down_bytes),
                up_bytes=int(up_arr[i]), outcome=outcome,
                t_down=float(t_down[i]), t_comp=float(t_comp[i]),
                t_up=float(t_up[i]))
            if crashed[i]:
                tracer.instant(
                    "fault", now, parent=dseq, fault="crash_compute",
                    cid=int(cids[i]),
                    tier=None if tiers is None else int(tiers[i]))
            if completed[i]:
                upload_seq[i] = tracer.instant(
                    "upload", now + float(arrival[i]), parent=dseq,
                    cid=int(cids[i]),
                    tier=None if tiers is None else int(tiers[i]),
                    region=None if regions is None else int(regions[i]),
                    up_bytes=int(up_arr[i]), rtt=float(arrival[i]),
                    participant=bool(participant[i]))
        if retried:
            tracer.instant("retry", now,
                           backoff=float(dynamics.redispatch_backoff))
        if taken and round_seconds == float(arr_sorted[taken - 1]):
            # the round closed on its slowest counted arrival (a full
            # cohort, or every eligible client under an infinite
            # deadline): that upload bounds the round's virtual wall
            # time. Deadline-stretched rounds keep bound_seq=None — the
            # server, not any client, held the clock.
            bound_seq = upload_seq.get(int(comp_order[taken - 1]))
    return SyncRoundPlan(
        cids=cids, dispatched=dispatched, completed=completed,
        participant=participant, arrival=arrival,
        round_seconds=float(round_seconds),
        offline=int(np.sum(~dispatched)),
        dropouts=int(np.sum(dispatched & ~will_complete & ~crashed)),
        deadline_drops=int(np.sum(will_complete & (arrival > deadline))),
        excess=int(np.sum(completed & ~participant)), retries=retried,
        crashes=int(np.sum(crashed)), bound_seq=bound_seq)


# ---------------------------------------------------------------------------
# Buffered asynchronous aggregation (FedBuff)


@dataclasses.dataclass
class BufferEntry:
    work: Dict[str, Any]          # run_client's result (opaque here; the
                                  # delta/loss may be lazy lane handles)
    weight: float                 # staleness_fn(s) * p_i
    staleness: int
    # trace seq of the upload instant that buffered this entry (None
    # when untraced or restored from a snapshot — grid-state whitelists
    # drop it, and the resumed run starts a fresh tracer anyway)
    seq: Optional[int] = None


class BufferedAsyncScheduler:
    """Drives the async grid. The caller provides three closures so the
    scheduler stays free of JAX and dataset specifics:

    ``sample_cid(rng) -> int``
        propose a client to dispatch (the scheduler redraws on failed
        availability checks);
    ``run_client(cid, version) -> dict``
        start local training against the *current* server model (correct
        because events are processed in virtual-time order, so the model
        at dispatch time is the model the client downloads); must return
        ``{"weight", "up_bytes", ...}`` — any further entries (delta,
        loss, lane handles) are opaque to the scheduler and simply
        carried to ``apply_update``, so the grid can defer the actual
        device work into batched client lanes and keep losses on-device
        (no per-client host sync here);
    ``apply_update(entries, now, version) -> dict``
        flush the buffer into one server update and return metrics
        (e.g. ``loss``/``delta_norm``), which are merged into the
        per-update history record.

    ``down_bytes`` and ``compute_seconds`` are constants of the round
    configuration (payload sizes are shape-determined).

    ``tier_of(cid) -> int`` (optional) names each client's trainability
    tier (core/plan.py): the tier is recorded on every dispatch — the
    payload of the queued event carries it, and the per-tier counters
    (``tier_dispatches``/``tier_uploads``/``tier_up_bytes``) let the
    grid bill wire traffic tier by tier, mid-round dropouts included
    (they consumed a tier-invariant downlink but never upload).

    ``compute_of(cid) -> seconds`` (optional) overrides the constant
    ``compute_seconds`` per dispatch — per-tier compute: a lite tier's
    backward pass is cheaper, scaled by its trainable fraction.

    ``dynamics`` (a ``sim/dynamics.BoundDynamics``) + ``dyn_rng`` make
    links stochastic and availability trace-driven, queried at each
    dispatch's virtual time. When the trace has the whole fleet dark the
    dispatch parks as a ``retry`` event ``redispatch_backoff`` virtual
    seconds later instead of raising — the run keeps draining events, so
    a zero-availability *window* stalls the clock, not the process, and
    a run with a ``deadline`` always terminates.

    ``observe(cid, rtt_seconds)`` (optional) is called for every upload
    the server receives with that transfer's realized round-trip time —
    the feedback loop ``sim/selection.py`` policies adapt on.

    ``tracer`` (an ``obs/trace.Tracer``) records every dispatch as a
    virtual-time span (start = dispatch time, duration = realized round
    trip; mid-round dropouts end at their failure time), every arriving
    upload and parked-dispatch retry as instants, and every buffer
    flush as an instant carrying its fill/staleness stats. The default
    NULL_TRACER emits nothing. ``metrics`` (an
    ``obs/metrics.MetricsRegistry``) backs ALL of the scheduler's
    counters — the legacy attributes (``dispatches``, ``tier_uploads``,
    ...) are read-only views over it.

    ``faults`` (a ``sim/faults.BoundFaults``) injects the failure model:
    exactly two fault-stream draws per dispatch (zero draws of ``rng``/
    ``dyn_rng``, so ``faults=None`` runs are bit-identical and a
    corruption-only config keeps the exact dispatch timeline) decide a
    crash-mid-compute, an upload truncation (partial bytes billed, delta
    dropped), a payload corruption (NaN/bitflip — carried on the work
    dict for the apply stage to materialize), a duplicate delivery (the
    entry buffers and bills twice), or nothing. When the virtual clock
    crosses ``faults.kill_at`` the run raises
    :class:`~repro_torch.sim.faults.ServerKilled`.

    ``checkpoint_hook(scheduler, now)`` (optional) is called after every
    full-buffer flush — the one boundary where no lane work is pending
    and every in-flight completion holds concrete arrays, i.e. where
    ``checkpoint/grid_state.py`` can snapshot the whole execution state.

    Run state (event heap, carry-over buffer, history records) lives on
    the instance (``self.q``/``self.buffer``/``self.records``) so a
    snapshot can serialize it and a restore can pre-seed it before
    calling :meth:`run`.
    """

    def __init__(self, fleet: dev_lib.Fleet, concurrency: int,
                 goal_count: int, staleness_fn: Callable[[float], float],
                 sample_cid: Callable, run_client: Callable,
                 apply_update: Callable, down_bytes: int,
                 compute_seconds: float, rng: np.random.Generator,
                 tier_of: Optional[Callable[[int], int]] = None,
                 compute_of: Optional[Callable[[int], float]] = None,
                 region_of: Optional[Callable[[int], int]] = None,
                 shocks=None,
                 dynamics=None,
                 dyn_rng: Optional[np.random.Generator] = None,
                 observe: Optional[Callable[[int, float], None]] = None,
                 tracer=trace_lib.NULL_TRACER,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 faults=None,
                 checkpoint_hook: Optional[Callable] = None):
        if goal_count < 1:
            raise ValueError("goal_count must be >= 1")
        self.fleet = fleet
        self.concurrency = max(1, int(concurrency))
        self.goal_count = int(goal_count)
        self.staleness_fn = staleness_fn
        self.sample_cid = sample_cid
        self.run_client = run_client
        self.apply_update = apply_update
        self.down_bytes = int(down_bytes)
        self.compute_seconds = float(compute_seconds)
        self.rng = rng
        self.tier_of = tier_of
        self.compute_of = compute_of
        # two-level topology (sim/topology.py): region_of names each
        # client's edge region — dispatch/upload events route through it
        # (payloads + per-region counters), and correlated region shocks
        # (sim/dynamics.BoundShocks) gate availability region-wide
        self.region_of = region_of
        self.shocks = shocks
        self.dynamics = dynamics
        self.dyn_rng = dyn_rng
        self.observe = observe
        self.tracer = tracer
        # ALL counters live in the metrics registry (read by the grid
        # for the comm ledger and GridResult.scheduler_stats)
        self.metrics = metrics if metrics is not None \
            else metrics_lib.MetricsRegistry()
        self.faults = faults
        self.kill_at = faults.kill_at if faults is not None else math.inf
        self.checkpoint_hook = checkpoint_hook
        self._consecutive_retries = 0
        # virtual time when the current dark window started (None = the
        # fleet is not dark): backs the retry budget below
        self._dark_since: Optional[float] = None
        # trace seq of the most recent flush instant — the grid's
        # apply_update closure parents its dp_flush/quarantine/
        # edge_flush/checkpoint instants on it (set by _flush *before*
        # apply_update runs; None when untraced)
        self.last_flush_seq: Optional[int] = None
        self.version = 0
        # run state, on the instance so grid-state snapshots can
        # serialize it and restores can pre-seed it (run() initializes
        # fresh when untouched)
        self.q: Optional[EventQueue] = None
        self.buffer: List[BufferEntry] = []
        self.records: List[Dict[str, float]] = []

    # legacy counter attributes, now read-only views over the registry
    @property
    def dispatches(self) -> int:
        return int(self.metrics.counter("dispatches").value)

    @property
    def dropouts(self) -> int:
        return int(self.metrics.counter("dropouts").value)

    @property
    def completions(self) -> int:
        return int(self.metrics.counter("uploads").value)

    @property
    def retries(self) -> int:
        return int(self.metrics.counter("retries").value)

    @property
    def up_bytes_total(self) -> int:
        return int(self.metrics.counter("up_bytes").value)

    @property
    def tier_dispatches(self) -> Dict[int, int]:
        return self.metrics.counter("tier_dispatches").labels

    @property
    def tier_uploads(self) -> Dict[int, int]:
        return self.metrics.counter("tier_uploads").labels

    @property
    def tier_up_bytes(self) -> Dict[int, int]:
        return self.metrics.counter("tier_up_bytes").labels

    @property
    def tier_rtt_sum(self) -> Dict[int, float]:
        return self.metrics.counter("tier_rtt_sum").labels

    def _dispatch(self, q: EventQueue, now: float,
                  parent: Optional[int] = None) -> None:
        # ``parent`` is the trace seq of whatever freed this dispatch
        # slot (a failed/completed round trip, or the previous parked
        # retry) — threaded onto the span/instant this dispatch emits so
        # the causal chain survives redispatches. None when untraced.
        # redraw until the availability check passes (bounded, so a fleet
        # of mostly-offline phones can't spin forever)
        for _ in range(1000):
            cid = int(self.sample_cid(self.rng))
            p = self.fleet.profile(cid)
            region = (int(self.region_of(cid))
                      if self.region_of is not None else None)
            avail = p.availability
            if self.dynamics is not None:
                avail = avail * self.dynamics.prob(cid, now)
            if self.shocks is not None:
                # correlated region outage: the whole edge's clients are
                # gated together (zero extra draws at query time)
                avail = avail * self.shocks.factor_one(region, now)
            if self.rng.random() < avail:
                break
        else:
            if self.dynamics is not None:
                # the trace has (essentially) everyone offline right now:
                # park this dispatch slot and retry when the clock moves.
                # Backoff escalates exponentially (capped, with
                # deterministic jitter so parked slots don't thundering-
                # herd on the same instant) and a *virtual-time* retry
                # budget bounds how long a dark window may stall the run.
                if self._dark_since is None:
                    self._dark_since = now
                dark = now - self._dark_since
                if dark > self.dynamics.retry_budget:
                    raise RuntimeError(
                        f"availability trace kept the whole fleet offline "
                        f"for {dark:.0f} consecutive virtual seconds, "
                        f"past the retry budget of "
                        f"{self.dynamics.retry_budget:.0f}s — set "
                        "GridConfig.async_deadline, fix the trace, or "
                        "raise DynamicsConfig.retry_budget")
                backoff = self.dynamics.backoff_seconds(
                    self._consecutive_retries)
                self._consecutive_retries += 1
                self.metrics.counter("retries").inc()
                rseq = self.tracer.instant("retry", now, parent=parent,
                                           backoff=float(backoff))
                q.push(now + backoff, "retry", seq=rseq)
                return
            raise RuntimeError("no available client after 1000 draws")
        self._consecutive_retries = 0
        self._dark_since = None
        fault = self.faults.draw() if self.faults is not None else None
        self.metrics.counter("dispatches").inc()
        comp = (self.compute_of(cid) if self.compute_of is not None
                else self.compute_seconds)
        if self.dynamics is not None:
            # two N(0,1) draws per dispatch (down + up), consumed even on
            # the dropout path so the stream is outcome-independent
            z_down, z_up = self.dyn_rng.standard_normal(2)
            lm = self.dynamics.link_for(cid)
        tier = int(self.tier_of(cid)) if self.tier_of is not None else None
        if tier is not None:
            self.metrics.counter("tier_dispatches").inc(label=tier)
        if region is not None:
            self.metrics.counter("region_dispatches").inc(label=region)
        if self.rng.random() < p.dropout:
            # dies after download + local work, before upload
            if self.dynamics is None:
                dl = self.down_bytes / p.downlink_bps
            else:
                dl = lm.transfer_seconds(self.down_bytes, p.downlink_bps,
                                         z_down)
            comp_t = comp * p.compute_multiplier
            t = now + (dl + comp_t)
            dseq = self.tracer.span(
                "dispatch", now, t - now, parent=parent, cid=cid,
                tier=tier, region=region, down_bytes=self.down_bytes,
                version=self.version, outcome="dropout",
                t_down=float(dl), t_comp=float(comp_t))
            q.push(t, "failed", cid=cid, tier=tier, region=region,
                   seq=dseq)
            return
        if fault is not None and fault["kind"] == "crash":
            # injected crash-mid-compute: downlink + crash_frac of the
            # local work, then silence — the server redispatches on the
            # failure event, like a dropout but counted separately
            if self.dynamics is None:
                dl = self.down_bytes / p.downlink_bps
            else:
                dl = lm.transfer_seconds(self.down_bytes, p.downlink_bps,
                                         z_down)
            comp_t = (self.faults.cfg.crash_frac * comp
                      * p.compute_multiplier)
            t = now + dl + comp_t
            dseq = self.tracer.span(
                "dispatch", now, t - now, parent=parent, cid=cid,
                tier=tier, region=region, down_bytes=self.down_bytes,
                version=self.version, outcome="crash",
                t_down=float(dl), t_comp=float(comp_t))
            self.tracer.instant("fault", t, parent=dseq,
                                fault="crash_compute", cid=cid, tier=tier)
            q.push(t, "failed", cid=cid, tier=tier, region=region,
                   cause="crash", seq=dseq)
            return
        work = self.run_client(cid, self.version)
        if fault is not None:
            # a payload fault (truncate/nan/bitflip/duplicate) rides on
            # the work dict to the arrival/apply stages
            work["fault"] = fault
        up_bytes = int(work["up_bytes"])
        if self.dynamics is None:
            rtt = p.round_trip_seconds(self.down_bytes, up_bytes, comp)
        else:
            rtt = self.dynamics.round_trip_seconds(
                p, self.down_bytes, up_bytes, comp, cid, z_down, z_up)
        if self.tracer.enabled:
            # the span's phase components, recomputed from the same
            # already-drawn z values — zero extra PRNG draws
            if self.dynamics is None:
                dl = self.down_bytes / p.downlink_bps
                ul = up_bytes / p.uplink_bps
            else:
                dl = lm.transfer_seconds(self.down_bytes, p.downlink_bps,
                                         z_down)
                ul = lm.transfer_seconds(up_bytes, p.uplink_bps, z_up)
            dseq = self.tracer.span(
                "dispatch", now, rtt, parent=parent, cid=cid, tier=tier,
                region=region, down_bytes=self.down_bytes,
                up_bytes=up_bytes, version=self.version, outcome="ok",
                t_down=float(dl),
                t_comp=float(comp * p.compute_multiplier),
                t_up=float(ul))
        else:
            dseq = None
        q.push(now + rtt, "complete", cid=cid, version=self.version,
               work=work, tier=tier, rtt=rtt, region=region, seq=dseq)

    def _flush(self, buffer, now: float, records) -> None:
        stale = np.array([e.staleness for e in buffer], np.float64)
        # the flush instant is emitted *before* apply_update so the
        # accountant/ledger instants the apply emits (dp_flush,
        # quarantine, edge_flush) can parent on it via last_flush_seq.
        # Its parent is the buffered upload with the largest seq — seqs
        # are emission-(= virtual-time-)monotone, so that is the last
        # arrival, the one that actually triggered this flush.
        parent = None
        if self.tracer.enabled:
            seqs = [e.seq for e in buffer if e.seq is not None]
            parent = max(seqs) if seqs else None
        self.last_flush_seq = self.tracer.instant(
            "flush", now, parent=parent, version=self.version,
            buffer_fill=float(len(buffer)),
            staleness_mean=float(stale.mean()),
            staleness_max=float(stale.max()))
        metrics = self.apply_update(buffer, now, self.version)
        # buffer_fill < goal_count only for the deadline-drained final
        # flush (the consumer pads it back to the fixed apply shape);
        # recorded so DP audits and tests can see the padding happened
        rec = {"round": len(records),
               "virtual_seconds": now,
               "buffer_fill": float(len(buffer)),
               "staleness_mean": float(stale.mean()),
               "staleness_max": float(stale.max())}
        rec.update(metrics or {})
        records.append(rec)
        self.version += 1

    def finish_event(self, now: float) -> None:
        """Replay the tail of the complete-branch a snapshot interrupted.

        The checkpoint hook fires *inside* the flush loop — before any
        further full-buffer flushes of the same event and before the
        freed slot's redispatch (both of which the original run then
        performed). A restore must replay exactly that tail, from the
        restored RNG positions, or the resumed timeline shifts by one
        dispatch. Checkpoint hooks are NOT re-fired here: the replayed
        flushes would just rewrite the snapshots the original run
        already wrote."""
        while len(self.buffer) >= self.goal_count:
            batch = self.buffer[:self.goal_count]
            del self.buffer[:self.goal_count]
            self._flush(batch, now, self.records)
        self._dispatch(self.q, now)

    def run(self, num_updates: int,
            deadline: float = math.inf) -> List[Dict[str, float]]:
        """Run until `num_updates` server updates have been applied.
        Returns one record per update (virtual time, staleness stats,
        plus whatever apply_update reports).

        ``deadline`` is a *virtual-seconds* budget: at the first event
        past it the run stops, flushing the partially-filled buffer as
        one final short update (the consumer pads it to ``goal_count``
        with zero weights, so the apply shape never changes).

        A restored grid-state snapshot pre-seeds ``self.q`` / ``self.
        buffer`` / ``self.records`` / ``self.version`` before calling
        this; a fresh run initializes them and primes ``concurrency``
        dispatches at t=0."""
        if self.q is None:
            self.q = EventQueue()
            for _ in range(self.concurrency):
                self._dispatch(self.q, 0.0)
        q, records = self.q, self.records
        while len(records) < num_updates:
            if not len(q):
                raise RuntimeError("async scheduler starved: no in-flight "
                                   "clients and buffer below goal_count")
            ev = q.pop()
            if ev.time > self.kill_at:
                # injected server kill: die exactly at the virtual time
                # the fault plan asked for (resume via grid_state)
                raise faults_lib.ServerKilled(at=ev.time,
                                              applied=self.version)
            if ev.time > deadline:
                # out of virtual time: drain the partial buffer as the
                # final (padded) server update
                if self.buffer:
                    self._flush(self.buffer, deadline, records)
                    self.buffer = []
                break
            if ev.kind == "retry":
                # a dispatch slot parked by a dark availability window:
                # try again now that the clock moved (chained to the
                # parked retry instant, so escalating backoffs link up)
                self._dispatch(q, ev.time, parent=ev.payload.get("seq"))
                continue
            if ev.kind == "failed":
                if ev.payload.get("cause") == "crash":
                    self.metrics.counter("crashes").inc()
                else:
                    self.metrics.counter("dropouts").inc()
                self._dispatch(q, ev.time, parent=ev.payload.get("seq"))
                continue
            work = ev.payload["work"]
            fault = work.get("fault")
            cid = int(ev.payload["cid"])
            tier = ev.payload.get("tier")
            region = ev.payload.get("region")
            dseq = ev.payload.get("seq")
            if fault is not None and fault["kind"] == "truncate":
                # the upload died partway: the wire carried (and bills)
                # a fraction of the bytes; the server detects the length
                # mismatch and drops the delta before buffering
                arrived = int(work["up_bytes"] * fault["frac"])
                self.metrics.counter("truncated").inc()
                self.metrics.counter("up_bytes").inc(arrived)
                if tier is not None:
                    self.metrics.counter("tier_up_bytes").inc(arrived,
                                                              label=tier)
                if region is not None:
                    self.metrics.counter("region_up_bytes").inc(
                        arrived, label=region)
                self.tracer.instant("fault", ev.time, parent=dseq,
                                    fault="truncate_upload", cid=cid,
                                    tier=tier, frac=float(fault["frac"]),
                                    up_bytes=arrived)
                self._dispatch(q, ev.time, parent=dseq)
                continue
            s = self.version - ev.payload["version"]
            self.metrics.counter("uploads").inc()
            self.metrics.counter("up_bytes").inc(int(work["up_bytes"]))
            if self.observe is not None:
                self.observe(cid, ev.payload["rtt"])
            useq = self.tracer.instant("upload", ev.time, parent=dseq,
                                       cid=cid, tier=tier,
                                       region=region,
                                       up_bytes=int(work["up_bytes"]),
                                       staleness=int(s),
                                       rtt=float(ev.payload["rtt"]))
            if region is not None:
                self.metrics.counter("region_uploads").inc(label=region)
                self.metrics.counter("region_up_bytes").inc(
                    int(work["up_bytes"]), label=region)
            if tier is not None:
                self.metrics.counter("tier_uploads").inc(label=tier)
                self.metrics.counter("tier_up_bytes").inc(
                    int(work["up_bytes"]), label=tier)
                self.metrics.counter("tier_rtt_sum").inc(
                    float(ev.payload["rtt"]), label=tier)
                self.metrics.counter("tier_rtt_n").inc(label=tier)
            entry = BufferEntry(
                work=work,
                weight=float(self.staleness_fn(s)) * float(work["weight"]),
                staleness=int(s), seq=useq)
            self.buffer.append(entry)
            if fault is not None and fault["kind"] in ("nan", "bitflip"):
                # the corrupted payload buffers normally — the apply
                # stage materializes the damage; the sanitize screen
                # (core/sanitize.py) is what should catch it
                self.metrics.counter("corrupted").inc()
                self.tracer.instant("fault", ev.time, parent=useq,
                                    fault="corrupt_" + fault["kind"],
                                    cid=cid, tier=tier)
            elif fault is not None and fault["kind"] == "duplicate":
                # retransmit after a lost ack: the same delta buffers
                # (and bills) twice
                self.metrics.counter("duplicates").inc()
                self.metrics.counter("uploads").inc()
                self.metrics.counter("up_bytes").inc(int(work["up_bytes"]))
                if tier is not None:
                    self.metrics.counter("tier_uploads").inc(label=tier)
                    self.metrics.counter("tier_up_bytes").inc(
                        int(work["up_bytes"]), label=tier)
                if region is not None:
                    self.metrics.counter("region_uploads").inc(label=region)
                    self.metrics.counter("region_up_bytes").inc(
                        int(work["up_bytes"]), label=region)
                self.tracer.instant("fault", ev.time, parent=useq,
                                    fault="duplicate_upload", cid=cid,
                                    tier=tier)
                self.buffer.append(BufferEntry(work=work,
                                               weight=entry.weight,
                                               staleness=entry.staleness,
                                               seq=useq))
            # duplicates can leave the buffer past goal_count: flush in
            # exact goal_count batches and carry the remainder (when
            # faults are off the buffer never exceeds goal_count, so
            # this is the old flush-everything behavior, bit for bit)
            while len(self.buffer) >= self.goal_count:
                batch = self.buffer[:self.goal_count]
                del self.buffer[:self.goal_count]
                self._flush(batch, ev.time, records)
                if self.checkpoint_hook is not None:
                    # flush boundaries are the one point where no lane
                    # work is pending: snapshot-safe
                    self.checkpoint_hook(self, ev.time)
            self._dispatch(q, ev.time, parent=useq)
        return records
