"""The simulation grid entry point, port of ``repro/sim/grid.py``.

``run_grid`` trains a FedPT model over a heterogeneous client fleet under
either scheduling regime and reports *measured* wire bytes plus simulated
cross-device wall-clock. ``fl.runtime.run_federated`` delegates here with
``GridConfig()`` defaults (uniform fleet, synchronous, no deadline) and
equals a plain round loop fed the same streams bit for bit: the grid
consumes the data-sampling RNG stream (``seed + 77``) and the per-round
DP keys (``seed*100_003 + r``, threefry, as ``jax.random.key``) in
exactly the reference's order, and routes all device/availability
randomness through a separate stream (and all *dynamics* randomness —
link jitter, trace phases — through an independent child of that
stream). The host side (fleets, scheduler, dynamics, faults, selection,
telemetry) is the reference's own code, copied; the device side runs the
port's engines on ``device`` (CUDA unless the caller asks for the CPU).

``GridConfig.plan`` (``core/plan.py``) gives each client a trainability
tier: tier-sliced uplinks and compute charges on the virtual clock, the
tiered round engine in sync mode, tier-homogeneous lanes in async mode,
per-tier billing and ``GridResult.tier_stats``. A trivial (one-tier) plan
runs the untiered engines.

``GridConfig.topology`` (``sim/topology.py``) partitions the fleet into
edge regions: per-hop billing, region shocks (``DynamicsConfig.shocks``)
and, in async mode, each flush's edge pre-reduce on the rows' device.
``checkpoint_every`` / ``resume_from`` snapshot and restore the whole
run (``checkpoint/grid_state.py``, the reference's file format); a
resumed run reproduces the straight run bit for bit on the CPU, and on
CUDA with ``torch.backends.cudnn.deterministic = True`` (the caller's
setting). ``TelemetryConfig.profile`` wraps the round, the lane steps and
the server apply in ``torch.profiler`` / NVTX ranges (``obs/profiling``).

``mesh`` (a ``launch/mesh.py`` preset name or a DeviceMesh) runs the
grid's device work on ``torch.distributed``: every rank runs this host
loop from the same seeds (SPMD), so the clock, scheduler, wire ledger
and accountant come out the same on every rank; the sync round and the
lanes train each data rank's rows of the cohort or lane, and the server
tail aggregates each rank's block of the (K, size) buffer
(``launch/sharding.flat_constrainer``). A preset other than ``single``
needs a world of exactly its size (``torch.distributed.
init_process_group``); ``single`` makes a 1-rank group when there is
none. On a mesh of more than one rank, rank 0 of the world writes each
snapshot once while the others wait at a barrier; every rank reads it on
resume.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.core.partition as part
from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.checkpoint import grid_state as gstate_lib
from repro_torch.core import comm, dp as dp_lib, fedpt
from repro_torch.core import flat as flat_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import sanitize as sanitize_lib
from repro_torch.data import synthetic as syn
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.nn import basic, threefry
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import profiling as prof_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.sim import devices as dev_lib
from repro_torch.sim import dynamics as dyn_lib
from repro_torch.sim import faults as faults_lib
from repro_torch.sim import scheduler as sched_lib
from repro_torch.sim import selection as sel_lib
from repro_torch.sim import topology as topo_lib
from repro_torch.sim import wire


@dataclasses.dataclass
class GridConfig:
    """The reference's grid configuration, field for field (see
    ``repro/sim/grid.py`` for each knob); ``mesh`` as in the module
    docstring."""
    mode: str = "sync"                      # "sync" | "async"
    fleet: Union[str, dev_lib.Fleet] = "uniform"
    # virtual seconds one local step takes on the reference device; each
    # client scales it by its profile's compute_multiplier
    base_step_time: float = 0.01
    # --- sync knobs ---
    over_selection: float = 1.0             # dispatch ceil(f*C), keep first C
    straggler_deadline: float = math.inf    # virtual seconds per round
    # --- async (FedBuff) knobs ---
    concurrency: int = 10                   # clients kept in flight
    goal_count: int = 5                     # buffer size K per server update
    staleness: Any = "polynomial"           # name or callable (core.fedpt)
    staleness_kw: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fixed-width client lanes: in-flight client steps are deferred and run
    # as one (lane, ...) batch per flush. None = auto (lane width ==
    # goal_count); 0 = the sequential per-client reference engine. The
    # virtual-clock history is identical either way.
    lanes: Optional[int] = None
    # virtual-seconds budget for the whole async run: the first event past
    # it ends the run, flushing the partial buffer as one final short
    # update (padded to goal_count with zero weights)
    async_deadline: float = math.inf
    # None = one device; a launch/mesh.py preset name ("single",
    # "debug", "debug-pod", "production", ...) or a DeviceMesh shards the
    # grid's device work (module docstring)
    mesh: Any = None
    # trainability tiers: None = every client trains the whole trainable
    # tree (as does a one-tier plan); a TrainPlan / {name: extra spec}
    # dict / (name, spec) sequence gives each client a tier
    plan: Any = None
    # "capability" (quantile split of the capability score, most capable
    # -> tier 0), an explicit per-client tier array, or a callable
    # DeviceProfile -> tier index
    tier_assignment: Any = "capability"
    # None = the fleet preset's default; a preset name or DynamicsConfig
    dynamics: Any = None
    # "uniform", "bandwidth-aware", "tier-rotation",
    # "adaptive-capability" (the tier policies need a plan), or a
    # SelectionPolicy instance
    selection: Any = "uniform"
    # None = the flat single-hop grid; an int region count, a
    # TopologyConfig or an explicit per-client region array partitions the
    # fleet into edge regions (per-hop billing, edge pre-reduce, shocks)
    topology: Any = None
    # None = no event records; a TelemetryConfig / True / dict records the
    # virtual-time trace (profile=True adds torch.profiler ranges)
    telemetry: Any = None
    # None = no failure model; a preset name ("chaos"), FaultConfig or dict
    faults: Any = None
    # None/False = off; True / a SanitizeConfig / a dict screens the buffer
    sanitize: Any = None
    # None = the tail's shape- and pipeline-aware default; an int routes by
    # size (0 forces the fused tail)
    agg_tail_threshold: Optional[int] = None
    # checkpoint_every > 0 snapshots the run into checkpoint_dir every N
    # server updates (async: flush boundaries; sync: round boundaries);
    # resume_from restores a snapshot and continues
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume_from: Optional[str] = None
    # --- rng plumbing ---
    fleet_seed: int = 0                     # profile sampling
    device_seed: int = 13                   # availability/dropout/latency


@dataclasses.dataclass
class GridResult:
    y: Any
    frozen: Any
    history: List[Dict[str, float]]
    comm: comm.CommReport
    seconds_per_round: float                # real wall-clock, synchronized
    virtual_seconds: float                  # simulated cross-device time
    fleet: dev_lib.Fleet
    mode: str
    scheduler_stats: Dict[str, int]
    # per-flush DP accounting (async mode with dp_noise_multiplier > 0):
    # flushes, padded_flushes, max_multiplicity, sigma, noise_multiplier,
    # epsilon, delta
    dp: Optional[Dict[str, float]] = None
    # per-tier breakdown (GridConfig.plan set): tier name -> {clients,
    # down_bytes, up_bytes, transfers, uploads, up_bytes_per_upload,
    # trainable_bytes, compute_seconds, rtt_mean}
    tier_stats: Optional[Dict[str, Dict[str, float]]] = None
    # the CompiledPlan the run used (None without a plan)
    plan: Any = None
    # the bound SelectionPolicy and BoundDynamics the run used
    policy: Any = None
    dynamics: Any = None
    # the bound Topology (None = flat); per-hop traffic in comm.hop_traffic
    topology: Any = None
    # the run's MetricsRegistry (always present); scheduler_stats is a
    # dict view over it
    metrics: Any = None
    # the Tracer when GridConfig.telemetry was set (else None)
    telemetry: Any = None
    # fired fault counters when GridConfig.faults was set
    faults: Optional[Dict[str, int]] = None

    @property
    def stats(self) -> Dict[str, int]:
        """Alias for ``scheduler_stats``."""
        return self.scheduler_stats


def num_clients(ds) -> int:
    if hasattr(ds, "num_clients"):
        return ds.num_clients
    return len(ds.client_tokens)


def _uplink_bytes(tree, bits: int) -> int:
    """Measured (serialized) uplink size when the wire format supports
    the payload (fp32 / int8); analytic int-k estimate otherwise."""
    if bits in (0, 8):
        return wire.uplink_bytes(tree, bits=bits)
    from repro_torch.core import compress
    return compress.quantized_uplink_bytes(tree, bits)


def _snapshot(plane, path: str, encode) -> str:
    """Write the grid-state snapshot ``encode()`` (meta, arrays) to
    ``path`` once a world: on a multi-rank mesh (``plane``) rank 0 of the
    world writes it and every rank waits at a barrier until it is on
    disk, since every rank holds the same host state; returns the file's
    path (with its suffix) on every rank."""
    world = (plane is not None and dist.is_initialized()
             and dist.get_world_size() > 1)
    if world and dist.get_rank() != 0:
        path = ckpt_lib.with_suffix(path)
    else:
        path = gstate_lib.save_state(path, *encode())
    if world:
        dist.barrier()
    return path


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_grid(init_fn: Callable[[int], Any], loss_fn: Callable, dataset,
             rc: fedpt.RoundConfig, rounds: int,
             grid: Optional[GridConfig] = None, freeze_spec=(),
             seed: int = 0, data_kind: str = "images", eval_every: int = 0,
             eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
             server_opt=None, log: bool = False, device=None) -> GridResult:
    """Train for `rounds` server updates on the simulated fleet. In sync
    mode a "round" is one cohort; in async mode it is one buffered server
    update (goal_count client deltas). ``init_fn(seed)`` returns the
    parameter tree; it is moved to ``device`` (CUDA by default; raises
    when there is none and the CPU was not asked for)."""
    dev = resolve_device(device)
    grid = grid or GridConfig()
    mesh = mesh_lib.resolve_mesh(grid.mesh, dev)
    N = num_clients(dataset)
    if rc.clients_per_round > N:
        raise ValueError(f"clients_per_round={rc.clients_per_round} exceeds "
                         f"the dataset's {N} clients")
    fleet = dev_lib.make_fleet(N, grid.fleet, seed=grid.fleet_seed)
    params = basic.tree_map(lambda t: t.to(dev), init_fn(seed))
    y, frozen = part.partition(params, freeze_spec)

    # the metrics registry is ALWAYS live (it backs scheduler_stats); the
    # tracer is the NULL no-op unless GridConfig.telemetry asks for records
    registry = metrics_lib.MetricsRegistry()
    tel_cfg = trace_lib.resolve_telemetry(grid.telemetry)
    tracer = (trace_lib.Tracer(tel_cfg, registry) if tel_cfg is not None
              else trace_lib.NULL_TRACER)
    profile = bool(tel_cfg and tel_cfg.profile)

    report = comm.report_for(y, frozen, uplink_bits=rc.uplink_bits)
    report.tracer = tracer
    # two-level topology: None keeps the flat single-hop grid; otherwise
    # every add_measured call mirrors into the client_edge hop ledger and
    # the grid bills the edge_server hop separately
    topo = topo_lib.resolve_topology(grid.topology, N)
    if topo is not None:
        report.bill_hops = True
    down_bytes = wire.downlink_bytes(y)          # y + 8-byte seed, measured
    up_bytes = _uplink_bytes(y, rc.uplink_bits)  # shape-determined
    compute_seconds = rc.local_steps * grid.base_step_time
    registry.gauge("payload_down_bytes").set(int(down_bytes))
    registry.gauge("payload_up_bytes").set(int(up_bytes))
    registry.gauge("compute_seconds").set(float(compute_seconds))

    # trainability plan: capability -> tier per client, tier-sliced uplink
    # payloads (the downlink stays the full y + seed for every tier), and
    # a per-tier compute charge on the virtual clock, scaled by the tier's
    # trainable fraction (the full tier's is exactly 1.0, so one-tier
    # plans keep the untiered clock)
    if grid.plan is not None:
        cplan = plan_lib.compile_plan(grid.plan, y)
        tier_of_client = dev_lib.assign_tiers(fleet, len(cplan.tiers),
                                              grid.tier_assignment)
        tier_up = np.asarray(
            [p["up"] for p in
             wire.tier_payloads(y, cplan, rc.uplink_bits).values()],
            np.int64)
        total_params = sum(cplan.layout.sizes)
        tier_compute = np.asarray(
            [compute_seconds * (t.param_count / total_params
                                if total_params else 1.0)
             for t in cplan.tiers], np.float64)
        for t in cplan.tiers:
            registry.gauge("tier_compute").set(float(tier_compute[t.index]),
                                               label=t.index)
    else:
        cplan = tier_of_client = tier_up = tier_compute = None

    data_rng = np.random.default_rng(seed + 77)  # == run_federated's stream
    dev_rng = np.random.default_rng([seed, grid.device_seed])
    # the dynamics stream: an independent child of [seed, device_seed];
    # spawning advances no draws of dev_rng
    dyn_rng = dev_rng.spawn(1)[0]
    dyn_cfg = dyn_lib.resolve_dynamics(grid.dynamics, fleet)
    dyn = dyn_cfg.bind(fleet, dyn_rng) if dyn_cfg is not None else None

    # the fault stream: a SECOND child, spawned ONLY when a failure model
    # is active, so faults=None runs see the same streams
    faults_cfg = faults_lib.resolve_faults(grid.faults)
    if faults_cfg is not None and grid.mode == "sync" \
            and faults_cfg.payload_prob > 0:
        raise ValueError(
            "sync mode supports only crash_compute and server_kill_at "
            "faults — payload faults (truncate/corrupt/duplicate) need "
            "the async per-client wire path")
    bfaults = (faults_cfg.bind(dev_rng.spawn(1)[0])
               if faults_cfg is not None else None)
    # the shock stream: a THIRD child, spawned ONLY when region shocks are
    # configured, so shock-free runs see the same streams
    shocks_cfg = dyn_cfg.shocks if dyn_cfg is not None else None
    if shocks_cfg is not None and topo is None:
        raise ValueError(
            "DynamicsConfig.shocks needs a topology (GridConfig."
            "topology): shocks down whole edge regions, and the flat "
            "grid has none")
    bshocks = (shocks_cfg.bind(topo.num_regions, dev_rng.spawn(1)[0],
                               tracer=tracer)
               if shocks_cfg is not None else None)
    san = sanitize_lib.resolve_sanitize(grid.sanitize)
    if grid.checkpoint_every > 0 and not grid.checkpoint_dir:
        raise ValueError("checkpoint_every > 0 needs a checkpoint_dir")

    # cohort-selection policy: estimates feed bandwidth-aware inclusion
    # probabilities and seed the adaptive policy's observed-RTT EMA
    policy = sel_lib.resolve_policy(grid.selection)
    est_up = (tier_up[tier_of_client] if cplan is not None
              else np.full(N, up_bytes, np.int64))
    est_comp = (tier_compute[tier_of_client] if cplan is not None
                else np.full(N, compute_seconds, np.float64))
    rtt_estimate = np.asarray(
        fleet.state.round_trip_seconds(down_bytes, est_up, est_comp),
        np.float64)
    policy.bind(fleet=fleet, num_clients=N, cplan=cplan,
                tiers=tier_of_client, rtt_estimate=rtt_estimate)

    common = dict(fleet=fleet, report=report, down_bytes=down_bytes,
                  up_bytes=up_bytes, compute_seconds=compute_seconds,
                  data_rng=data_rng, dev_rng=dev_rng, seed=seed,
                  data_kind=data_kind, eval_every=eval_every,
                  eval_fn=eval_fn, log=log, cplan=cplan,
                  tier_of_client=tier_of_client, tier_up=tier_up,
                  tier_compute=tier_compute, dyn=dyn, dyn_rng=dyn_rng,
                  policy=policy, registry=registry, tracer=tracer,
                  profile=profile, bfaults=bfaults, san=san, topo=topo,
                  bshocks=bshocks, dev=dev,
                  plane=shard_lib.flat_constrainer(mesh) if mesh else None)
    if grid.mode == "sync":
        return _run_sync(y, frozen, loss_fn, dataset, rc, rounds, grid,
                         server_opt, **common)
    if grid.mode == "async":
        return _run_async(y, frozen, loss_fn, dataset, rc, rounds, grid,
                          server_opt, **common)
    raise ValueError(f"unknown grid mode {grid.mode!r} "
                     "(expected 'sync' or 'async')")


# ---------------------------------------------------------------------------
# Synchronous cohorts


# the normalized scheduler-stats schema: BOTH modes emit every key, with
# explicit zeros where a counter cannot fire
STAT_KEYS = ("dispatches", "uploads", "offline", "dropouts",
             "deadline_drops", "excess", "retries",
             "crashes", "truncated", "corrupted", "duplicates",
             "quarantined")


def _stats_view(registry: metrics_lib.MetricsRegistry) -> Dict[str, int]:
    """GridResult.scheduler_stats as a dict view over the metrics
    registry."""
    return {k: int(registry.counter(k).value) for k in STAT_KEYS}


def _tier_stats(report, cplan, tier_of_client,
                registry: metrics_lib.MetricsRegistry):
    """GridResult.tier_stats: the comm ledger's per-tier traffic plus the
    fleet census (the run's final tier map, which the rotation / adaptive
    policies move), the measured bytes per upload, the tier's compute
    charge per local run and the mean observed round trip of its uploads
    (timing and compute from the registry, labels = tier indices)."""
    if cplan is None:
        return None
    rtt_sum = registry.counter("tier_rtt_sum")
    rtt_n = registry.counter("tier_rtt_n")
    compute = registry.gauge("tier_compute")
    out = {}
    for t in cplan.tiers:
        rec = dict(report.tier_traffic.get(
            t.name, {"down_bytes": 0, "up_bytes": 0, "transfers": 0,
                     "uploads": 0}))
        rec["clients"] = int(np.sum(tier_of_client == t.index))
        rec["up_bytes_per_upload"] = (rec["up_bytes"] / rec["uploads"]
                                      if rec["uploads"] else 0.0)
        rec["trainable_bytes"] = t.trainable_bytes
        rec["compute_seconds"] = float(compute.get(t.index, 0.0))
        n = rtt_n.get(t.index, 0)
        rec["rtt_mean"] = (rtt_sum.get(t.index, 0.0) / n) if n else 0.0
        out[t.name] = rec
    return out


def _faults_view(registry: metrics_lib.MetricsRegistry,
                 bfaults) -> Optional[Dict[str, int]]:
    """GridResult.faults: the fired-fault counters, when a failure model
    was active (quarantined rows ride along)."""
    if bfaults is None:
        return None
    return {k: int(registry.counter(k).value)
            for k in ("crashes", "truncated", "corrupted", "duplicates",
                      "quarantined")}


def _run_sync(y, frozen, loss_fn, dataset, rc, rounds, grid, server_opt, *,
              fleet, report, down_bytes, up_bytes, compute_seconds,
              data_rng, dev_rng, seed, data_kind, eval_every, eval_fn, log,
              cplan, tier_of_client, tier_up, tier_compute, dyn, dyn_rng,
              policy, registry, tracer, profile, bfaults, san, topo, bshocks,
              dev, plane):
    # a trivial (one-tier) plan routes through the untiered round
    tiered = cplan is not None and not cplan.trivial
    round_fn, sopt = fedpt.make_round_fn(
        loss_fn, rc, server_opt=server_opt, device=dev, sanitize=san,
        fused_threshold=grid.agg_tail_threshold, plan=cplan,
        constrain_flat_fn=plane)
    round_fn = prof_lib.annotate(round_fn, "grid/round_fn", enabled=profile,
                                 cuda=dev.type == "cuda")
    sstate = sopt.init(y)
    N = num_clients(dataset)
    C = rc.clients_per_round
    m = min(N, max(C, int(math.ceil(C * grid.over_selection))))
    # one pre-reduced fp32 flat buffer per active edge per round
    # (shape-determined, so measured once)
    edge_bytes = wire.edge_flush_bytes(y) if topo is not None else 0

    # every live RNG stream a snapshot must capture (the fault stream only
    # exists when a failure model is active)
    rngs = {"data": data_rng, "dev": dev_rng, "dyn": dyn_rng}
    if bfaults is not None:
        rngs["fault"] = bfaults.rng

    history: List[Dict[str, float]] = []
    mc = registry.counter
    vt = 0.0
    start_round = 0
    last_ckpt: Optional[str] = None
    if grid.resume_from:
        meta, arrays = gstate_lib.load_state(grid.resume_from)
        y, sstate, start_round, vt, history = gstate_lib.decode_sync(
            meta, arrays, sstate_template=sstate, rngs=rngs,
            policy=policy, registry=registry, report=report, dev=dev,
            shocks=bshocks, topo=topo)
        last_ckpt = grid.resume_from
    t0 = None
    for r in range(start_round, rounds):
        if bfaults is not None and vt > bfaults.kill_at:
            raise faults_lib.ServerKilled(at=vt, applied=r,
                                          checkpoint=last_ckpt)
        # the policy's tier map can move between rounds (tier-rotation,
        # adaptive-capability); static policies return the bound map
        tiers_now = policy.current_tiers() if cplan is not None else None
        cids = policy.select_cohort(data_rng, m)
        # tier-sliced uplinks and per-tier compute feed the virtual clock
        cohort_up = (tier_up[tiers_now[cids]] if cplan is not None
                     else up_bytes)
        cohort_comp = (tier_compute[tiers_now[cids]] if cplan is not None
                       else compute_seconds)
        cohort_regions = topo.region_of[cids] if topo is not None else None
        plan = sched_lib.plan_sync_round(
            fleet, cids, down_bytes, cohort_up, cohort_comp, C, dev_rng,
            deadline=grid.straggler_deadline, dynamics=dyn,
            dyn_rng=dyn_rng, now=vt, tracer=tracer,
            tiers=tiers_now[cids] if cplan is not None else None,
            faults=bfaults, shocks=bshocks, regions=cohort_regions)
        # the C slots the round engine sees: participants in arrival
        # order, padded (weight 0) with the remaining cohort in dispatch
        # order when drops leave the round short
        kept_cids = plan.participant_cids()
        pad = plan.cids[~plan.participant][:C - len(kept_cids)]
        sel = np.concatenate([kept_cids, pad]).astype(np.int64)
        kept = np.arange(C) < len(kept_cids)

        batch, w = syn.cohort_batch(dataset, sel, rc.local_steps,
                                    rc.local_batch, data_rng, kind=data_kind)
        w = np.where(kept, w, 0.0).astype(np.float32)
        if not policy.trivial and not (rc.uniform_weights
                                       or rc.dp_clip_norm > 0):
            # importance-unbiased selection weights; dropped under DP,
            # whose fixed-denominator uniform weighting calibrates sigma
            iw = policy.cohort_weights(sel)
            if iw is not None:
                w = (w * iw).astype(np.float32)
        args = (y, sstate, frozen, batch, w)
        if tiered:
            args += (tiers_now[sel].astype(np.int64),)
        y, sstate, rmetrics = round_fn(*args,
                                       threefry.key(seed * 100_003 + r))
        if t0 is None:
            _synchronize(dev)
            t0 = time.time()  # exclude the first round from the timing
        loss = float(rmetrics["loss"])   # the one host sync of the round
        vt0, vt = vt, vt + plan.round_seconds
        rseq = tracer.span("round", vt0, plan.round_seconds,
                           parent=plan.bound_seq, round=r,
                           participants=float(len(kept_cids)),
                           cohort=int(m), loss=loss)
        if san is not None:
            nonf = rmetrics["quarantine_nonfinite"].cpu().numpy()
            outl = rmetrics["quarantine_outlier"].cpu().numpy()
            norms = rmetrics["quarantine_norms"].cpu().numpy()
            for i in np.nonzero(nonf | outl)[0]:
                mc("quarantined").inc()
                tracer.instant(
                    "quarantine", vt0, parent=rseq,
                    cause="nonfinite" if nonf[i] else "norm-outlier",
                    cid=int(sel[i]),
                    tier=(int(tiers_now[sel[i]]) if cplan is not None
                          else None),
                    norm=float(norms[i]), round=r)
        registry.histogram("round_seconds").observe(plan.round_seconds)
        n_dispatched = int(np.sum(plan.dispatched))
        n_uploads = n_dispatched - plan.dropouts
        # observed round trips flow back to the policy (adaptive
        # re-tiering) and into the per-tier timing stats
        for i in np.nonzero(plan.completed)[0]:
            rtt = float(plan.arrival[i])
            policy.observe(int(plan.cids[i]), rtt)
            registry.histogram("upload_rtt").observe(rtt)
            if cplan is not None:
                t_idx = int(tiers_now[plan.cids[i]])
                mc("tier_rtt_sum").inc(rtt, label=t_idx)
                mc("tier_rtt_n").inc(label=t_idx)
        if cplan is not None:
            # bill per tier: dispatches pay the (tier-invariant) downlink,
            # uploads pay the tier-sliced uplink
            cohort_tiers = tiers_now[plan.cids]
            uploaded = np.isfinite(plan.arrival)
            for t in cplan.tiers:
                sel_t = cohort_tiers == t.index
                nd = int(np.sum(plan.dispatched & sel_t))
                nu = int(np.sum(uploaded & sel_t))
                if nd or nu:
                    report.add_tier_measured(
                        t.name, down_bytes * nd, int(tier_up[t.index]) * nu,
                        transfers=nd, uploads=nu, now=vt, parent=rseq)
        else:
            report.add_measured(down_bytes * n_dispatched,
                                up_bytes * n_uploads,
                                transfers=n_dispatched)
        if topo is not None:
            # hierarchical hop billing: every region with a dispatch
            # downloads one model payload server->edge; every region with a
            # completed upload pre-reduces its members' deltas and flushes
            # one flat buffer upstream
            disp_counts = np.bincount(cohort_regions[plan.dispatched],
                                      minlength=topo.num_regions)
            up_counts = np.bincount(cohort_regions[plan.completed],
                                    minlength=topo.num_regions)
            for k in np.nonzero(disp_counts)[0]:
                mc("region_dispatches").inc(int(disp_counts[k]),
                                            label=int(k))
            active = np.nonzero(up_counts)[0]
            for k in active:
                mc("region_uploads").inc(int(up_counts[k]), label=int(k))
                mc("edge_flushes").inc(label=int(k))
                mc("edge_up_bytes").inc(edge_bytes, label=int(k))
                tracer.instant("edge_flush", vt, parent=rseq,
                               region=int(k), fill=int(up_counts[k]),
                               up_bytes=edge_bytes, round=r)
            n_down = int(np.sum(disp_counts > 0))
            report.add_hop("edge_server", down_bytes=down_bytes * n_down,
                           up_bytes=edge_bytes * len(active),
                           transfers=n_down, uploads=len(active))
        mc("dispatches").inc(n_dispatched)
        mc("uploads").inc(n_uploads)
        mc("offline").inc(plan.offline)
        mc("dropouts").inc(plan.dropouts)
        mc("deadline_drops").inc(plan.deadline_drops)
        mc("excess").inc(plan.excess)
        mc("retries").inc(plan.retries)
        mc("crashes").inc(plan.crashes)

        rec = {"round": r, "loss": loss}
        if eval_fn and eval_every and (r + 1) % eval_every == 0:
            rec.update(eval_fn(part.merge(y, frozen)))
        rec["virtual_seconds"] = vt
        rec["participants"] = float(len(kept_cids))
        history.append(rec)
        policy.end_round(r)
        if grid.checkpoint_every > 0 \
                and (r + 1) % grid.checkpoint_every == 0:
            last_ckpt = _snapshot(
                plane, gstate_lib.checkpoint_path(grid.checkpoint_dir, r + 1,
                                                  "sync"),
                lambda: gstate_lib.encode_sync(
                    y=y, sstate=sstate, round_idx=r, now=vt,
                    history=history, rngs=rngs, policy=policy,
                    registry=registry, report=report, shocks=bshocks,
                    topo=topo))
            mc("checkpoints").inc()
            tracer.instant("checkpoint", vt, parent=rseq, path=last_ckpt,
                           round=r, mode="sync")
        if log and (r % max(1, rounds // 10) == 0):
            print(f"  round {r}: " + " ".join(
                f"{k}={v:.4f}" for k, v in rec.items() if k != "round"))
    _synchronize(dev)
    spr = ((time.time() - t0) / max(rounds - start_round - 1, 1) if t0
           else float("nan"))
    final_tiers = (policy.current_tiers() if cplan is not None
                   else tier_of_client)
    if tracer.enabled:
        tracer.flush_outputs()
    return GridResult(y=y, frozen=frozen, history=history, comm=report,
                      seconds_per_round=spr, virtual_seconds=vt,
                      fleet=fleet, mode="sync",
                      scheduler_stats=_stats_view(registry),
                      tier_stats=_tier_stats(report, cplan, final_tiers,
                                             registry),
                      plan=cplan, policy=policy, dynamics=dyn,
                      topology=topo, metrics=registry,
                      telemetry=tracer if tracer.enabled else None,
                      faults=_faults_view(registry, bfaults))


# ---------------------------------------------------------------------------
# Buffered async (FedBuff)


class _LaneCell:
    """Handle for a client step deferred into a lane batch: filled with
    this client's own (delta row, loss) when the lane executes. The row
    is cloned out of the (lane, size) batch, so a straggler entry keeps
    one (size,) row alive, not the whole batch."""
    __slots__ = ("delta", "loss")

    def __init__(self):
        self.delta = None

    def resolve(self):
        return self.delta, self.loss


def _run_async(y, frozen, loss_fn, dataset, rc, rounds, grid, server_opt, *,
               fleet, report, down_bytes, up_bytes, compute_seconds,
               data_rng, dev_rng, seed, data_kind, eval_every, eval_fn, log,
               cplan, tier_of_client, tier_up, tier_compute, dyn, dyn_rng,
               policy, registry, tracer, profile, bfaults, san, topo,
               bshocks, dev, plane):
    if server_opt is None:
        server_opt = fedpt.resolve_server_opt(rc)
    # trivial plans keep the untiered engines (lane-exact); per-tier
    # metering still runs off the scheduler's tier counters
    tiered = cplan is not None and not cplan.trivial
    # per-flush DP: the flush (goal_count buffered deltas, fixed
    # denominator) is the unit of composition — see core/dp.py
    flush_dp = accountant = None
    if rc.dp_noise_multiplier > 0:
        if rc.dp_clip_norm <= 0:
            raise ValueError("async DP noise needs dp_clip_norm > 0 "
                             "(per-client clipping bounds the flush "
                             "sensitivity)")
        flush_dp = dp_lib.FlushDPConfig(
            clip_norm=rc.dp_clip_norm,
            noise_multiplier=rc.dp_noise_multiplier,
            goal_count=grid.goal_count)
        accountant = dp_lib.FlushAccountant(flush_dp, tracer=tracer)
    lane = grid.goal_count if grid.lanes is None else int(grid.lanes)
    # one engine per tier: lanes are tier-homogeneous (pending clients
    # group by tier below), each at its tier's (lane, tier_size) width
    tier_keys = [t.index for t in cplan.tiers] if tiered else [None]

    def engine_kw(k):
        return ({} if k is None else
                dict(tier=cplan.tiers[k], plan=cplan))
    # profiler ranges around the hot paths, so a wall-time profile lines
    # up with the virtual-time spans
    cuda = dev.type == "cuda"
    if lane > 0:
        lane_steps = prof_lib.annotate_map(
            {k: fedpt.make_lane_step(loss_fn, rc, lane, device=dev,
                                     constrain_flat_fn=plane,
                                     **engine_kw(k))
             for k in tier_keys}, "grid/lane_step", enabled=profile,
            cuda=cuda)
    else:
        client_steps = prof_lib.annotate_map(
            {k: fedpt.make_client_step(loss_fn, rc, device=dev,
                                       **engine_kw(k))
             for k in tier_keys}, "grid/client_step", enabled=profile,
            cuda=cuda)
    apply_fn = prof_lib.annotate(
        fedpt.make_buffered_apply(
            server_opt, flush_dp=flush_dp, plan=cplan, sanitize=san,
            fused_threshold=grid.agg_tail_threshold, device=dev,
            constrain_flat_fn=plane),
        "grid/server_apply", enabled=profile, cuda=cuda)
    staleness_fn = fedpt.get_staleness_fn(grid.staleness, **grid.staleness_kw)
    if flush_dp is not None:
        # the per-flush sensitivity bound (clip_norm / goal_count) assumes
        # aggregation weights in [0, 1]
        inner_staleness = staleness_fn

        def staleness_fn(s):
            w = inner_staleness(s)
            if not 0.0 <= w <= 1.0:
                raise ValueError(
                    f"staleness weight {w} for staleness {s} is outside "
                    "[0, 1]: per-flush DP calibrates sigma for weights "
                    "<= 1 (use a non-amplifying staleness_fn with DP)")
            return w
    N = num_clients(dataset)
    batch_fn = (syn.client_batch_images if data_kind == "images"
                else syn.client_batch_tokens)
    # one pre-reduced fp32 flat buffer per active edge per flush
    # (shape-determined, so measured once)
    edge_bytes = wire.edge_flush_bytes(y) if topo is not None else 0

    # mutable server state shared with the scheduler callbacks; events are
    # processed in virtual-time order, so "the model right now" is exactly
    # what a client dispatched at the current event time downloads
    state = {"y": y, "sstate": server_opt.init(y), "applied": 0}
    # lane mode: client steps dispatched since the last flush, grouped by
    # tier (each group runs as lane batches at its tier's width). They all
    # trained on the model of the CURRENT server version (y only changes
    # at flushes), so running them as (lane, ...) batches at the next
    # flush is exactly the sequential semantics.
    pending: Dict[Any, List] = {k: [] for k in tier_keys}

    def run_pending():
        for key, queue in pending.items():
            while queue:
                chunk = queue[:lane]
                del queue[:len(chunk)]
                n = len(chunk)
                # pad short lanes with a repeat of the last real batch:
                # one fixed (lane, ...) shape
                stacked = {k: np.stack([b[k] for b, _ in chunk]
                                       + [chunk[-1][0][k]] * (lane - n))
                           for k in chunk[0][0]}
                deltas, losses = lane_steps[key](state["y"], frozen, stacked)
                for i, (_, cell) in enumerate(chunk):
                    cell.delta, cell.loss = deltas[i].clone(), losses[i]

    def tier_of(cid):
        # the policy's map, queried at dispatch time (rotation / adaptive
        # policies move it between server updates)
        return (int(policy.current_tiers()[cid]) if cplan is not None
                else None)

    def run_client(cid, version):
        b, w = batch_fn(dataset, cid, rc.local_steps, rc.local_batch,
                        data_rng)
        if rc.uniform_weights or rc.dp_clip_norm > 0:
            w = 1.0  # DP / uniform weighting, as in the sync engine
        elif not policy.trivial:
            w = w * policy.client_weight(cid)
        # the payload size is shape-determined: the once-measured
        # (tier-sliced under a plan) value
        t = tier_of(cid)
        up = int(tier_up[t]) if cplan is not None else up_bytes
        key = t if tiered else None
        if lane > 0:
            cell = _LaneCell()
            pending[key].append((b, cell))
            return {"cell": cell, "weight": w, "up_bytes": up,
                    "cid": cid, "tier": t}
        delta, metrics = client_steps[key](state["y"], frozen, b)
        # the loss stays a device scalar: converted once per flush
        return {"delta": delta, "loss": metrics["client_loss"],
                "weight": w, "up_bytes": up, "cid": cid, "tier": t}

    def entry_arrays(e):
        cell = e.work.get("cell")
        if cell is not None:
            return cell.resolve()
        return e.work["delta"], e.work["loss"]

    def apply_update(entries, now, version):
        if lane > 0:
            run_pending()
        rows, losses = [], []
        for e in entries:
            d, l = entry_arrays(e)
            f = e.work.get("fault")
            if f is not None and f["kind"] in ("nan", "bitflip"):
                # materialize the wire corruption from the per-event seed
                d = torch.as_tensor(faults_lib.corrupt_row(
                    d.cpu().numpy(), f["kind"], f["seed"], bfaults.cfg),
                    device=dev)
            rows.append(d)
            losses.append(l)
        wts = [e.weight for e in entries]
        # pad a short (drained) flush to the fixed goal_count shape with
        # zero-weight rows: under DP the fixed-denominator mean and the
        # per-flush sigma never change
        flat_deltas = flat_lib.pad_rows(torch.stack(rows), grid.goal_count)
        wts = wts + [0.0] * (grid.goal_count - len(entries))
        args = (state["y"], state["sstate"], flat_deltas,
                np.asarray(wts, np.float32))
        if tiered:
            # per-row tier ids drive the apply's block masks; padding rows
            # carry tier 0 and weight 0 and fall out of both means
            args += (np.asarray([e.work["tier"] for e in entries]
                                + [0] * (grid.goal_count - len(entries)),
                                np.int64),)
        if flush_dp is not None:
            # one threefry key per flush, from the sync engine's stream
            args += (threefry.key(seed * 100_003 + state["applied"]),)
            # dispatch samples clients WITH replacement, so one client may
            # own several rows of this flush
            counts = Counter(e.work["cid"] for e in entries)
            accountant.record_flush(len(entries),
                                    multiplicity=max(counts.values()),
                                    now=now, parent=sched.last_flush_seq)
        y_new, ss, m = apply_fn(*args)
        state["y"], state["sstate"] = y_new, ss
        # ONE host sync per flush for the buffered losses
        out = {"loss": float(torch.stack(losses).mean()),
               "delta_norm": float(m["delta_norm"])}
        applied = state["applied"]
        if san is not None:
            nonf = m["quarantine_nonfinite"].cpu().numpy()
            outl = m["quarantine_outlier"].cpu().numpy()
            norms = m["quarantine_norms"].cpu().numpy()
            for i in np.nonzero((nonf | outl)[:len(entries)])[0]:
                registry.counter("quarantined").inc()
                tracer.instant(
                    "quarantine", now, parent=sched.last_flush_seq,
                    cause="nonfinite" if nonf[i] else "norm-outlier",
                    cid=int(entries[i].work["cid"]),
                    tier=(None if entries[i].work.get("tier") is None
                          else int(entries[i].work["tier"])),
                    norm=float(norms[i]), flush=applied)
        if topo is not None and entries:
            # edge pre-reduce on the rows' device: this flush's rows grouped
            # by uploader region — each edge's (size,) buffer is what it
            # transmits upstream (billed on the edge_server hop at the end
            # of the run). The server reduce above consumed the same rows,
            # so the model path is topology-invariant.
            regs = topo.region_of[[int(e.work["cid"]) for e in entries]]
            ebuf = topo_lib.edge_reduce(flat_deltas[:len(entries)],
                                        wts[:len(entries)], regs,
                                        topo.num_regions)
            # the R norms in one copy, and only for a tracer that records
            enorm = (torch.linalg.vector_norm(ebuf, dim=1).cpu().numpy()
                     if tracer.enabled else None)
            counts = np.bincount(regs, minlength=topo.num_regions)
            for k in np.nonzero(counts)[0]:
                registry.counter("edge_flushes").inc(label=int(k))
                registry.counter("edge_up_bytes").inc(edge_bytes,
                                                      label=int(k))
                registry.counter("edge_down_bytes").inc(down_bytes,
                                                        label=int(k))
                if enorm is not None:
                    tracer.instant("edge_flush", now,
                                   parent=sched.last_flush_seq,
                                   region=int(k), fill=int(counts[k]),
                                   up_bytes=edge_bytes,
                                   norm=float(enorm[k]), flush=applied)
        state["applied"] = applied + 1
        if eval_fn and eval_every and state["applied"] % eval_every == 0:
            out.update(eval_fn(part.merge(y_new, frozen)))
        # a flush is the async "round": rotation / adaptive policies step
        # their tier maps here
        policy.end_round(applied)
        return out

    # every live RNG stream a snapshot must capture (the fault stream only
    # exists when a failure model is active)
    rngs = {"data": data_rng, "dev": dev_rng, "dyn": dyn_rng}
    if bfaults is not None:
        rngs["fault"] = bfaults.rng
    last_ckpt = {"path": None}

    def checkpoint_hook(s, now):
        # called by the scheduler after every full-buffer flush — the one
        # boundary where run_pending() has resolved every lane cell
        if state["applied"] % grid.checkpoint_every != 0:
            return
        path = _snapshot(
            plane, gstate_lib.checkpoint_path(grid.checkpoint_dir,
                                              state["applied"], "async"),
            lambda: gstate_lib.encode_async(
                state=state, sched=s, rngs=rngs, accountant=accountant,
                policy=policy, registry=registry, shocks=bshocks,
                topo=topo))
        last_ckpt["path"] = path
        registry.counter("checkpoints").inc()
        tracer.instant("checkpoint", now, parent=s.last_flush_seq,
                       path=path, applied=state["applied"], mode="async",
                       buffer_fill=float(len(s.buffer)),
                       events_in_flight=len(s.q))

    sched = sched_lib.BufferedAsyncScheduler(
        fleet=fleet, concurrency=min(grid.concurrency, N),
        goal_count=grid.goal_count, staleness_fn=staleness_fn,
        sample_cid=policy.sample_cid, run_client=run_client,
        apply_update=apply_update, down_bytes=down_bytes,
        compute_seconds=compute_seconds, rng=dev_rng,
        tier_of=tier_of if cplan is not None else None,
        compute_of=((lambda cid: float(tier_compute[tier_of(cid)]))
                    if cplan is not None else None),
        region_of=((lambda cid: int(topo.region_of[cid]))
                   if topo is not None else None),
        shocks=bshocks,
        dynamics=dyn, dyn_rng=dyn_rng, observe=policy.observe,
        tracer=tracer, metrics=registry, faults=bfaults,
        checkpoint_hook=(checkpoint_hook if grid.checkpoint_every > 0
                         else None))
    if grid.resume_from:
        gstate_lib.decode_async(
            *gstate_lib.load_state(grid.resume_from), state=state,
            sched=sched, sstate_template=state["sstate"], rngs=rngs,
            accountant=accountant, policy=policy, registry=registry,
            dev=dev, shocks=bshocks, topo=topo,
            make_cell=_LaneCell if lane > 0 else None)
        last_ckpt["path"] = grid.resume_from
    t_wall = time.time()
    try:
        history = sched.run(rounds, deadline=grid.async_deadline)
    except faults_lib.ServerKilled as e:
        # annotate the kill with the latest snapshot so callers can resume
        # (None when checkpointing was off)
        e.checkpoint = last_ckpt["path"]
        raise
    _synchronize(dev)
    spr = (time.time() - t_wall) / max(rounds, 1)
    if log:
        for rec in history[:: max(1, rounds // 10)]:
            print(f"  update {rec['round']}: " + " ".join(
                f"{k}={v:.4f}" for k, v in rec.items() if k != "round"))

    vt = history[-1]["virtual_seconds"] if history else 0.0
    if cplan is not None:
        for t in cplan.tiers:
            nd = sched.tier_dispatches.get(t.index, 0)
            if nd or sched.tier_uploads.get(t.index, 0):
                report.add_tier_measured(
                    t.name, down_bytes * nd,
                    sched.tier_up_bytes.get(t.index, 0), transfers=nd,
                    uploads=sched.tier_uploads.get(t.index, 0), now=vt,
                    parent=sched.last_flush_seq)
    else:
        report.add_measured(down_bytes * sched.dispatches,
                            sched.up_bytes_total,
                            transfers=sched.dispatches)
    if topo is not None:
        # the edge_server hop, billed from the registry's per-region edge
        # counters (snapshotted with the run, so a resumed run bills it
        # exactly)
        n_flush = int(registry.counter("edge_flushes").value)
        report.add_hop(
            "edge_server",
            down_bytes=int(registry.counter("edge_down_bytes").value),
            up_bytes=int(registry.counter("edge_up_bytes").value),
            transfers=n_flush, uploads=n_flush)
    final_tiers = (policy.current_tiers() if cplan is not None
                   else tier_of_client)
    if tracer.enabled:
        tracer.flush_outputs()
    return GridResult(y=state["y"], frozen=frozen, history=history,
                      comm=report, seconds_per_round=spr,
                      virtual_seconds=vt, fleet=fleet, mode="async",
                      scheduler_stats=_stats_view(registry),
                      dp=accountant.summary() if accountant else None,
                      tier_stats=_tier_stats(report, cplan, final_tiers,
                                             registry),
                      plan=cplan, policy=policy, dynamics=dyn,
                      topology=topo, metrics=registry,
                      telemetry=tracer if tracer.enabled else None,
                      faults=_faults_view(registry, bfaults))
