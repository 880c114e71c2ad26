"""Federated simulation grid: heterogeneity-aware client populations,
device dynamics (stochastic links, trace-driven availability), an
event-driven virtual-clock scheduler (synchronous cohorts with
straggler deadlines / over-selection, and FedBuff-style buffered async
aggregation), pluggable tier-aware cohort-selection policies, a
two-level edge topology, and wire-level communication metering.

Fleets, schedulers, dynamics, faults and selection policies are copies
of ``repro/sim``; the wire ledger, the topology's edge pre-reduce and
the grid entry point are ports. ``fl.runtime.run_federated`` is the
homogeneous-synchronous special case of ``sim.grid.run_grid``.
"""
from repro_torch.sim.devices import (DeviceProfile, Fleet, FleetState,
                                     make_fleet, FLEET_PRESETS, assign_tiers,
                                     capability_score, quantile_tiers)
from repro_torch.sim.dynamics import (LinkModel, AvailabilityTrace, AlwaysOn,
                                      DiurnalTrace, StepTrace, DynamicsConfig,
                                      RegionShocks, DYNAMICS_PRESETS,
                                      resolve_dynamics)
from repro_torch.sim.topology import (TopologyConfig, Topology,
                                      resolve_topology, edge_reduce)
from repro_torch.obs.trace import TelemetryConfig
from repro_torch.sim.grid import GridConfig, GridResult, run_grid
from repro_torch.sim.scheduler import (EventQueue, SyncRoundPlan,
                                       plan_sync_round,
                                       BufferedAsyncScheduler)
from repro_torch.sim.selection import (SelectionPolicy, UniformPolicy,
                                       BandwidthAwarePolicy,
                                       TierRotationPolicy,
                                       AdaptiveCapabilityPolicy, POLICIES,
                                       resolve_policy)
from repro_torch.sim import wire
