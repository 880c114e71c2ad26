"""Communication-cost accounting (the paper's Tables 1-3 'Reduction in
Communication' column).

Per round, generalized FedAvg moves:
  download:  full model                    -> FedPT: trainable y + 8B seed
  upload:    full model update             -> FedPT: trainable delta
so the per-round reduction is 2*|x| / (2*|y| + seed). The uplink-only
reduction (|x|/|y|) is also reported since uplink is the scarcer resource
(0.25MB/s vs 0.75MB/s; Wang et al. 2021b).

With uplink quantization on (RoundConfig.uplink_bits > 0) the uplink
payload is the int-k delta plus one f32 scale per leaf — the ledger uses
``compress.quantized_uplink_bytes`` for it, not fp32 trainable bytes.

The analytic columns above are *predictions*; the simulation grid
(repro/sim/wire.py) serializes real payloads and records the observed
totals in ``measured_down_bytes`` / ``measured_up_bytes`` so the two can
be cross-checked (they must agree exactly for fp32 payloads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.core import compress
from repro_torch.nn import basic
from repro_torch.obs import trace as trace_lib

SEED_BYTES = 8

# Measured cross-device links (Wang et al. 2021b): download 0.75 MB/s,
# upload 0.25 MB/s. The "uniform" fleet preset in repro/sim/devices.py
# uses the same constants.
DOWNLINK_MBPS = 0.75
UPLINK_MBPS = 0.25


@dataclasses.dataclass
class CommReport:
    full_bytes: int
    trainable_bytes: int
    rounds: int = 1
    # uplink quantization (0 = fp32 uplink). When set, uploads cost
    # `quantized_trainable_bytes` per client-round instead of fp32 bytes.
    uplink_bits: int = 0
    quantized_trainable_bytes: int = 0
    # wire-level totals observed by the simulation grid (sum over every
    # client transfer actually performed); 0 until metered.
    measured_down_bytes: int = 0
    measured_up_bytes: int = 0
    transfers: int = 0
    # per-trainability-tier breakdown of the measured totals (filled by
    # the grid when a core/plan.py TrainPlan is active): tier name ->
    # {down_bytes, up_bytes, transfers, uploads}. Uplink is billed at
    # the tier's sliced payload; downlink is tier-invariant (every tier
    # downloads the full trainable tree — see core/plan.py).
    tier_traffic: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # per-hop breakdown under a two-level topology (sim/topology.py):
    # hop name ("client_edge" / "edge_server") -> {down_bytes, up_bytes,
    # transfers, uploads}. The client_edge hop carries exactly the
    # transfers the legacy measured_* totals meter (hop == global totals
    # by construction); the edge_server hop is the *additional* traffic
    # hierarchical aggregation introduces — one pre-reduced flat buffer
    # up and one model payload down per active region per flush.
    hop_traffic: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # set by the grid when a topology is active: every add_measured /
    # add_tier_measured call then mirrors into hop_traffic["client_edge"]
    # (one metering entry point, so the hop ledger can never drift from
    # the legacy totals). Plumbing, not ledger state.
    bill_hops: bool = dataclasses.field(default=False, repr=False,
                                        compare=False)
    # the telemetry tracer the grid threads through (obs/trace.py):
    # tier-sliced wire billing emits one ``tier_upload`` instant per
    # metered batch. NULL_TRACER (the default) emits nothing; never
    # part of equality/repr — it is plumbing, not ledger state.
    tracer: Any = dataclasses.field(default=trace_lib.NULL_TRACER,
                                    repr=False, compare=False)

    @property
    def download_full(self) -> int:
        return self.full_bytes * self.rounds

    @property
    def download_fedpt(self) -> int:
        return (self.trainable_bytes + SEED_BYTES) * self.rounds

    @property
    def upload_full(self) -> int:
        return self.full_bytes * self.rounds

    @property
    def upload_fedpt(self) -> int:
        per_round = (self.quantized_trainable_bytes
                     if self.uplink_bits and self.quantized_trainable_bytes
                     else self.trainable_bytes)
        return per_round * self.rounds

    @property
    def reduction(self) -> float:
        return (self.download_full + self.upload_full) / max(
            self.download_fedpt + self.upload_fedpt, 1)

    @property
    def uplink_reduction(self) -> float:
        return self.upload_full / max(self.upload_fedpt, 1)

    def per_client_round_mb(self) -> Dict[str, float]:
        mb = 1024.0 * 1024.0
        return {
            "full_down_mb": self.full_bytes / mb,
            "full_up_mb": self.full_bytes / mb,
            "fedpt_down_mb": (self.trainable_bytes + SEED_BYTES) / mb,
            "fedpt_up_mb": self.upload_fedpt / self.rounds / mb,
        }

    # estimated wall-clock on the measured cross-device links
    def transfer_seconds(self, fedpt: bool = True) -> float:
        mb = 1024.0 * 1024.0
        down = (self.download_fedpt if fedpt else self.download_full) / mb
        up = (self.upload_fedpt if fedpt else self.upload_full) / mb
        return down / DOWNLINK_MBPS + up / UPLINK_MBPS

    # --- wire-level metering (filled in by repro/sim) -------------------
    def add_measured(self, down_bytes: int, up_bytes: int,
                     transfers: int = 1) -> None:
        """Accumulate observed serialized payload sizes for `transfers`
        client round-trips."""
        self.measured_down_bytes += int(down_bytes)
        self.measured_up_bytes += int(up_bytes)
        self.transfers += int(transfers)
        if self.bill_hops:
            self.add_hop("client_edge", down_bytes=down_bytes,
                         up_bytes=up_bytes, transfers=transfers)

    def add_tier_measured(self, tier: str, down_bytes: int, up_bytes: int,
                          transfers: int = 1, uploads: int = 0,
                          now: float = 0.0, parent=None) -> None:
        """Accumulate observed bytes for one trainability tier AND the
        global totals (callers meter through one entry point — never
        call both this and ``add_measured`` for the same transfers).
        ``now`` stamps the tracer's ``tier_upload`` billing instant in
        virtual time, ``parent`` links it to the round/flush that billed
        it (both ignored with the default NULL_TRACER)."""
        rec = self.tier_traffic.setdefault(
            tier, {"down_bytes": 0, "up_bytes": 0, "transfers": 0,
                   "uploads": 0})
        rec["down_bytes"] += int(down_bytes)
        rec["up_bytes"] += int(up_bytes)
        rec["transfers"] += int(transfers)
        rec["uploads"] += int(uploads)
        self.add_measured(down_bytes, up_bytes, transfers)
        self.tracer.instant("tier_upload", now, parent=parent,
                            tier_name=tier,
                            down_bytes=int(down_bytes),
                            up_bytes=int(up_bytes),
                            transfers=int(transfers),
                            uploads=int(uploads))

    def add_hop(self, hop: str, down_bytes: int = 0, up_bytes: int = 0,
                transfers: int = 0, uploads: int = 0) -> None:
        """Accumulate observed bytes on one topology hop. The
        ``client_edge`` hop is fed automatically by ``add_measured`` when
        ``bill_hops`` is set; the grid calls this directly for the
        ``edge_server`` hop (edge flush buffers + per-region downlink
        fan-out), which the legacy single-hop totals do NOT include."""
        rec = self.hop_traffic.setdefault(
            hop, {"down_bytes": 0, "up_bytes": 0, "transfers": 0,
                  "uploads": 0})
        rec["down_bytes"] += int(down_bytes)
        rec["up_bytes"] += int(up_bytes)
        rec["transfers"] += int(transfers)
        rec["uploads"] += int(uploads)

    @property
    def measured_total_bytes(self) -> int:
        return self.measured_down_bytes + self.measured_up_bytes

    def tier_table(self) -> Dict[str, Dict[str, float]]:
        """Per-tier measured traffic with MB columns (README's tier
        table / the tiered example's report)."""
        mb = 1024.0 * 1024.0
        out = {}
        for name, rec in self.tier_traffic.items():
            out[name] = dict(rec)
            out[name]["down_mb"] = rec["down_bytes"] / mb
            out[name]["up_mb"] = rec["up_bytes"] / mb
            out[name]["up_bytes_per_upload"] = (
                rec["up_bytes"] / rec["uploads"] if rec["uploads"] else 0.0)
        return out

    def hop_table(self) -> Dict[str, Dict[str, float]]:
        """Per-hop measured traffic with MB columns (README's hop ledger
        table / the --regions example's report)."""
        mb = 1024.0 * 1024.0
        out = {}
        for name, rec in self.hop_traffic.items():
            out[name] = dict(rec)
            out[name]["down_mb"] = rec["down_bytes"] / mb
            out[name]["up_mb"] = rec["up_bytes"] / mb
        return out


def report_for(trainable, frozen, rounds: int = 1,
               uplink_bits: int = 0) -> CommReport:
    by = basic.tree_bytes(trainable)
    bz = basic.tree_bytes(frozen)
    qb = (compress.quantized_uplink_bytes(trainable, uplink_bits)
          if uplink_bits else 0)
    return CommReport(full_bytes=by + bz, trainable_bytes=by, rounds=rounds,
                      uplink_bits=uplink_bits, quantized_trainable_bytes=qb)
