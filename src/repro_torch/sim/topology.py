"""Two-level aggregation topology: clients -> edge aggregators -> server,
port of ``repro/sim/topology.py``.

At fleet scale (the survey's — Le et al., PAPERS.md — headline answer to
communication practicality) clients do not talk to the server directly:
they are partitioned into **regions**, each owning an edge aggregator
that pre-reduces its cohort's flat deltas into one ``(size,)`` buffer
(the same flat layout ``core/flat.py`` gives every client row) and
forwards that single buffer upstream. The wire then has two hops —
client→edge and edge→server — billed separately in
``CommReport.hop_traffic`` (``core/comm.py``).

The flat grid is the one-region special case: ``resolve_topology(None)``
keeps every pre-topology code path untouched, and a *one-region*
topology runs the full hierarchical machinery (edge buffers, hop
ledger, ``edge_flush`` events) while staying bit-identical to the flat
grid on every model/metric path — the authoritative server reduce is
unchanged; the edge pre-reduce is the billing/verification view of the
same rows (test-enforced).

Region partition schemes:

``contiguous``
    clients ``[k*N/R, (k+1)*N/R)`` belong to region ``k`` — the
    geographic-block idiom, and what the presets mean by "region";
``strided``
    client ``c`` belongs to region ``c % R`` — maximally interleaved,
    useful to decorrelate region shocks from data skew in experiments;
explicit array
    any ``(num_clients,)`` int map.

The partitions are the reference's numpy code. :func:`edge_reduce` takes
the flush's rows as a tensor on their device and reduces them there, in
the reference's order and without float atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """``GridConfig.topology``: region count + partition scheme."""

    regions: int = 1
    assignment: Union[str, np.ndarray] = "contiguous"

    def __post_init__(self):
        if self.regions < 1:
            raise ValueError("topology needs >= 1 region")


class Topology:
    """A bound topology: ``region_of`` is the ``(num_clients,)`` int32
    client→region map; per-region member lists are precomputed once."""

    def __init__(self, num_clients: int, region_of: np.ndarray):
        region_of = np.ascontiguousarray(region_of, np.int32)
        if region_of.shape != (num_clients,):
            raise ValueError(f"region map has shape {region_of.shape}, "
                             f"fleet has {num_clients} clients")
        if num_clients and region_of.min() < 0:
            raise ValueError("region indices must be >= 0")
        self.num_clients = int(num_clients)
        self.region_of = region_of
        self.num_regions = int(region_of.max()) + 1 if num_clients else 1
        self._members: Optional[Dict[int, np.ndarray]] = None

    @classmethod
    def build(cls, num_clients: int,
              spec: Union[TopologyConfig, int, np.ndarray]) -> "Topology":
        if isinstance(spec, int):
            spec = TopologyConfig(regions=spec)
        if isinstance(spec, TopologyConfig):
            r = spec.regions
            if r > max(num_clients, 1):
                raise ValueError(f"{r} regions over {num_clients} clients: "
                                 "every region needs at least one client")
            if isinstance(spec.assignment, str):
                if spec.assignment == "contiguous":
                    # equal-size contiguous blocks (first N % R regions
                    # get the extra client)
                    region_of = (np.arange(num_clients, dtype=np.int64)
                                 * r // max(num_clients, 1)).astype(np.int32)
                elif spec.assignment == "strided":
                    region_of = (np.arange(num_clients) % r).astype(np.int32)
                else:
                    raise ValueError(
                        f"unknown region assignment {spec.assignment!r}; "
                        "options: 'contiguous', 'strided', or an explicit "
                        "per-client index array")
            else:
                region_of = np.asarray(spec.assignment, np.int32)
                if region_of.size and region_of.max() >= r:
                    raise ValueError(f"explicit region map uses region "
                                     f"{region_of.max()}, config has {r}")
            topo = cls(num_clients, region_of)
            topo.num_regions = int(r)
            return topo
        return cls(num_clients, np.asarray(spec, np.int32))

    def members(self, region: int) -> np.ndarray:
        """Client ids in one region (cached)."""
        if self._members is None:
            order = np.argsort(self.region_of, kind="stable")
            bounds = np.searchsorted(self.region_of[order],
                                     np.arange(self.num_regions + 1))
            self._members = {
                k: order[bounds[k]:bounds[k + 1]]
                for k in range(self.num_regions)}
        return self._members[int(region)]

    def region_name(self, region: int) -> str:
        return f"edge{int(region)}"

    def summary(self) -> Dict[str, float]:
        sizes = np.bincount(self.region_of, minlength=self.num_regions)
        return {"regions": float(self.num_regions),
                "clients": float(self.num_clients),
                "region_size_min": float(sizes.min()),
                "region_size_max": float(sizes.max())}


def resolve_topology(spec, num_clients: int) -> Optional[Topology]:
    """``GridConfig.topology`` -> bound Topology or None (flat grid).

    ``None`` keeps the flat single-hop grid (no hierarchical machinery
    at all); an int is a region count with the ``contiguous`` partition;
    a :class:`TopologyConfig` or explicit per-client array binds as
    given. Note a one-*region* topology is NOT folded to None: it runs
    the full edge machinery (bit-identical to flat, test-enforced), so
    the hierarchy can be A/B'd against the flat grid."""
    if spec is None:
        return None
    return Topology.build(num_clients, spec)


def edge_reduce(rows: torch.Tensor, weights, regions,
                num_regions: int) -> torch.Tensor:
    """Pre-reduce client delta rows into per-region edge buffers.

    ``rows`` is the flush's ``(K, size)`` flat delta stack (one
    ``core/flat.py`` layout row per upload) on its device, ``weights``
    its ``(K,)`` aggregation weights (host values) and
    ``regions`` the uploader's region per row (host ints). Returns the
    ``(num_regions, size)`` edge buffers on the rows' device — region
    ``k``'s aggregator forwards row ``k`` (its members' weighted sum)
    upstream, so ``out.sum(0)`` re-associates the server's weighted
    reduce. The authoritative update keeps the fused single-reduce path;
    these buffers are what the edge *transmits* (billed per hop) and what
    the parity tests check against the flat reduce.

    Each row is scaled by its weight, then added into its region's buffer
    one row after another, in row order: the reference's ``np.add.at``
    order, so the buffers are bit for bit the reference's, and the same
    from run to run (no float atomics, as ``index_add_`` would use on
    CUDA). A row's NaN or Inf reaches only its own region's buffer."""
    regions = np.asarray(regions, np.int64)
    if rows.ndim != 2 or len(weights) != len(rows) \
            or len(regions) != len(rows):
        raise ValueError(f"edge_reduce shape mismatch: rows "
                         f"{tuple(rows.shape)}, weights {len(weights)}, "
                         f"regions {regions.shape}")
    w = torch.from_numpy(np.asarray(weights, np.float32)).to(rows.dtype)
    if rows.device.type == "cuda":
        # a pinned staging copy: no host wait on the device
        w = w.pin_memory().to(rows.device, non_blocking=True)
    scaled = rows * w[:, None]
    out = torch.zeros((int(num_regions), rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for k, region in enumerate(regions.tolist()):
        out[region] += scaled[k]
    return out
