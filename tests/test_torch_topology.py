"""The port's two-level topology (``repro_torch.sim.topology`` and its
grid wiring) on the CPU, against itself and against the JAX package.

First the cases of ``tests/test_topology.py``, run through the port with
the same assertions: region partitions, the fleet's struct-of-arrays,
the edge pre-reduce, per-hop billing, one region bit for bit the flat
grid in both modes, and region shocks. Then the two packages together:

* the partitions: the same ``region_of`` arrays, exactly (numpy code);
* ``edge_reduce`` on tensors against ``repro.sim.topology.edge_reduce``:
  bit for bit, since each row is scaled, then added into its region's
  buffer in row order, as ``np.add.at`` does (the stated float32 bound is
  0); NaN rows stay in their own region;
* 4-region runs, shocked and not, in both modes, on the tiny 64 -> 4
  dense model from the same parameters: the host side exactly (virtual
  clock, staleness, scheduler stats, measured and per-hop bytes, the
  edge and region counters, the trace's shock, dispatch and edge-flush
  records), losses and ``y`` within ``tests/test_torch_grid.py``'s
  tolerance for this model (rel 1e-5; y within 1e-5 of max|y|).
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

from repro.core import fedpt as jfedpt
from repro.nn import basic as jbasic
from repro.sim import dynamics as jdyn
from repro.sim import grid as jgrid
from repro.sim import topology as jtopo
from repro_torch import bridge
from repro_torch.core import fedpt
from repro_torch.data import synthetic as syn
from repro_torch.nn import basic
from repro_torch.sim import devices as dev_lib
from repro_torch.sim import dynamics as dyn_lib
from repro_torch.sim import grid as simgrid
from repro_torch.sim import topology as topo_lib
from repro_torch.sim import wire

REL = 1e-5


def init_fn(seed):
    return {"dense": basic.init_dense(seed, "dense", 64, 4, torch.float32,
                                      bias=True, device="cpu")}


def loss_fn(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = torch.log_softmax(basic.dense(x, params["dense"]), -1)
    return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}


def make_ds(n_clients=12, seed=0):
    return syn.make_federated_images(n_clients, 30, (8, 8, 1), 4, seed=seed,
                                     test_examples=64)


RC = dict(clients_per_round=4, local_steps=2, local_batch=8,
          client_opt="sgd", client_lr=0.1, server_opt="sgd", server_lr=1.0)


def _assert_same_run(a, b):
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    for ha, hb in zip(a.history, b.history):
        assert ha["virtual_seconds"] == hb["virtual_seconds"]
    for (pa, la), (pb, lb) in zip(basic.flatten_params(a.y),
                                  basic.flatten_params(b.y)):
        assert pa == pb and torch.equal(la, lb), pa
    assert a.scheduler_stats == b.scheduler_stats
    # the legacy single-hop ledger is topology-independent
    assert a.comm.measured_down_bytes == b.comm.measured_down_bytes
    assert a.comm.measured_up_bytes == b.comm.measured_up_bytes
    assert a.comm.transfers == b.comm.transfers


# ---------------------------------------------------------------------------
# partition schemes


def test_contiguous_partition_blocks():
    t = topo_lib.Topology.build(12, topo_lib.TopologyConfig(regions=3))
    assert t.num_regions == 3
    np.testing.assert_array_equal(t.region_of, [0] * 4 + [1] * 4 + [2] * 4)
    np.testing.assert_array_equal(t.members(1), [4, 5, 6, 7])


def test_contiguous_partition_uneven_sizes_differ_by_one():
    t = topo_lib.Topology.build(10, topo_lib.TopologyConfig(regions=3))
    sizes = np.bincount(t.region_of, minlength=3)
    assert sizes.sum() == 10 and sizes.max() - sizes.min() <= 1


def test_strided_partition_interleaves():
    t = topo_lib.Topology.build(
        8, topo_lib.TopologyConfig(regions=3, assignment="strided"))
    np.testing.assert_array_equal(t.region_of, [0, 1, 2, 0, 1, 2, 0, 1])
    np.testing.assert_array_equal(t.members(2), [2, 5])


def test_explicit_partition_array():
    t = topo_lib.Topology.build(
        4, topo_lib.TopologyConfig(regions=2,
                                   assignment=np.array([1, 0, 1, 1])))
    np.testing.assert_array_equal(t.members(0), [1])
    np.testing.assert_array_equal(t.members(1), [0, 2, 3])
    assert t.summary()["region_size_max"] == 3.0


def test_partition_errors():
    with pytest.raises(ValueError, match=">= 1 region"):
        topo_lib.TopologyConfig(regions=0)
    with pytest.raises(ValueError, match="at least one client"):
        topo_lib.Topology.build(3, topo_lib.TopologyConfig(regions=5))
    with pytest.raises(ValueError, match="unknown region assignment"):
        topo_lib.Topology.build(
            4, topo_lib.TopologyConfig(regions=2, assignment="hexagons"))
    with pytest.raises(ValueError, match="uses region"):
        topo_lib.Topology.build(
            4, topo_lib.TopologyConfig(regions=2,
                                       assignment=np.array([0, 1, 2, 0])))
    with pytest.raises(ValueError, match="has shape"):
        topo_lib.Topology(4, np.zeros(3, np.int32))
    assert topo_lib.resolve_topology(None, 10) is None
    assert topo_lib.resolve_topology(3, 10).num_regions == 3


@pytest.mark.parametrize("n,spec", [
    (12, 3), (10, 3), (1000, 7), (8, dict(regions=3, assignment="strided")),
    (4, dict(regions=2, assignment=np.array([1, 0, 1, 1]))), (5, 1)])
def test_partitions_match_jax(n, spec):
    """The same bound topology as the reference's, array for array."""
    def bind(mod):
        s = spec if isinstance(spec, int) else mod.TopologyConfig(**spec)
        return mod.resolve_topology(s, n)
    t, j = bind(topo_lib), bind(jtopo)
    assert t.num_regions == j.num_regions
    assert t.region_of.dtype == j.region_of.dtype
    np.testing.assert_array_equal(t.region_of, j.region_of)
    for k in range(t.num_regions):
        np.testing.assert_array_equal(t.members(k), j.members(k))
    assert t.summary() == j.summary()


# ---------------------------------------------------------------------------
# FleetState struct-of-arrays vs the per-profile scalar paths


def test_fleet_state_matches_per_profile_views():
    fleet = dev_lib.make_fleet(64, "pareto-mobile", seed=3)
    st = fleet.state
    for i in (0, 17, 63):
        p = fleet.profile(i)
        assert p.downlink_bps == st.downlink_bps[i]
        assert p.uplink_bps == st.uplink_bps[i]
        assert p.compute_multiplier == st.compute_multiplier[i]
        assert p.availability == st.availability[i]
        assert p.dropout == st.dropout[i]


def test_round_trip_seconds_batch_matches_scalar_bitwise():
    fleet = dev_lib.make_fleet(50, "pareto-mobile", seed=1)
    cids = np.array([3, 3, 49, 0, 21])
    up = np.array([1000, 2000, 500, 1, 0], np.int64)
    comp = np.array([0.1, 0.0, 2.5, 0.3, 1.0])
    batch = fleet.state.round_trip_seconds(4096, up, comp, cids=cids)
    for k, c in enumerate(cids):
        assert batch[k] == fleet.profile(int(c)).round_trip_seconds(
            4096, int(up[k]), float(comp[k]))


def test_capability_scores_batch_matches_scalar():
    fleet = dev_lib.make_fleet(40, "pareto-mobile", seed=2)
    scores = fleet.state.capability_scores()
    for i in range(0, 40, 7):
        assert scores[i] == dev_lib.capability_score(fleet.profile(i))


def test_from_profiles_round_trips_through_arrays():
    profiles = [dev_lib.DeviceProfile(downlink_bps=1e6 * (i + 1),
                                      uplink_bps=5e5,
                                      compute_multiplier=1.0,
                                      availability=0.9, dropout=0.05)
                for i in range(5)]
    fleet = dev_lib.Fleet(name="hand", profiles=profiles)
    assert len(fleet) == 5
    assert [p.downlink_bps for p in fleet.profiles] \
        == [p.downlink_bps for p in profiles]


# ---------------------------------------------------------------------------
# edge pre-reduce


def test_edge_reduce_reassociates_the_flat_reduce():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((9, 33)).astype(np.float32)
    wts = rng.random(9).astype(np.float32)
    regions = np.array([0, 2, 1, 0, 2, 2, 1, 0, 0])
    buffers = topo_lib.edge_reduce(torch.from_numpy(rows), wts, regions,
                                   3).numpy()
    assert buffers.shape == (3, 33)
    # each edge buffer is its members' weighted sum...
    for k in range(3):
        np.testing.assert_allclose(
            buffers[k], (rows[regions == k] * wts[regions == k, None]).sum(0),
            rtol=1e-6)
    # ...and the buffers re-associate the server's flat weighted reduce
    np.testing.assert_allclose(buffers.sum(0), (rows * wts[:, None]).sum(0),
                               rtol=1e-5)


def test_edge_reduce_empty_region_forwards_zeros():
    buffers = topo_lib.edge_reduce(torch.ones((2, 4)), np.ones(2, np.float32),
                                   np.array([0, 0]), 3)
    assert not buffers[1:].any()


def test_edge_reduce_shape_mismatch():
    with pytest.raises(ValueError, match="shape mismatch"):
        topo_lib.edge_reduce(torch.ones((2, 4)), np.ones(3), np.zeros(2), 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        topo_lib.edge_reduce(torch.ones(4), np.ones(4), np.zeros(4), 1)


@pytest.mark.parametrize("k,size,regions", [(9, 33, 3), (6, 89_088, 4),
                                            (5, 1000, 1), (12, 2048, 7)])
def test_edge_reduce_matches_jax_bit_for_bit(k, size, regions):
    """Against ``repro.sim.topology.edge_reduce`` (numpy ``np.add.at``):
    the same bits, a region without rows all zero, a NaN or Inf row only
    in its own region's buffer."""
    g = np.random.default_rng(size)
    rows = (g.standard_normal((k, size)) * 1e-2).astype(np.float32)
    rows[1, 7] = np.nan
    rows[-1, 3] = np.inf
    wts = g.uniform(0.0, 1.0, k).astype(np.float32)
    wts[0] = 0.0
    regs = g.integers(0, max(regions - 1, 1), k)  # the last region empty
    got = topo_lib.edge_reduce(torch.from_numpy(rows), list(wts), regs,
                               regions).numpy()
    want = jtopo.edge_reduce(rows, wts, regs, regions)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    assert np.array_equal(got[keep].view(np.int32), want[keep].view(np.int32))
    if regions > 1:
        assert not got[regions - 1].any()
    bad = {int(regs[1]), int(regs[-1])}
    for r in set(range(regions)) - bad:
        assert np.isfinite(got[r]).all()


# ---------------------------------------------------------------------------
# hierarchical grid runs: hop billing and the one-region contract


def _run(mode, topology=None, dynamics=None, seed=0, rounds=3, **kw):
    gc = simgrid.GridConfig(mode=mode, fleet="pareto-mobile",
                            topology=topology, dynamics=dynamics, **kw)
    return simgrid.run_grid(init_fn, loss_fn, make_ds(),
                            fedpt.RoundConfig(**RC), rounds, gc, seed=seed,
                            device="cpu")


def test_sync_hop_billing_sums_to_legacy_ledger():
    res = _run("sync", topology=3)
    ce = res.comm.hop_traffic["client_edge"]
    # the client->edge hop IS the legacy single-hop ledger
    assert ce["down_bytes"] == res.comm.measured_down_bytes
    assert ce["up_bytes"] == res.comm.measured_up_bytes
    assert ce["transfers"] == res.comm.transfers
    es = res.comm.hop_traffic["edge_server"]
    # each round, every active region forwards ONE pre-reduced buffer
    # and fetches ONE model copy
    assert 0 < es["uploads"] <= 3 * 3
    assert es["up_bytes"] == es["uploads"] * wire.edge_flush_bytes(res.y)
    assert es["transfers"] <= 3 * 3
    assert "edge_server" in res.comm.hop_table()


def test_async_hop_billing_sums_to_legacy_ledger():
    res = _run("async", topology=4, rounds=6, goal_count=4, concurrency=6)
    ce = res.comm.hop_traffic["client_edge"]
    assert ce["down_bytes"] == res.comm.measured_down_bytes
    assert ce["up_bytes"] == res.comm.measured_up_bytes
    es = res.comm.hop_traffic["edge_server"]
    assert es["uploads"] > 0
    assert es["up_bytes"] == es["uploads"] * wire.edge_flush_bytes(res.y)


def test_flat_run_has_no_edge_hop():
    res = _run("sync")
    assert res.topology is None
    assert res.comm.hop_traffic == {}


def test_one_region_sync_is_bit_identical_to_flat():
    flat = _run("sync")
    one = _run("sync", topology=1)
    assert one.topology is not None and one.topology.num_regions == 1
    _assert_same_run(flat, one)
    assert one.comm.hop_traffic["edge_server"]["uploads"] > 0


def test_one_region_async_is_bit_identical_to_flat():
    flat = _run("async", rounds=6, goal_count=4, concurrency=6)
    one = _run("async", topology=1, rounds=6, goal_count=4, concurrency=6)
    _assert_same_run(flat, one)
    assert one.comm.hop_traffic["edge_server"]["uploads"] > 0


def test_multi_region_changes_billing_not_the_model():
    flat = _run("sync", over_selection=1.5)
    multi = _run("sync", topology=4, over_selection=1.5)
    _assert_same_run(flat, multi)


def test_region_dispatch_upload_counters_cover_cohort():
    res = _run("sync", topology=3)
    reg_up = res.metrics.counter("region_uploads")
    assert sum(reg_up.labels.values()) == res.scheduler_stats["uploads"]
    reg_disp = res.metrics.counter("region_dispatches")
    assert sum(reg_disp.labels.values()) == res.scheduler_stats["dispatches"]


# ---------------------------------------------------------------------------
# correlated region shocks


@pytest.mark.dynamics
def test_shock_zeroes_exactly_its_region():
    shocks = dyn_lib.RegionShocks(every=10.0, duration=5.0,
                                  residual=0.0).bind(
        3, np.random.default_rng(0))
    t = shocks.next_t + 1e-9
    f = shocks.factor(np.array([0, 1, 2]), t)
    assert shocks.fired == 1
    region = int(shocks.outages[0][0])
    expected = np.ones(3)
    expected[region] = 0.0
    np.testing.assert_array_equal(f, expected)
    assert shocks.factor_one(region, t) == 0.0
    t_end = shocks.outages[0][2]
    assert shocks.factor_one(region, t_end) in (1.0, 0.0)  # may re-fire
    if shocks.fired == 1:
        assert shocks.factor_one(region, t_end) == 1.0


@pytest.mark.dynamics
def test_shock_state_dict_round_trips():
    a = dyn_lib.RegionShocks(every=0.5, duration=0.3).bind(
        4, np.random.default_rng(7))
    a.factor(np.arange(4), 2.0)
    b = dyn_lib.RegionShocks(every=0.5, duration=0.3).bind(
        4, np.random.default_rng(1))
    b.load_state(a.state_dict())
    for t in (2.1, 2.7, 3.4):
        np.testing.assert_array_equal(a.factor(np.arange(4), t),
                                      b.factor(np.arange(4), t))
    assert a.fired == b.fired and a.next_t == b.next_t


@pytest.mark.dynamics
def test_sync_shock_zeroes_exactly_its_regions_dispatches():
    res = _run("sync", topology=3, rounds=4, over_selection=1.5,
               telemetry=True,
               dynamics=dyn_lib.DynamicsConfig(shocks=dyn_lib.RegionShocks(
                   every=0.005, duration=0.05, residual=0.0)))
    events = res.telemetry.events
    outages = [(int(e.payload["region"]), e.t, float(e.payload["until"]))
               for e in events if e.kind == "shock"]
    assert outages, "no shock fired despite every=0.005"
    dispatches = [(int(res.topology.region_of[e.payload["cid"]]), e.t)
                  for e in events if e.kind == "dispatch"]
    assert dispatches
    for region, start, end in outages:
        hits = [t for r, t in dispatches if r == region and start <= t < end]
        assert not hits, (f"region {region} dispatched at {hits[:3]} "
                          f"inside its outage [{start}, {end})")
    assert res.scheduler_stats["uploads"] > 0
    assert len(res.history) == 4


@pytest.mark.dynamics
def test_sync_shocks_reduce_uploads_vs_unshocked_run():
    base = _run("sync", topology=3, rounds=4, over_selection=1.5)
    shocked = _run("sync", topology=3, rounds=4, over_selection=1.5,
                   dynamics=dyn_lib.DynamicsConfig(
                       shocks=dyn_lib.RegionShocks(every=0.002,
                                                   duration=0.2,
                                                   residual=0.0)))
    assert shocked.scheduler_stats["offline"] \
        > base.scheduler_stats["offline"]


def test_shocks_without_topology_is_an_error():
    with pytest.raises(ValueError, match="needs a topology"):
        _run("sync", dynamics=dyn_lib.DynamicsConfig(
            shocks=dyn_lib.RegionShocks()))


# ---------------------------------------------------------------------------
# against the JAX package


def _j_init(seed):
    return {"dense": jbasic.init_dense(seed, "dense", 64, 4, jnp.float32,
                                       bias=True)}


def _t_init(seed):
    return bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, _j_init(seed)), "cpu")


def _j_loss(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = jax.nn.log_softmax(jbasic.dense(x, params["dense"]))
    return -jnp.mean(jnp.take_along_axis(lp, b["labels"][:, None], 1)), {}


DEVICE_VALUES = ("loss", "norm", "delta_norm")


@pytest.mark.dynamics
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("shocked", [False, True])
def test_four_regions_match_jax(mode, shocked):
    """A 4-region run (with and without shocks at every 0.01 s for 0.05 s)
    through both packages' ``run_grid``: the host side and the trace
    exactly, the model within the stated tolerance."""
    def cfg(grid_mod, dyn_mod):
        kw = dict(mode=mode, fleet="pareto-mobile", topology=4,
                  telemetry=True, sanitize=True)
        if mode == "async":
            kw.update(goal_count=4, concurrency=6)
        else:
            kw.update(over_selection=1.5)
        if shocked:
            kw["dynamics"] = dyn_mod.DynamicsConfig(
                shocks=dyn_mod.RegionShocks(every=0.01, duration=0.05,
                                            residual=0.0))
        return grid_mod.GridConfig(**kw)
    jres = jgrid.run_grid(_j_init, _j_loss, make_ds(),
                          jfedpt.RoundConfig(**RC), 6, cfg(jgrid, jdyn),
                          seed=2)
    tres = simgrid.run_grid(_t_init, loss_fn, make_ds(),
                            fedpt.RoundConfig(**RC), 6,
                            cfg(simgrid, dyn_lib), seed=2, device="cpu")
    assert len(tres.history) == len(jres.history) == 6
    for hj, ht in zip(jres.history, tres.history):
        assert set(ht) == set(hj)
        for k, v in hj.items():
            if k in DEVICE_VALUES:
                assert ht[k] == pytest.approx(v, rel=REL)
            else:
                assert ht[k] == v, k
    assert tres.virtual_seconds == jres.virtual_seconds
    assert tres.scheduler_stats == jres.scheduler_stats
    for f in ("measured_down_bytes", "measured_up_bytes", "transfers",
              "hop_traffic"):
        assert getattr(tres.comm, f) == getattr(jres.comm, f), f
    assert tres.comm.hop_traffic["edge_server"]["uploads"] > 0
    for name in ("edge_flushes", "edge_up_bytes", "edge_down_bytes",
                 "region_dispatches", "region_uploads"):
        assert (tres.metrics.counter(name).labels
                == jres.metrics.counter(name).labels), name
    je, te = jres.telemetry.events, tres.telemetry.events
    assert len(te) == len(je)
    for a, b in zip(te, je):
        assert (a.kind, a.t, a.dur, a.seq, a.parent) == \
            (b.kind, b.t, b.dur, b.seq, b.parent)
        assert set(a.payload) == set(b.payload)
        for k, v in b.payload.items():
            if k in DEVICE_VALUES:
                assert a.payload[k] == pytest.approx(v, rel=REL,
                                                     nan_ok=True), k
            else:
                assert a.payload[k] == v, (a.kind, k)
    kinds = {e.kind for e in te}
    assert "edge_flush" in kinds
    assert ("shock" in kinds) == shocked
    for a, b in zip(basic.flatten_params(tres.y), jbasic.flatten_params(
            jres.y)):
        want = np.asarray(b[1])
        assert a[0] == b[0]
        assert float(np.abs(a[1].numpy() - want).max()) <= \
            REL * float(np.abs(want).max())
