"""The port's simulation grid (``repro_torch.sim.grid.run_grid`` and
``fl.runtime.run_federated``) against the JAX package's, on the CPU.

The tiny 64 -> 4 dense model over 8x8 images of ``tests/test_sim_grid.py``,
built in both packages from the same parameters (the reference's, carried
across by ``repro_torch.bridge``), on the same synthetic data (the port's
copy of ``data/synthetic.py`` gives the reference's arrays). Each case
runs both grids on the same inputs and holds the port to:

* the host side exactly: every record's virtual clock and staleness
  fields, ``scheduler_stats``, the comm ledger's measured bytes and
  transfers, and the DP summary (the fleet, scheduler, dynamics and
  accountant are the reference's code; the streams are drawn in the same
  order);
* losses and ``delta_norm`` within rel 1e-5 (float32 training in another
  framework: matmul and log-softmax orders);
* ``y`` within 1e-5 of max|y| at ``uplink_bits=0``; at 8 bits, besides,
  within one int8 step per flush: a client value on a rounding boundary
  may flip by one quantization step, at most the client's max|delta| /
  127, which the weighted mean (weights <= 1 over their sum) and
  ``server_lr = 1`` pass on once per flush. A client's max|delta| is at
  most ``client_lr * local_steps * max(1, max|x|)``: the cross-entropy
  gradient of the linear model has entries |x_i (p_j - y_j)| <= |x_i|
  (1 for the bias). The flush's ``delta_norm`` may move by that step too.

Also here: the wire bytes against the reference's, byte for byte, and
the flush accountant's epsilon against the reference's on the cases of
``tests/test_dp.py``.
"""
import math

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

from repro.core import dp as jdp
from repro.core import fedpt as jfedpt
from repro.fl import runtime as jruntime
from repro.nn import basic as jbasic
from repro.sim import grid as jgrid
from repro.sim import wire as jwire
from repro_torch import bridge
from repro_torch.core import dp as tdp
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import runtime as truntime
from repro_torch.nn import basic as tbasic
from repro_torch.nn import threefry
from repro_torch.sim import grid as tgrid
from repro_torch.sim import wire as twire

REL = 1e-5


def jax_init(seed):
    return {"dense": jbasic.init_dense(seed, "dense", 64, 4, jnp.float32,
                                       bias=True)}


def torch_init(seed):
    return bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, jax_init(seed)), "cpu")


def jax_loss(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = jax.nn.log_softmax(jbasic.dense(x, params["dense"]))
    return -jnp.mean(jnp.take_along_axis(lp, b["labels"][:, None], 1)), {}


def torch_loss(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = torch.log_softmax(tbasic.dense(x, params["dense"]), -1)
    return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}


def make_ds(n_clients, seed=0):
    return tsyn.make_federated_images(n_clients, 30, (8, 8, 1), 4, seed=seed,
                                      test_examples=64)


def run_both(rc_kw, grid_kw, rounds, seed, n_clients):
    ds = make_ds(n_clients)
    jres = jgrid.run_grid(jax_init, jax_loss, ds,
                          jfedpt.RoundConfig(**rc_kw), rounds,
                          grid=jgrid.GridConfig(**grid_kw), seed=seed)
    tres = tgrid.run_grid(torch_init, torch_loss, ds,
                          tfedpt.RoundConfig(**rc_kw), rounds,
                          grid=tgrid.GridConfig(**grid_kw), seed=seed,
                          device="cpu")
    return jres, tres


def _leaves(tree):
    return [np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for _, v in tbasic.flatten_params(tree)]


def assert_host_side_equal(jres, tres):
    assert len(tres.history) == len(jres.history)
    for hj, ht in zip(jres.history, tres.history):
        assert set(ht) == set(hj)
        for k, v in hj.items():
            if k not in ("loss", "delta_norm"):
                assert ht[k] == v, k
    assert tres.virtual_seconds == jres.virtual_seconds
    assert tres.scheduler_stats == jres.scheduler_stats
    for f in ("measured_down_bytes", "measured_up_bytes", "transfers",
              "full_bytes", "trainable_bytes", "quantized_trainable_bytes"):
        assert getattr(tres.comm, f) == getattr(jres.comm, f), f
    assert tres.dp == jres.dp


def int8_step(ds, rc_kw) -> float:
    """One int8 quantization step of any client delta (module docstring)."""
    xmax = max(float(np.abs(x).max()) for x in ds.client_images)
    return (rc_kw["client_lr"] * rc_kw["local_steps"] * max(1.0, xmax)
            / 127)


def assert_training_close(jres, tres, step=0.0):
    """``step``: one int8 step (0 at uplink_bits=0), allowed once per
    flush on y and once on each flush's delta_norm."""
    assert [h["loss"] for h in tres.history] == pytest.approx(
        [h["loss"] for h in jres.history], rel=REL)
    for ht, hj in zip(tres.history, jres.history):
        if "delta_norm" in hj:
            assert abs(ht["delta_norm"] - hj["delta_norm"]) <= (
                REL * hj["delta_norm"] + step)
    for a, b in zip(_leaves(tres.y), _leaves(jres.y)):
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= (REL * scale
                                              + len(jres.history) * step)


ASYNC = dict(mode="async", fleet="pareto-mobile", concurrency=6,
             goal_count=3, staleness="polynomial")
DP = dict(dp_clip_norm=0.5, dp_noise_multiplier=0.4)
RC = dict(clients_per_round=4, local_steps=2, local_batch=8,
          client_opt="sgd", client_lr=0.1, server_opt="sgd", server_lr=1.0)


def test_async_pareto_int8_matches_jax():
    """(a) pareto-mobile fleet, concurrency 6, goal 3, int8 uplink."""
    jres, tres = run_both(dict(RC, uplink_bits=8), ASYNC, 12, 1, 20)
    assert_host_side_equal(jres, tres)
    assert any(h["staleness_max"] > 0 for h in tres.history)
    assert_training_close(jres, tres, step=int8_step(make_ds(20), RC))
    per_up = twire.uplink_bytes(tres.y, bits=8)
    assert tres.comm.measured_up_bytes == per_up * tres.stats["uploads"]


@pytest.mark.parametrize("lanes", [None, 0])
def test_async_per_flush_dp_matches_jax(lanes):
    """(b) per-flush DP, concurrency 5, goal 3, clip 0.5, noise 0.4, over
    the lane engine and the sequential one (lanes=0)."""
    grid = dict(mode="async", concurrency=5, goal_count=3, lanes=lanes)
    jres, tres = run_both(dict(RC, **DP), grid, 6, 4, 10)
    assert_host_side_equal(jres, tres)
    assert tres.dp["flushes"] == 6 and tres.dp["padded_flushes"] == 0
    assert tres.dp["sigma"] == pytest.approx(0.4 * 0.5 / 3)
    assert 0 < tres.dp["epsilon"] < math.inf
    assert_training_close(jres, tres)


def test_async_drained_flush_matches_jax():
    """(c) a deadline-drained final flush, padded to goal_count with
    zero-weight rows (``flat.pad_rows``): same sigma, one padded flush."""
    grid = dict(mode="async", concurrency=4, goal_count=3)
    full, _ = run_both(dict(RC, **DP), grid, 6, 2, 10)
    cut = (full.history[1]["virtual_seconds"]
           + full.history[2]["virtual_seconds"]) / 2.0
    jres, tres = run_both(dict(RC, **DP), dict(grid, async_deadline=cut),
                          6, 2, 10)
    assert_host_side_equal(jres, tres)
    assert tres.history[-1]["buffer_fill"] < 3
    assert tres.dp["padded_flushes"] == 1
    assert tres.dp["sigma"] == full.dp["sigma"]
    assert_training_close(jres, tres)


def test_lanes_are_exact_against_the_sequential_engine():
    """(d) the lane engine against ``lanes=0`` within the port: the same
    history (clock, staleness, losses, norms) and the same y, bit for bit
    on the CPU, as the reference's lanes are against its own."""
    ds = make_ds(20)
    rc = tfedpt.RoundConfig(**RC, uplink_bits=8, **DP)
    runs = [tgrid.run_grid(torch_init, torch_loss, ds, rc, 8,
                           grid=tgrid.GridConfig(**ASYNC, lanes=lanes),
                           seed=1, device="cpu") for lanes in (None, 0)]
    assert runs[0].history == runs[1].history
    assert runs[0].dp == runs[1].dp
    assert runs[0].scheduler_stats == runs[1].scheduler_stats
    for a, b in zip(_leaves(runs[0].y), _leaves(runs[1].y)):
        assert np.array_equal(a, b)


def test_run_federated_matches_plain_loop_and_jax():
    """(e) sync ``run_federated``: bit for bit the port's own plain
    ``make_round_fn`` loop fed the grid's streams (cohorts from
    ``default_rng(seed + 77)``, keys ``seed * 100_003 + r``); JAX's
    history within rel 1e-5."""
    ds = make_ds(12)
    seed, rounds = 3, 5
    rc = tfedpt.RoundConfig(**RC)
    y, frozen = tpart.partition(torch_init(seed), ())
    round_fn, sopt = tfedpt.make_round_fn(torch_loss, rc, device="cpu")
    ss = sopt.init(y)
    rng = np.random.default_rng(seed + 77)
    losses = []
    for r in range(rounds):
        cids = tsyn.sample_cohort(rng, ds.num_clients, rc.clients_per_round)
        batch, w = tsyn.cohort_batch(ds, cids, rc.local_steps,
                                     rc.local_batch, rng)
        y, ss, m = round_fn(y, ss, frozen, batch, w,
                            threefry.key(seed * 100_003 + r))
        losses.append(float(m["loss"]))
    res = truntime.run_federated(torch_init, torch_loss, ds, rc, rounds,
                                 seed=seed, device="cpu")
    assert [h["loss"] for h in res.history] == losses
    for a, b in zip(_leaves(y), _leaves(res.y)):
        assert np.array_equal(a, b)
    jres = jruntime.run_federated(jax_init, jax_loss, ds,
                                  jfedpt.RoundConfig(**RC), rounds, seed=seed)
    assert losses == pytest.approx([h["loss"] for h in jres.history],
                                   rel=REL)
    for a, b in zip(_leaves(res.y), _leaves(jres.y)):
        assert float(np.abs(a - b).max()) <= REL * float(np.abs(b).max())
    for f in ("measured_down_bytes", "measured_up_bytes", "transfers"):
        assert getattr(res.comm, f) == getattr(jres.comm, f), f
    assert res.comm.measured_down_bytes == (
        twire.downlink_bytes(res.y) * rounds * rc.clients_per_round)


def test_sync_grid_over_selection_and_deadline_match_jax():
    """The sync grid beyond run_federated: a pareto-mobile fleet with
    over-selection and a straggler deadline, so drops pad the cohort with
    zero-weight slots."""
    grid = dict(mode="sync", fleet="pareto-mobile", over_selection=1.5,
                straggler_deadline=4.0)
    jres, tres = run_both(RC, grid, 4, 5, 16)
    assert_host_side_equal(jres, tres)
    assert_training_close(jres, tres)


# ---------------------------------------------------------------------------
# the async engines alone


@pytest.mark.parametrize("extra", [dict(), dict(uplink_bits=8),
                                   dict(uplink_bits=8, **DP)])
def test_lane_step_rows_match_jax_client_steps(extra):
    """Each row of the port's lane step (training under vmap, then the
    quantize and clip kernels over the whole lane) against the JAX client
    step of that client alone; the port's sequential client step equals
    its lane row bit for bit; a tiered lane step's rows against the JAX
    tiered client steps. Rows within 1e-5 of max|row|, plus one int8 step
    of the row (max|row| / 127) at 8 bits (module docstring)."""
    ds = make_ds(6)
    rng = np.random.default_rng(0)
    batches = [tsyn.client_batch_images(ds, c, 2, 8, rng)[0]
               for c in range(3)]
    lane_batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    rc = dict(RC, **extra)
    jstep = jax.jit(jfedpt.make_client_step(jax_loss,
                                            jfedpt.RoundConfig(**rc)))
    y_t = torch_init(0)
    rows, losses = tfedpt.make_lane_step(
        torch_loss, tfedpt.RoundConfig(**rc), 3, device="cpu")(
            y_t, {}, lane_batch)
    cstep = tfedpt.make_client_step(torch_loss, tfedpt.RoundConfig(**rc),
                                    device="cpu")
    for i, b in enumerate(batches):
        want, wm = jstep(jax_init(0), {}, b)
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        step = scale / 127 if rc.get("uplink_bits") else 0.0
        assert float(np.abs(rows[i].numpy() - want).max()) <= (
            REL * scale + step)
        assert float(losses[i]) == pytest.approx(float(wm["client_loss"]),
                                                 rel=REL)
        one, m = cstep(y_t, {}, b)
        assert torch.equal(one, rows[i]) and torch.equal(m["client_loss"],
                                                         losses[i])
        if "dp_clip_norm" in rc:
            assert float(m["update_norm"]) == pytest.approx(
                float(wm["update_norm"]), rel=REL)
    # the tiered lane step (tier "lite": the kernel alone trains) against
    # the JAX tiered client step of each client, scattered to full width:
    # zero outside the tier, the same bound inside
    from repro.core import plan as jplan
    from repro_torch.core import plan as tplan
    spec = {"full": (), "lite": (r"/bias$",)}
    jcp, tcp = jplan.compile_plan(spec, jax_init(0)), tplan.compile_plan(
        spec, y_t)
    jtstep = jax.jit(jfedpt.make_client_step(
        jax_loss, jfedpt.RoundConfig(**rc), tier=jcp.tiers[1], plan=jcp))
    trows, tlosses = tfedpt.make_lane_step(
        torch_loss, tfedpt.RoundConfig(**rc), 3, tier=tcp.tiers[1],
        plan=tcp, device="cpu")(y_t, {}, lane_batch)
    assert trows.shape == rows.shape
    for i, b in enumerate(batches):
        want, wm = jtstep(jax_init(0), {}, b)
        want = np.asarray(want)
        assert not want[:1024].any() and not trows[i, :1024].any()
        scale = float(np.abs(want).max())
        step = scale / 127 if rc.get("uplink_bits") else 0.0
        assert float(np.abs(trows[i].numpy() - want).max()) <= (
            REL * scale + step)
        assert float(tlosses[i]) == pytest.approx(float(wm["client_loss"]),
                                                  rel=REL)
        # the sequential tiered step: its lane row bit for bit, scattered
        # (the default) or as the tier's contiguous slice (the payload)
        kw = dict(tier=tcp.tiers[1], plan=tcp, device="cpu")
        one, _ = tfedpt.make_client_step(
            torch_loss, tfedpt.RoundConfig(**rc), **kw)(y_t, {}, b)
        sub, _ = tfedpt.make_client_step(
            torch_loss, tfedpt.RoundConfig(**rc), scatter=False, **kw)(
                y_t, {}, b)
        assert torch.equal(one, trows[i]) and sub.shape == (tcp.tiers[1].size,)
        assert torch.equal(tcp.scatter(sub, tcp.tiers[1]), one)


@pytest.mark.parametrize("dp", [False, True])
def test_buffered_apply_matches_jax(dp):
    """One flush of a (3, size) buffer with staleness weights, a zero-
    weight padding row among them: the weighted / fixed-denominator mean,
    the per-flush noise from the same key (threefry, bits equal; normals
    within ulps), ServerOpt."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as topt
    y_j, y_t = jax_init(0), torch_init(0)
    g = np.random.default_rng(1)
    # the layout: bias (4) and kernel (256), each padded to one block
    rows = (g.normal(size=(3, 2 * 1024)) * 1e-2).astype(np.float32)
    rows[:, 4:1024] = 0.0
    rows[:, 1024 + 256:] = 0.0
    rows[2] = 0.0
    w = np.array([1.0, 0.5, 0.0], np.float32)
    cfg = dict(clip_norm=0.5, noise_multiplier=0.4, goal_count=3)
    japply = jfedpt.make_buffered_apply(
        jopt.get_optimizer("sgd", 1.0),
        flush_dp=jdp.FlushDPConfig(**cfg) if dp else None)
    tapply = tfedpt.make_buffered_apply(
        topt.get_optimizer("sgd", 1.0),
        flush_dp=tdp.FlushDPConfig(**cfg) if dp else None, device="cpu")
    jy, _, jm = japply(y_j, {}, jnp.asarray(rows), jnp.asarray(w),
                       jax.random.key(5) if dp else None)
    ty, _, tm = tapply(y_t, {}, torch.from_numpy(rows), w,
                       threefry.key(5) if dp else None)
    assert float(tm["delta_norm"]) == pytest.approx(float(jm["delta_norm"]),
                                                    rel=REL)
    for a, b in zip(_leaves(ty), _leaves(jy)):
        assert float(np.abs(a - b).max()) <= REL * float(np.abs(b).max())


@pytest.mark.parametrize("kw", [dict(resume_from="x"), dict(mesh="debug"),
                                dict(topology=2), dict(checkpoint_every=1,
                                                       checkpoint_dir="x"),
                                dict(telemetry={"profile": True})])
def test_unported_grid_features_raise(kw, tmp_path, monkeypatch):
    """Only mesh execution is still refused; the topology, checkpoints,
    resume and profiling run (a resume from a missing snapshot fails on
    the file, not as unported)."""
    monkeypatch.chdir(tmp_path)
    ds = make_ds(6)

    def run():
        return tgrid.run_grid(torch_init, torch_loss, ds,
                              tfedpt.RoundConfig(**RC), 1,
                              grid=tgrid.GridConfig(mode="async", **kw),
                              device="cpu")
    if "mesh" in kw:
        with pytest.raises(NotImplementedError, match="not ported"):
            run()
    elif "resume_from" in kw:
        with pytest.raises(FileNotFoundError):
            run()
    else:
        res = run()
        assert len(res.history) == 1
        if "topology" in kw:
            assert res.topology.num_regions == 2
        if "checkpoint_dir" in kw:
            assert (tmp_path / "x" / "grid_async_000001.npz").exists()


# ---------------------------------------------------------------------------
# the wire ledger and the flush accountant


def _tree(seed):
    g = np.random.default_rng(seed)
    return {"conv": {"bias": g.normal(size=(8,)).astype(np.float32),
                     "kernel": g.normal(size=(3, 3, 1, 8)).astype(np.float32)},
            "dense": {"kernel": (g.normal(size=(40, 4)) * 1e-3
                                 ).astype(np.float32)},
            "gn": {"scale": np.zeros((8,), np.float32)}}


@pytest.mark.parametrize("bits", [0, 8])
def test_wire_bytes_match_jax(bits):
    tree = _tree(bits)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = bridge.from_numpy_tree(tree, "cpu")
    assert twire.encode_downlink(ttree, 1234) == jwire.encode_downlink(
        jtree, 1234)
    up = twire.encode_uplink(ttree, bits=bits)
    assert up == jwire.encode_uplink(jtree, bits=bits)
    spec = twire.TreeSpec.of(ttree)
    back = twire.decode_uplink(up, spec, bits=bits)
    want = jwire.decode_uplink(up, jwire.TreeSpec.of(jtree), bits=bits)
    for a, b in zip(_leaves(back), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, np.asarray(b))
    y, seed = twire.decode_downlink(twire.encode_downlink(ttree, 7), spec)
    assert seed == 7 and all(np.array_equal(a, b) for a, b in
                             zip(_leaves(y), _leaves(ttree)))
    twire.assert_matches_analytic(ttree, {"z": torch.zeros(5)}, bits)


# (clip, z, goal, per-flush (n_real, multiplicity)) as tests/test_dp.py
ACCOUNTANT_CASES = [
    (1.0, 1.13, 5, [(5, 1)] * 20),
    (1.0, 4.0, 5, [(5, 1)] * 20),
    (1.0, 0.0, 5, [(5, 1)]),
    (1.0, 2.0, 8, [(8, 2)] * 10),
    (1.0, 2.0, 8, [(8, m) for m in (1, 2, 3, 4) for _ in range(6)]),
    (0.5, 1.5, 4, [(4, 1), (4, 2), (3, 1), (4, 3), (2, 1), (4, 2)]),
]


@pytest.mark.parametrize("clip,z,goal,flushes", ACCOUNTANT_CASES)
def test_flush_accountant_matches_jax(clip, z, goal, flushes):
    accs = [pkg.FlushAccountant(pkg.FlushDPConfig(clip, z, goal))
            for pkg in (jdp, tdp)]
    for n_real, mult in flushes:
        for acc in accs:
            acc.record_flush(n_real, multiplicity=mult)
            assert accs[1].epsilon(1e-5) == accs[0].epsilon(1e-5) or \
                acc is accs[0]
    assert accs[1].summary() == accs[0].summary()
    assert accs[1].epsilon(1e-6) == accs[0].epsilon(1e-6)
    with pytest.raises(ValueError):
        accs[1].record_flush(goal, multiplicity=0)
    with pytest.raises(ValueError):
        tdp.FlushDPConfig(clip_norm=0.0, noise_multiplier=1.0, goal_count=5)
