"""The port's mesh on ``gloo`` ranks on the CPU: the ten cases of the
reference's ``tests/test_multidevice.py`` with its tolerances and exact
fields, on 4 ranks (``debug``, 2 x 2) and, for the async grid, on 8
(``debug-pod``, 2 x 2 x 2); the meshed async grid against the
reference's single-device run; and ``launch/specs.make_train_step`` on a
reduced StableLM (tensor-parallel) and a reduced Mixtral with 2-D
experts (the gathered layout) over 2 x 2 against the unsharded round;
and the grid's snapshots on 2 x 2, written once a world and resumed on
every rank.

The wide cases take every cross-rank step of the flat plane on both
worlds: int8 uplinks, the screen (NaN, exponent-flipped and norm-outlier
rows), a DP clip and noise, on the staged and the fused tail, with a
leaf of four blocks split across the two "model" ranks. Their grids are
held to the reference's single-device runs and their screen decisions to
the port's unmeshed runs; their engines, from the same inputs, give the
unmeshed screen masks, norms and clip norms bit for bit.

One world a module fixture: ``tests/_torch_mesh_worker.py`` runs every
scenario on each rank (one intra-op thread a rank) and writes its
results; the fixture waits for the ranks under a time limit and returns
them. The unmeshed runs are made here, in the test process, from the
worker's own scenario code and settings.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

from repro.nn import basic as jbasic
from repro.sim import grid as jgrid
from repro.core import fedpt as jfedpt
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic
from repro_torch.sim import grid as tgrid

import _torch_mesh_worker as worker

REL = 1e-5                   # tests/test_torch_grid.py's tolerance

RC, RC_DP, PLAN, ASSIGN = worker.RC, worker.RC_DP, worker.PLAN, worker.ASSIGN
# a reduced config that keeps make_train_step's gathered layout: Mixtral
# with its experts on "data" and "model" (the 2-D mode)
GATHERED_ARCH, GATHERED_OVER = "mixtral-8x7b", {"expert_shard": "2d"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The unmeshed grids here are tiny: one intra-op thread keeps them
    from spinning every core under the parallel test runner (the ranks
    run with one thread each too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_init(seed, width=4):
    return {"dense": jbasic.init_dense(seed, "dense", 64, width, jnp.float32,
                                       bias=True)}


def jax_wide_init(seed):
    return jax_init(seed, worker.WIDE_WIDTH)


def jax_loss(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = jax.nn.log_softmax(jbasic.dense(x, params["dense"]))
    return -jnp.mean(jnp.take_along_axis(lp, b["labels"][:, None], 1)), {}


def init_numpy(seed):
    return jax.tree_util.tree_map(np.asarray, jax_init(seed))


def torch_init(seed):
    return bridge.from_numpy_tree(init_numpy(seed), "cpu")


torch_loss, make_ds = worker.loss_fn, worker.make_ds


def single(rc, rounds, seed, **gkw):
    return tgrid.run_grid(torch_init, torch_loss, make_ds(), rc, rounds,
                          grid=tgrid.GridConfig(**gkw), seed=seed,
                          device="cpu")


def round_inputs(arch="stablelm-1.6b", **over):
    cfg = ttrain.reduced_config(get_config(arch), max_layers=2, d_model=128,
                                vocab=300).with_(**over)
    params = tdlm.init_model(cfg, 0, device="cpu")
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 1, 16)).astype(np.int32)
    return cfg, params, {"tokens": tok, "labels": tok}


def _drain_cut():
    full = single(RC_DP, 6, 2, mode="async", concurrency=4, goal_count=3)
    return (full.history[1]["virtual_seconds"]
            + full.history[2]["virtual_seconds"]) / 2.0


def wide_inputs():
    """The wide engines' inputs: a 4-client cohort whose client 1 trains
    on NaN images (a non-finite row) and client 2 on images scaled by 30
    (a norm outlier); and a (6, size) flush buffer with a NaN in row 1 on
    the second "model" rank's blocks, row 3 scaled by 1e3 and row 5 a
    zero-weight padding row, the bias leaf's pad slots zero."""
    batch, w = tsyn.cohort_batch(make_ds(), np.arange(4), 2, 8,
                                 np.random.default_rng(11))
    batch["images"][1] = np.nan
    batch["images"][2] *= 30.0
    rows = 0.01 * np.random.default_rng(12).standard_normal(
        (6, 5 * 1024)).astype(np.float32)
    rows[:, worker.WIDE_WIDTH:1024] = 0.0
    rows[1, 4000] = np.nan
    rows[3] *= 1000.0
    rows[5] = 0.0
    return dict(wide_batch=batch, wide_weights=w, wide_rows=rows,
                wide_row_weights=np.array([1.0, 0.9, 0.8, 0.7, 0.6, 0.0],
                                          np.float32))


@pytest.fixture(scope="module")
def init():
    data = {s: init_numpy(s) for s in range(4)}
    cfg, params, batch = round_inputs()
    gcfg, gparams, gbatch = round_inputs(GATHERED_ARCH, **GATHERED_OVER)
    data.update(stablelm_cfg=cfg, stablelm_batch=batch,
                stablelm_params=tbasic.tree_map(lambda t: t.numpy(), params),
                gathered_cfg=gcfg, gathered_batch=gbatch,
                gathered_params=tbasic.tree_map(lambda t: t.numpy(),
                                                gparams),
                drain_cut=_drain_cut(),
                wide={s: jax.tree_util.tree_map(np.asarray, jax_wide_init(s))
                      for s in range(3)},
                **wide_inputs())
    return data


@pytest.fixture(scope="module")
def world4(init, tmp_path_factory):
    return worker.spawn(4, str(tmp_path_factory.mktemp("mesh4")), init)


@pytest.fixture(scope="module")
def world8(init, tmp_path_factory):
    return worker.spawn(8, str(tmp_path_factory.mktemp("mesh8")), init)


def _leaves(tree):
    return [np.asarray(v) for _, v in tbasic.flatten_params(tree)]


def assert_histories_match(ref, got, keys_exact=("virtual_seconds",
                                                "buffer_fill",
                                                "staleness_mean",
                                                "staleness_max")):
    """The reference's contract: clock and bookkeeping exact, losses and
    y to float32 round-off."""
    assert len(ref.history) == len(got["history"])
    for ha, hb in zip(ref.history, got["history"]):
        for k in keys_exact:
            assert ha[k] == hb[k], k
        assert ha["loss"] == pytest.approx(hb["loss"], rel=1e-5, abs=1e-6)
    assert ref.scheduler_stats == got["scheduler_stats"]
    assert ref.comm.measured_up_bytes == got["up_bytes"]
    for (ka, va), b in zip(tbasic.flatten_params(ref.y), _leaves(got["y"])):
        np.testing.assert_allclose(va.numpy(), b, rtol=1e-5, atol=1e-6,
                                   err_msg=ka)


@pytest.mark.parametrize("mesh_name", ["debug", "debug-pod"])
def test_async_grid_mesh_matches_single_device(mesh_name, request):
    world = request.getfixturevalue(
        "world4" if mesh_name == "debug" else "world8")
    ref = single(RC, 8, 2, mode="async", fleet="pareto-mobile",
                 concurrency=6, goal_count=3)
    assert_histories_match(ref, world[0]["grid"]["async"])


def test_sync_grid_mesh_matches_single_device(world4):
    ref = single(RC, 4, 1, mode="sync")
    got = world4[0]["grid"]["sync"]
    for ha, hb in zip(ref.history, got["history"]):
        assert ha["virtual_seconds"] == hb["virtual_seconds"]
        assert ha["loss"] == pytest.approx(hb["loss"], rel=1e-5)


def test_async_grid_mesh_dp_matches_single_device(world4):
    """Per-flush DP on the mesh: each "model" rank draws its columns of the
    flush's noise (bit for bit the slice of the whole draw) and the mean
    keeps its fixed denominator, so the histories agree to float32
    round-off and the accountants exactly."""
    ref = single(RC_DP, 6, 3, mode="async", concurrency=5, goal_count=3)
    got = world4[0]["grid"]["async_dp"]
    assert_histories_match(ref, got)
    assert ref.dp == got["dp"]
    assert got["dp"]["flushes"] == 6
    assert got["dp"]["sigma"] == pytest.approx(0.4 * 0.5 / 3)


def test_mesh_resolution_and_flat_shardings(world4, world8):
    sh = world4[0]["shardings"]
    assert sh["same"]                       # objects and presets pass through
    assert "mesh preset" in sh["unknown"]
    assert sh["clients"] == ("data", "model")
    assert sh["vector"] == ("model",)
    pod = world8[0]["shardings"]
    assert pod["clients"] == (("pod", "data"), "model")
    # the plane's blocks: rows over the data ranks, whole 1024-blocks of
    # the columns over "model" (rank 3 of 2 x 2 is data 1, model 1)
    mat = np.arange(4 * 4096, dtype=np.float32).reshape(4, 4096)
    np.testing.assert_array_equal(world4[3]["shardings"]["block"],
                                  mat[2:4, 2048:4096])
    np.testing.assert_array_equal(world4[1]["shardings"]["cols"],
                                  mat[0, 2048:4096])


def test_padded_flush_mean_unperturbed_on_mesh(world4):
    """Zero-weight padding rows, zeros or garbage, perturb neither the
    sharded weighted mean nor its norm."""
    (want, want_norm), *got = world4[0]["apply"]["padded"]
    for y, norm in got:
        assert norm == pytest.approx(want_norm, rel=1e-5)
        for a, b in zip(_leaves(y), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_padded_flush_dp_fixed_denominator_on_mesh(world4):
    """With per-flush DP the sharded apply reproduces the mechanism
    composed by hand (fixed goal_count denominator, one draw), full or
    padded, and the noise term is the same for both."""
    res = world4[0]["apply"]["dp_fixed"]
    for got, want in res["pairs"]:
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    (yf, _), (yp, _) = res["pairs"]
    for a, b, g in zip(_leaves(yf), _leaves(yp), _leaves(res["gap"])):
        np.testing.assert_allclose(a - b, g, rtol=1e-4, atol=1e-6)


def test_async_grid_mixed_tier_mesh_matches_single_device(world4):
    ref = single(RC, 8, 2, mode="async", fleet="pareto-mobile",
                 concurrency=6, goal_count=3, plan=PLAN,
                 tier_assignment=ASSIGN)
    got = world4[0]["grid"]["async_tiers"]
    assert_histories_match(ref, got)
    assert ref.comm.tier_traffic == got["tier_traffic"]
    st = got["tier_stats"]
    assert set(st) == {"full", "mid", "lite"}
    assert sum(r["up_bytes"] for r in st.values()) == got["up_bytes"]


def test_sync_grid_mixed_tier_mesh_matches_single_device(world4):
    ref = single(RC, 4, 1, mode="sync", plan={"full": (), "lite": (r"/bias$",)},
                 tier_assignment=[0, 1] * 6)
    got = world4[0]["grid"]["sync_tiers"]
    for ha, hb in zip(ref.history, got["history"]):
        assert ha["virtual_seconds"] == hb["virtual_seconds"]
        assert ha["loss"] == pytest.approx(hb["loss"], rel=1e-5)
    assert ref.comm.tier_traffic == got["tier_traffic"]
    for (ka, va), b in zip(tbasic.flatten_params(ref.y), _leaves(got["y"])):
        np.testing.assert_allclose(va.numpy(), b, rtol=1e-5, atol=1e-6,
                                   err_msg=ka)


def test_async_grid_mesh_dp_deadline_drain(world4, init):
    ref = single(RC_DP, 6, 2, mode="async", concurrency=4, goal_count=3,
                 async_deadline=init["drain_cut"])
    got = world4[0]["grid"]["drain"]
    assert got["history"][-1]["buffer_fill"] < 3
    assert got["dp"]["padded_flushes"] == 1
    assert ref.dp == got["dp"]
    assert_histories_match(ref, got)


def test_every_rank_runs_the_same_host_loop(world4, world8):
    """SPMD: the clock, scheduler, wire ledger and accountant come out the
    same on every rank, and so does the gathered y."""
    for world in (world4, world8):
        for other in world[1:]:
            runs = list(world[0]["grid"].items()) + [
                (name, a) for name, a in world[0]["wide"].items()
                if name[0] == "grid"]
            for name, a in runs:
                b = (other["grid"] if isinstance(name, str)
                     else other["wide"])[name]
                for k in ("history", "scheduler_stats", "up_bytes",
                          "tier_traffic", "dp", "tier_stats", "quarantine"):
                    assert a[k] == b[k], (name, k)
                for x, y in zip(_leaves(a["y"]), _leaves(b["y"])):
                    np.testing.assert_array_equal(x, y)
            for name, a in world[0]["wide"].items():
                if name[0] != "grid":
                    for k, v in a.items():
                        for x, y in zip(_leaves(v) if k == "y" else [v],
                                        _leaves(other["wide"][name][k])
                                        if k == "y"
                                        else [other["wide"][name][k]]):
                            np.testing.assert_array_equal(x, y)


def test_async_mesh_matches_the_reference(world4):
    """The 2 x 2 meshed async grid against the reference's single-device
    run, at tests/test_torch_grid.py's tolerance (uplink_bits=0)."""
    jrc = jfedpt.RoundConfig(4, 2, 8, "sgd", 0.1, "sgd", 1.0)

    from repro.data import synthetic as jsyn
    jds = jsyn.make_federated_images(12, 30, (8, 8, 1), 4, seed=0,
                                     test_examples=32)
    ref = jgrid.run_grid(jax_init, jax_loss, jds, jrc, 8,
                         grid=jgrid.GridConfig(mode="async",
                                               fleet="pareto-mobile",
                                               concurrency=6, goal_count=3),
                         seed=2)
    got = world4[0]["grid"]["async"]
    assert ref.scheduler_stats == got["scheduler_stats"]
    assert ref.comm.measured_up_bytes == got["up_bytes"]
    for ha, hb in zip(ref.history, got["history"]):
        for k in ("virtual_seconds", "buffer_fill", "staleness_mean",
                  "staleness_max"):
            assert ha[k] == hb[k], k
        assert hb["loss"] == pytest.approx(ha["loss"], rel=REL)
    for a, b in zip(_leaves(ref.y), _leaves(got["y"])):
        assert float(np.abs(a - b).max()) <= REL * float(np.abs(a).max())


# the reduced StableLM round on 2 x 2 against the unsharded round: the
# step is tensor-parallel on "model" (each rank's partial products summed
# in rank order, where one GEMM sums them in another) and the two data
# ranks' partial sums are added in another order than the one GEMV, so
# the update is held by its norm within this bound
TRAIN_STEP_UPDATE_REL = 1e-5


def _train_step_matches_unsharded_round(world4, init, key):
    """The meshed train step of ``key``'s reduced config (the worker's
    ``train_step_case``) against the unsharded round: the loss, the
    update within TRAIN_STEP_UPDATE_REL of its norm, the server state,
    and y laid out by the reference's rules. Returns the rank-0 result."""
    cfg = init[f"{key}_cfg"]
    params = tbasic.tree_map(torch.as_tensor, init[f"{key}_params"])
    y, z = tpart.partition(params, cfg.freeze_spec)
    rc = tfedpt.RoundConfig(clients_per_round=0, local_steps=2,
                            local_batch=0, client_opt="sgd", client_lr=0.02,
                            server_opt="sgdm", server_lr=0.5)
    step, sopt = tfedpt.make_round_fn(
        lambda p, mb: tdlm.train_loss(p, cfg, mb), rc, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in init[f"{key}_batch"].items()}
    y_ref, ss_ref, m = step(y, sopt.init(y), z, batch, torch.ones(2), None)
    got = world4[0]["train_step"][key]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)
    num = den = 0.0
    for (path, a0), a, b in zip(tbasic.flatten_params(y), _leaves(y_ref),
                                _leaves(got["y"])):
        num += float(((a - b).astype(np.float64) ** 2).sum())
        den += float(((a - a0.numpy()).astype(np.float64) ** 2).sum())
    assert den > 0 and num ** 0.5 <= TRAIN_STEP_UPDATE_REL * den ** 0.5
    for a, b in zip(_leaves(ss_ref), _leaves(got["ss"])):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)
    pl = got["placements"]
    assert pl["layers/slot0/attn/wq/kernel"] == "(Replicate(), Shard(dim=2))"
    assert pl["final_norm/scale"] == "(Replicate(), Replicate())"
    return got


def test_train_step_on_mesh_matches_unsharded_round(world4, init):
    got = _train_step_matches_unsharded_round(world4, init, "stablelm")
    assert got["tensor_parallel"]


def test_gathered_train_step_on_mesh_matches_unsharded_round(world4, init):
    """``make_train_step``'s gathered layout (a config that
    ``sharding.tensor_parallel_ok`` refuses: a reduced Mixtral with 2-D
    experts) on 2 x 2: y, the server state and the frozen tree gathered
    for each data rank's clients, the flat plane on each rank's blocks,
    and the new y laid out again by the rules."""
    got = _train_step_matches_unsharded_round(world4, init, "gathered")
    assert not got["tensor_parallel"]
    assert all(w["train_step"]["gathered"]["loss"] == got["loss"]
               for w in world4)


@pytest.mark.parametrize("mode", list(worker.CKPT_CASES))
def test_mesh_checkpoint_written_once_and_resumed_on_every_rank(world4,
                                                                 mode):
    """A 2 x 2 meshed grid with ``checkpoint_every=2``, killed between two
    updates: each snapshot is one file, written by rank 0 of the world
    alone (the other ranks wait at a barrier), and every rank resumes
    from the path its kill carries into the uninterrupted meshed run, bit
    for bit (history, scheduler stats, wire bytes, y)."""
    res = [w["checkpoint"][mode] for w in world4]
    files = res[0]["files"]
    assert len(files) == 2                    # snapshots after 2 and 4
    assert all(r["files"] == files for r in res)
    assert res[0]["writes"] == len(files)
    assert [r["writes"] for r in res[1:]] == [0] * (len(res) - 1)
    assert os.path.basename(res[0]["path"]) == files[-1]
    for r in res:
        assert r["path"] == res[0]["path"]
        assert r["same"]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_single_mesh_is_the_unmeshed_grid_bit_for_bit(mode):
    """The 1-rank ``single`` mesh (a gloo group of one here) runs the
    meshed code and gives the unmeshed grid's bits: int8 uplinks, and the
    screen with per-flush DP in async mode."""
    rc = tfedpt.RoundConfig(4, 2, 8, "sgd", 0.1, "sgd", 1.0, uplink_bits=8,
                            **(dict(dp_clip_norm=0.5, dp_noise_multiplier=0.4)
                               if mode == "async" else {}))
    kw = dict(mode=mode, sanitize="on", agg_tail_threshold=0)
    if mode == "async":
        kw.update(concurrency=5, goal_count=3)
    runs = [single(rc, 4, 1, mesh=mesh, **kw) for mesh in (None, "single")]
    assert runs[0].history == runs[1].history
    assert runs[0].scheduler_stats == runs[1].scheduler_stats
    for a, b in zip(_leaves(runs[0].y), _leaves(runs[1].y)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the wide cases: every cross-rank step of the flat plane


WORLDS = ["debug", "debug-pod"]
ROUTES = {"default": None, "fused": 0}


def _world(request, mesh_name):
    return request.getfixturevalue("world4" if mesh_name == "debug"
                                   else "world8")


@pytest.fixture(scope="module")
def wide_unmeshed(init):
    return {(mode, thr): worker.summary(worker.wide_grid(init, None, mode,
                                                         thr))
            for mode in ("sync", "async") for thr in worker.THRESHOLDS}


@pytest.fixture(scope="module")
def wide_reference():
    """The reference's single-device wide grids (its default tail)."""
    from repro.data import synthetic as jsyn
    jds = jsyn.make_federated_images(12, 30, (8, 8, 1), 4, seed=0,
                                     test_examples=32)
    jrc = jfedpt.RoundConfig(**dataclasses.asdict(worker.WIDE_RC))
    out = {}
    for mode in ("sync", "async"):
        kw = (dict(mode="sync") if mode == "sync" else
              dict(mode="async", concurrency=5, goal_count=4,
                   faults=worker.FAULTS))
        res = jgrid.run_grid(
            jax_wide_init, jax_loss, jds, jrc, 4 if mode == "sync" else 6,
            grid=jgrid.GridConfig(sanitize=worker.SCREEN, **kw),
            seed=1 if mode == "sync" else 2)
        out[mode] = {"history": res.history,
                     "scheduler_stats": res.scheduler_stats,
                     "up_bytes": res.comm.measured_up_bytes, "dp": res.dp,
                     "y": [np.asarray(v) for v in
                           jax.tree_util.tree_leaves(res.y)]}
    return out


def _int8_step():
    """One int8 step of any client delta (tests/test_torch_grid.py)."""
    ds = make_ds()
    xmax = max(float(np.abs(x).max()) for x in ds.client_images)
    rc = worker.WIDE_RC
    return rc.client_lr * rc.local_steps * max(1.0, xmax) / 127


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("mesh_name", WORLDS)
def test_wide_grid_on_mesh_matches_reference_and_unmeshed(
        mesh_name, mode, route, request, wide_reference, wide_unmeshed):
    """The reference's single-device grid holds the meshed one as
    tests/test_torch_grid.py holds the unmeshed port at int8: the clock,
    staleness, scheduler stats (quarantines among them), wire bytes and
    accountant exactly, losses to rel 1e-5, y and each flush's delta_norm
    within rel 1e-5 plus one int8 step a flush. The screen's decisions
    (cause, client, round or flush) are the port's unmeshed run's, and so
    are their norms: bit for bit in the first round or flush, where both
    start from the same y, and to rel 1e-5 after it."""
    thr = ROUTES[route]
    got = _world(request, mesh_name)[0]["wide"]["grid", mode, thr]
    ref = wide_reference[mode]
    step = _int8_step()
    assert len(got["history"]) == len(ref["history"])
    for hr, hg in zip(ref["history"], got["history"]):
        assert set(hg) == set(hr)
        for k, v in hr.items():
            if k not in ("loss", "delta_norm"):
                assert hg[k] == v, k
        assert hg["loss"] == pytest.approx(hr["loss"], rel=REL)
        if "delta_norm" in hr:
            assert abs(hg["delta_norm"] - hr["delta_norm"]) <= (
                REL * hr["delta_norm"] + step)
    assert got["scheduler_stats"] == ref["scheduler_stats"]
    assert got["scheduler_stats"]["quarantined"] > 0
    assert got["up_bytes"] == ref["up_bytes"]
    assert got["dp"] == ref["dp"]
    flushes = len(ref["history"])
    for a, b in zip(_leaves(got["y"]), ref["y"]):
        assert float(np.abs(a - b).max()) <= (
            REL * float(np.abs(b).max()) + flushes * step)

    un = wide_unmeshed[mode, thr]["quarantine"]
    q = got["quarantine"]
    assert len(q) == len(un) > 0
    first = q[0].get("round", q[0].get("flush"))
    for a, b in zip(q, un):
        assert {k: v for k, v in a.items() if k != "norm"} == {
            k: v for k, v in b.items() if k != "norm"}
        if a.get("round", a.get("flush")) == first:
            assert a["norm"] == b["norm"]
        else:
            assert a["norm"] == pytest.approx(b["norm"], rel=REL)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("engine", ["sync_engine", "apply_engine"])
@pytest.mark.parametrize("mesh_name", WORLDS)
def test_wide_engines_on_mesh_are_the_unmeshed(mesh_name, engine, route,
                                               request, init):
    """The sync round (int8 two-pass Q->DQ or stats / pack / apply, the
    clip, noise) and the buffered flush (screen, fixed-denominator mean,
    noise) on the mesh from the unmeshed engines' inputs: the screen's
    masks and norms, the clip's mean norm and the loss bit for bit (the
    per-leaf max-abs, the finite flags and the per-block sums are reduced
    exactly), y and delta_norm to float32 round-off (the mean's partial
    sums are added over the data ranks)."""
    thr = ROUTES[route]
    got = _world(request, mesh_name)[0]["wide"][engine, thr]
    want = getattr(worker, engine)(init, None, thr)
    assert got["quarantine_nonfinite"].any()
    assert got["quarantine_outlier"].any()
    exact = ["quarantine_nonfinite", "quarantine_outlier",
             "quarantine_norms"]
    exact += ["update_norm", "loss"] if engine == "sync_engine" else []
    for k in exact:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(got["delta_norm"]) == pytest.approx(
        float(want["delta_norm"]), rel=REL)
    for (path, a), b in zip(tbasic.flatten_params(want["y"]),
                            _leaves(got["y"])):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6,
                                   err_msg=path)
