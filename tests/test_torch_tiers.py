"""Trainability tiers in the port against the JAX package, on the CPU:
the tiered server tails, the tiered round engine, the grid with mixed
tiers (sync, async, async with per-flush DP), the adaptive-capability
policy, ``core/adaptive``, ``core/adaptive_clip``, the flush
accountant's state, and ``fl/tuning``.

The model is ``tests/test_sim_grid.py``'s 64 -> 4 dense on 8x8 images
(built in both packages from the reference's parameters) with its
three-tier plan: ``full``, ``mid`` (bias frozen), ``lite`` (kernel
frozen). Tolerances, as ``tests/test_torch_grid.py`` states them:

* the host side exactly: every record's clock and staleness fields,
  ``scheduler_stats``, the measured bytes, ``tier_stats`` (census,
  per-tier bytes, transfers, uploads, compute charge, mean observed
  round trip) and the DP summary;
* losses and ``delta_norm`` within rel 1e-5; ``y`` within 1e-5 of
  max|y|, plus one int8 step per flush at 8 bits (a client value on a
  rounding boundary may flip by one quantization step);
* the tails: the fused route bit for bit the staged one where the
  reference's contract is bitwise (``tests/test_agg_tail.py``'s tiered
  cases), rtol 1e-5 + 1e-7 where it is not; each route against JAX's
  within rtol 1e-5 plus 4 ulps of max|update|;
* a one-tier plan bit for bit the untiered port (sync), lane-exact
  (async).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.core import adaptive as jadapt
from repro.core import adaptive_clip as jac
from repro.core import dp as jdp
from repro.core import fedpt as jfedpt
from repro.core import plan as jplan
from repro.fl import tuning as jtuning
from repro.kernels import agg_tail as jat
from repro.nn import basic as jbasic
from repro.sim import grid as jgrid
from repro.sim import selection as jsel
from repro_torch import bridge
from repro_torch.core import adaptive as tadapt
from repro_torch.core import adaptive_clip as tac
from repro_torch.core import dp as tdp
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import partition as tpart
from repro_torch.core import plan as tplan
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import tuning as ttuning
from repro_torch.kernels import ops as tops
from repro_torch.nn import basic as tbasic
from repro_torch.nn import threefry
from repro_torch.sim import grid as tgrid
from repro_torch.sim import selection as tsel

REL = 1e-5
TIER_PLAN = {"full": (), "mid": (r"/bias$",), "lite": (r"/kernel$",)}
RC = dict(clients_per_round=4, local_steps=2, local_batch=8,
          client_opt="sgd", client_lr=0.1, server_opt="sgd", server_lr=1.0)
DP = dict(dp_clip_norm=0.5, dp_noise_multiplier=0.4)
ASYNC = dict(mode="async", fleet="pareto-mobile", concurrency=6,
             goal_count=3, staleness="polynomial")


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


def leaves(tree):
    return [np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for _, v in tbasic.flatten_params(tree)]


def int8_step(ds) -> float:
    """One int8 quantization step of any client delta: at most
    client_lr * local_steps * max(1, max|x|) / 127 for the linear model
    (``tests/test_torch_grid.py``)."""
    xmax = max(float(np.abs(x).max()) for x in ds.client_images)
    return RC["client_lr"] * RC["local_steps"] * max(1.0, xmax) / 127


def run_both(rc_kw, grid_kw, rounds, seed, ds):
    jres = jgrid.run_grid(jax_init, jax_loss, ds, jfedpt.RoundConfig(**rc_kw),
                          rounds, grid=jgrid.GridConfig(**grid_kw), seed=seed)
    tres = tgrid.run_grid(torch_init, torch_loss, ds,
                          tfedpt.RoundConfig(**rc_kw), rounds,
                          grid=tgrid.GridConfig(**grid_kw), seed=seed,
                          device="cpu")
    return jres, tres


def assert_host_side_equal(jres, tres):
    assert len(tres.history) == len(jres.history)
    for hj, ht in zip(jres.history, tres.history):
        assert set(ht) == set(hj)
        for k, v in hj.items():
            if k not in ("loss", "delta_norm"):
                assert ht[k] == v, k
    assert tres.virtual_seconds == jres.virtual_seconds
    assert tres.scheduler_stats == jres.scheduler_stats
    for f in ("measured_down_bytes", "measured_up_bytes", "transfers"):
        assert getattr(tres.comm, f) == getattr(jres.comm, f), f
    assert tres.comm.tier_traffic == jres.comm.tier_traffic
    assert tres.tier_stats == jres.tier_stats
    assert tres.dp == jres.dp
    assert tres.plan.names == jres.plan.names


def assert_training_close(jres, tres, step=0.0):
    assert [h["loss"] for h in tres.history] == pytest.approx(
        [h["loss"] for h in jres.history], rel=REL)
    for ht, hj in zip(tres.history, jres.history):
        if "delta_norm" in hj:
            assert abs(ht["delta_norm"] - hj["delta_norm"]) <= (
                REL * hj["delta_norm"] + step)
    for a, b in zip(leaves(tres.y), leaves(jres.y)):
        assert float(np.abs(a - b).max()) <= (
            REL * float(np.abs(b).max()) + len(jres.history) * step)


# ---------------------------------------------------------------------------
# the tiered tails (tests/test_agg_tail.py's tiered cases)

ALIGN = 256
BL = np.asarray([0, 0, 0, 1, 2, 2, 3, 3], np.int32)     # 4 leaves, 8 blocks
NB = len(BL)
K = 6
BITWISE = {
    "tiered_sync": dict(block_denom=True),
    "tiered_async": dict(remask_rows=True, block_denom=True),
    "tiered_quant": dict(bits=8, block_denom=True),
}
ULP = {"tiered_async_dp": dict(remask_rows=True, wsum_fixed=float(K),
                               sigma=0.02)}


def tier_bmask():
    """Two tiers: even rows train every block, odd rows leaves 0 and 3."""
    masks = np.ones((K, NB), np.float32)
    masks[1::2] = (BL == 0) | (BL == 3)
    return masks


def tail_inputs(name):
    g = np.random.default_rng(sorted({**BITWISE, **ULP}).index(name))
    mat = g.normal(0, 0.5, (K, NB * ALIGN)).astype(np.float32)
    w = np.random.default_rng(1).uniform(0.5, 2.0, (K,)).astype(np.float32)
    return mat, w


def tail_kw(name):
    kw = dict({**BITWISE, **ULP}[name], block_leaf=BL, n_leaves=4,
              align=ALIGN)
    kw["block_denom"] = "wsum_fixed" not in kw
    return kw


@pytest.mark.parametrize("name", sorted({**BITWISE, **ULP}))
def test_tiered_tail_fused_against_staged_within_port(name):
    mat, w = tail_inputs(name)
    kw = tail_kw(name)
    rng = threefry.key(7) if kw.get("sigma") else None
    outs = {}
    for route, thr in (("staged", 1 << 60), ("fused", 0)):
        out, info = tops.agg_tail(torch.from_numpy(mat), torch.from_numpy(w),
                                  bmask=torch.from_numpy(tier_bmask()),
                                  rng=rng, threshold=thr, **kw)
        assert info["route"].startswith(route)
        outs[route] = out.numpy()
    if name in BITWISE:
        assert np.array_equal(outs["staged"], outs["fused"]), name
    else:
        assert np.allclose(outs["staged"], outs["fused"], rtol=1e-5,
                           atol=1e-7), name


@pytest.mark.parametrize("name", sorted({**BITWISE, **ULP}))
def test_tiered_compose_matches_jax(name):
    mat, w = tail_inputs(name)
    kw = tail_kw(name)
    sigma = kw.get("sigma")
    want, _ = jat.compose(jnp.asarray(mat), jnp.asarray(w),
                          bmask=jnp.asarray(tier_bmask()),
                          rng=jax.random.key(7) if sigma else None,
                          engine="ref", **kw)
    got, info = tops.agg_tail(torch.from_numpy(mat), torch.from_numpy(w),
                              bmask=torch.from_numpy(tier_bmask()),
                              rng=threefry.key(7) if sigma else None,
                              threshold=0, **kw)
    assert info["route"].startswith("fused/torch/")
    want = np.asarray(want)
    tol = 1e-5 * np.abs(want) + 4 * np.spacing(np.abs(want).max())
    assert (np.abs(got.numpy() - want) <= tol).all(), name


# ---------------------------------------------------------------------------
# the tiered round engine


@pytest.mark.parametrize("extra", [dict(), dict(uplink_bits=8),
                                   dict(uplink_bits=8, fused=0),
                                   dict(DP, uniform_weights=True)])
def test_tiered_round_matches_jax(extra):
    """One sync round with tiers (0, 1, 2, 1): every client's gradients
    masked to its tier, the per-block denominator without DP, the fixed
    one with it; y elementwise within 1e-5 of max|y| (plus one int8 step
    at 8 bits), delta_norm and loss within rel 1e-5."""
    extra = dict(extra)
    fused = extra.pop("fused", None)
    ds = make_ds(8)
    rng = np.random.default_rng(3)
    batch, w = tsyn.cohort_batch(ds, np.arange(4), RC["local_steps"],
                                 RC["local_batch"], rng)
    tiers = np.array([0, 1, 2, 1])
    rc = dict(RC, **extra)
    jy, _ = jpart.partition(jax_init(0), ())
    ty, _ = tpart.partition(torch_init(0), ())
    jcp, tcp = jplan.compile_plan(TIER_PLAN, jy), tplan.compile_plan(
        TIER_PLAN, ty)
    jround, jsopt = jfedpt.make_round_fn(jax_loss, jfedpt.RoundConfig(**rc),
                                         plan=jcp, fused_threshold=fused)
    tround, tsopt = tfedpt.make_round_fn(torch_loss, tfedpt.RoundConfig(**rc),
                                         plan=tcp, fused_threshold=fused,
                                         device="cpu")
    jy1, _, jm = jround(jy, jsopt.init(jy), {}, batch, jnp.asarray(w),
                        jnp.asarray(tiers, jnp.int32), jax.random.key(2))
    ty1, _, tm = tround(ty, tsopt.init(ty), {}, batch, w, tiers,
                        threefry.key(2))
    step = int8_step(ds) if rc.get("uplink_bits") else 0.0
    for a, b in zip(leaves(ty1), leaves(jy1)):
        assert float(np.abs(a - b).max()) <= (REL * float(np.abs(b).max())
                                              + step)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=REL)
    assert abs(float(tm["delta_norm"]) - float(jm["delta_norm"])) <= (
        REL * float(jm["delta_norm"]) + step)
    # the untiered signature is refused on a tiered round: tiers are needed
    with pytest.raises(TypeError):
        tround(ty, tsopt.init(ty), {}, batch, w)


def test_tiered_round_in_client_chunks_matches_whole(monkeypatch):
    """The tiered round vmapped a client at a time (``VMAP_BYTES`` below
    one client's row): each client's tier mask goes with its slice of the
    cohort, so y, the loss and delta_norm equal the whole-cohort round's
    within rel 1e-6 (float32 reassociation only)."""
    ds = make_ds(8)
    rng = np.random.default_rng(3)
    batch, w = tsyn.cohort_batch(ds, np.arange(4), RC["local_steps"],
                                 RC["local_batch"], rng)
    tiers = np.array([0, 1, 2, 1])
    ty, _ = tpart.partition(torch_init(0), ())
    tcp = tplan.compile_plan(TIER_PLAN, ty)
    out = []
    for vmap_bytes in (tfedpt.VMAP_BYTES, 1):
        monkeypatch.setattr(tfedpt, "VMAP_BYTES", vmap_bytes)
        tround, tsopt = tfedpt.make_round_fn(
            torch_loss, tfedpt.RoundConfig(**RC), plan=tcp, device="cpu")
        out.append(tround(ty, tsopt.init(ty), {}, batch, w, tiers,
                          threefry.key(2)))
    (y_whole, _, m_whole), (y_chunk, _, m_chunk) = out
    for a, b in zip(leaves(y_chunk), leaves(y_whole)):
        assert float(np.abs(a - b).max()) <= 1e-6 * float(np.abs(b).max())
    for k in ("loss", "delta_norm"):
        assert float(m_chunk[k]) == pytest.approx(float(m_whole[k]),
                                                  rel=1e-6)


def test_lite_only_sync_cohort_leaves_frozen_leaves_bit_for_bit():
    """A cohort of kernel-frozen clients leaves every kernel as it was,
    in both packages; the bias moves as JAX's does."""
    ds = make_ds(6)
    grid = dict(plan={"full": (), "lite": (r"/kernel$",)},
                tier_assignment=[1] * 6)
    jres, tres = run_both(RC, grid, 3, 0, ds)
    y0, _ = tpart.partition(torch_init(0), ())
    assert torch.equal(tres.y["dense"]["kernel"], y0["dense"]["kernel"])
    assert not torch.equal(tres.y["dense"]["bias"], y0["dense"]["bias"])
    assert_host_side_equal(jres, tres)
    assert_training_close(jres, tres)


# ---------------------------------------------------------------------------
# the grid with mixed tiers


@pytest.mark.parametrize("bits", [0, 8])
def test_sync_grid_mixed_tiers_matches_jax(bits):
    ds = make_ds(9)
    grid = dict(plan=TIER_PLAN, tier_assignment=[0, 0, 0, 1, 1, 1, 2, 2, 2],
                fleet="pareto-mobile", over_selection=1.5,
                straggler_deadline=4.0)
    jres, tres = run_both(dict(RC, uplink_bits=bits), grid, 5, 1, ds)
    assert_host_side_equal(jres, tres)
    assert_training_close(jres, tres, step=int8_step(ds) if bits else 0.0)
    st = tres.tier_stats
    assert [st[k]["clients"] for k in ("full", "mid", "lite")] == [3, 3, 3]
    assert sum(r["up_bytes"] for r in st.values()) == \
        tres.comm.measured_up_bytes > 0


@pytest.mark.parametrize("lanes", [None, 0])
@pytest.mark.parametrize("bits", [0, 8])
def test_async_grid_mixed_tiers_matches_jax(bits, lanes):
    """Capability-assigned tiers on the pareto-mobile fleet, lanes grouped
    by tier (and the sequential engine): fewer uplink bytes than the
    same fleet all-``full``."""
    ds = make_ds(12)
    grid = dict(ASYNC, plan=TIER_PLAN, lanes=lanes)
    jres, tres = run_both(dict(RC, uplink_bits=bits), grid, 10, 5, ds)
    assert_host_side_equal(jres, tres)
    assert_training_close(jres, tres, step=int8_step(ds) if bits else 0.0)
    full = tgrid.run_grid(torch_init, torch_loss, ds,
                          tfedpt.RoundConfig(**RC, uplink_bits=bits), 10,
                          grid=tgrid.GridConfig(**ASYNC), seed=5,
                          device="cpu")
    assert any(r["uploads"] for k, r in tres.tier_stats.items()
               if k != "full")
    assert (tres.comm.measured_up_bytes / tres.scheduler_stats["uploads"]
            < full.comm.measured_up_bytes / full.scheduler_stats["uploads"])


def test_async_grid_mixed_tiers_dp_matches_jax():
    """Tiers with per-flush DP: the masked, clipped rows over the fixed
    goal_count, the flush's noise from the same key; sigma and the
    accountant tier-independent."""
    ds = make_ds(10)
    grid = dict(mode="async", concurrency=5, goal_count=3, plan=TIER_PLAN,
                tier_assignment=[0, 0, 0, 1, 1, 1, 2, 2, 2, 2])
    jres, tres = run_both(dict(RC, **DP), grid, 6, 4, ds)
    assert_host_side_equal(jres, tres)
    assert tres.dp["sigma"] == pytest.approx(0.4 * 0.5 / 3)
    assert tres.dp["flushes"] == 6
    assert_training_close(jres, tres)


def test_one_tier_plan_is_the_untiered_port():
    """A one-tier plan routes through the untiered engines: sync bit for
    bit, async lane-exact (clock, staleness, losses, y), the whole ledger
    on the one tier."""
    ds = make_ds(16)
    rc = tfedpt.RoundConfig(**RC, uplink_bits=8)
    single = tplan.TrainPlan.single()
    for grid, rounds in ((tgrid.GridConfig(), 4),
                         (tgrid.GridConfig(**ASYNC), 8)):
        ref = tgrid.run_grid(torch_init, torch_loss, ds, rc, rounds,
                             grid=grid, seed=2, device="cpu")
        got = tgrid.run_grid(torch_init, torch_loss, ds, rc, rounds,
                             grid=dataclasses.replace(grid, plan=single),
                             seed=2, device="cpu")
        assert got.history == ref.history
        for a, b in zip(leaves(got.y), leaves(ref.y)):
            assert np.array_equal(a, b)
        assert got.scheduler_stats == ref.scheduler_stats
        assert got.comm.measured_up_bytes == ref.comm.measured_up_bytes
        assert set(got.tier_stats) == {"full"}
        assert got.tier_stats["full"]["up_bytes"] == \
            ref.comm.measured_up_bytes
        assert got.plan.trivial and ref.tier_stats is None


def test_adaptive_capability_tier_map_matches_jax():
    """``examples/adaptive_tiers.py``'s policy (the copied
    ``sim/selection.py``) on the pareto-mobile-diurnal fleet, re-tiering
    every 3 updates from observed round trips: after the run the tier
    map, the refit count and the observed-RTT EMAs equal the
    reference's, as does every host-side record."""
    ds = make_ds(16)
    pols = (jsel.AdaptiveCapabilityPolicy(refit_every=3, ema=0.4),
            tsel.AdaptiveCapabilityPolicy(refit_every=3, ema=0.4))
    base = dict(mode="async", fleet="pareto-mobile-diurnal", concurrency=6,
                goal_count=3, staleness="polynomial", plan=TIER_PLAN)
    jres = jgrid.run_grid(jax_init, jax_loss, ds, jfedpt.RoundConfig(**RC),
                          9, grid=jgrid.GridConfig(**base, selection=pols[0]),
                          seed=0)
    tres = tgrid.run_grid(torch_init, torch_loss, ds,
                          tfedpt.RoundConfig(**RC), 9,
                          grid=tgrid.GridConfig(**base, selection=pols[1]),
                          seed=0, device="cpu")
    jp, tp = pols
    assert tp.refits == jp.refits >= 1
    np.testing.assert_array_equal(tp.current_tiers(), jp.current_tiers())
    np.testing.assert_array_equal(tp.ema_rtt, jp.ema_rtt)
    assert tres.policy is tp
    assert_host_side_equal(jres, tres)
    assert_training_close(jres, tres)


# ---------------------------------------------------------------------------
# core/adaptive (the leaf-level prototype)

SPECS = [(), (r"/bias$",), (r"/kernel$",)]


def test_adaptive_tier_masks_and_comm_report_match_jax():
    jy, jz = jpart.partition(jax_init(0), (r"/bias$",))
    ty, tz = tpart.partition(torch_init(0), (r"/bias$",))
    for jm, tm in zip(jadapt.tier_masks(jax_init(0), SPECS),
                      tadapt.tier_masks(torch_init(0), SPECS)):
        assert [(p, float(v)) for p, v in tbasic.flatten_params(tm)] == \
            [(p, float(v)) for p, v in jbasic.flatten_params(jm)]
    for jr, tr in zip(jadapt.tier_comm_report(jy, jz, SPECS[:2]),
                      tadapt.tier_comm_report(ty, tz, SPECS[:2])):
        assert (tr.full_bytes, tr.trainable_bytes) == (jr.full_bytes,
                                                       jr.trainable_bytes)
        assert tr.reduction == jr.reduction


def test_adaptive_tiered_round_matches_jax():
    """One round of the leaf-level tiered engine, tiers (0, 1, 2, 0): the
    per-leaf mask-weighted mean; y within 1e-5 of max|y|, delta_norm
    within rel 1e-5."""
    ds = make_ds(8)
    batch, w = tsyn.cohort_batch(ds, np.arange(4), RC["local_steps"],
                                 RC["local_batch"], np.random.default_rng(9))
    tiers = np.array([0, 1, 2, 0])
    jround, jsopt = jadapt.make_tiered_round_fn(
        jax_loss, jfedpt.RoundConfig(**RC), SPECS)
    tround, tsopt = tadapt.make_tiered_round_fn(
        torch_loss, tfedpt.RoundConfig(**RC), SPECS, device="cpu")
    y_j, y_t = jax_init(0), torch_init(0)
    jy1, _, jm = jround(y_j, jsopt.init(y_j), {}, batch, jnp.asarray(w),
                        jnp.asarray(tiers, jnp.int32), None)
    ty1, _, tm = tround(y_t, tsopt.init(y_t), {}, batch, w, tiers)
    for a, b in zip(leaves(ty1), leaves(jy1)):
        assert float(np.abs(a - b).max()) <= REL * float(np.abs(b).max())
    assert float(tm["delta_norm"]) == pytest.approx(float(jm["delta_norm"]),
                                                    rel=REL)
    # a leaf no sampled client trains keeps delta 0
    ty2, _, _ = tround(y_t, tsopt.init(y_t), {}, batch, w,
                       np.array([2, 2, 2, 2]))
    assert torch.equal(ty2["dense"]["kernel"], y_t["dense"]["kernel"])


# ---------------------------------------------------------------------------
# core/adaptive_clip (tests/test_adaptive_clip.py's cases), fl/tuning


def test_adaptive_clip_tracks_jax_and_converges():
    """300 geometric updates on the same norms: each step's clip within
    rel 1e-4 of JAX's (float32 exp, compounding over 300 steps), and the
    port converges to the median of lognormal(0, .5) as the reference's
    test requires."""
    jcfg = jac.AdaptiveClipConfig(initial_clip=10.0, target_quantile=0.5,
                                  lr=0.3)
    tcfg = tac.AdaptiveClipConfig(initial_clip=10.0, target_quantile=0.5,
                                  lr=0.3)
    js, ts = jac.init_state(jcfg), tac.init_state(tcfg)
    rng = np.random.default_rng(0)
    for _ in range(300):
        norms = rng.lognormal(0.0, 0.5, 32).astype(np.float32)
        js, jclip = jac.update_state(jcfg, js, jnp.asarray(norms))
        ts, tclip = tac.update_state(tcfg, ts, torch.from_numpy(norms))
        assert float(tclip) == pytest.approx(float(jclip), rel=1e-4)
    assert int(ts["t"]) == int(js["t"]) == 300
    assert 0.7 < float(ts["clip"]) < 1.4


def test_adaptive_clip_noised_count_matches_jax():
    """The noised fraction draws ``normal(rng, ())`` from the key given:
    JAX's bits, the value within rel 1e-6."""
    jcfg = jac.AdaptiveClipConfig(fraction_noise_std=0.3)
    tcfg = tac.AdaptiveClipConfig(fraction_noise_std=0.3)
    norms = np.array([0.05, 0.2, 0.08, 0.3], np.float32)
    for seed in (0, 5):
        js, _ = jac.update_state(jcfg, jac.init_state(jcfg),
                                 jnp.asarray(norms), jax.random.key(seed))
        ts, _ = tac.update_state(tcfg, tac.init_state(tcfg),
                                 torch.from_numpy(norms), threefry.key(seed))
        assert float(ts["clip"]) == pytest.approx(float(js["clip"]),
                                                  rel=1e-6)
    quiet, _ = tac.update_state(tcfg, tac.init_state(tcfg),
                                torch.from_numpy(norms))
    assert float(quiet["clip"]) != float(ts["clip"])


def test_adaptive_clipped_mean_matches_jax():
    deltas = {"w": np.stack([np.full((4,), 10.0, np.float32),
                             np.full((4,), 0.1, np.float32)])}
    norms = np.array([20.0, 0.2], np.float32)
    want = jac.clipped_mean({"w": jnp.asarray(deltas["w"])},
                            jnp.asarray(norms), clip=1.0)
    got = tac.clipped_mean({"w": torch.from_numpy(deltas["w"])},
                           torch.from_numpy(norms), clip=1.0)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["w"].numpy(), (0.5 + 0.1) / 2, rtol=1e-5)


def test_tuning_grid_and_search_match_jax():
    assert ttuning.PAPER_DP_GRID == jtuning.PAPER_DP_GRID
    assert len(ttuning.PAPER_DP_GRID) == 15

    def score(p):
        return -abs(p["client_lr"] - 0.1) - abs(p["server_lr"] - 1.0)
    assert ttuning.search(score, ttuning.PAPER_DP_GRID) == \
        jtuning.search(score, jtuning.PAPER_DP_GRID)
    assert ttuning.grid(a=[1, 2], b=[3]) == jtuning.grid(a=[1, 2], b=[3])


# ---------------------------------------------------------------------------
# the flush accountant's restorable state


@pytest.mark.parametrize("mults", [[1, 1, 2, 1], [3, 1]])
def test_flush_accountant_state_matches_jax(mults):
    cfg = dict(clip_norm=0.5, noise_multiplier=0.4, goal_count=3)
    ja = jdp.FlushAccountant(jdp.FlushDPConfig(**cfg))
    ta = tdp.FlushAccountant(tdp.FlushDPConfig(**cfg))
    for i, m in enumerate(mults):
        n_real = 2 if i == len(mults) - 1 else 3
        ja.record_flush(n_real, multiplicity=m)
        ta.record_flush(n_real, multiplicity=m)
    state = ta.state_dict()
    assert state == ja.state_dict()
    fresh = tdp.FlushAccountant(tdp.FlushDPConfig(**cfg))
    fresh.load_state(state)
    assert fresh.summary() == ta.summary() == ja.summary()
    assert math.isfinite(fresh.epsilon())
    # a reference state restores into the port and back
    jfresh = jdp.FlushAccountant(jdp.FlushDPConfig(**cfg))
    jfresh.load_state(state)
    assert jfresh.summary() == fresh.summary()
    for field, other in (("noise_multiplier", 0.5), ("goal_count", 4),
                         ("clip_norm", 0.6)):
        wrong = tdp.FlushAccountant(tdp.FlushDPConfig(**dict(cfg,
                                                            **{field: other})))
        with pytest.raises(ValueError, match="calibration"):
            wrong.load_state(state)
