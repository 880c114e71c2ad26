"""Checkpoint / resume in the port (``repro_torch.checkpoint``, the grid's
``checkpoint_every`` / ``resume_from``) on the CPU, against itself and
against the JAX package.

First the cases of ``tests/test_resume.py``, run through the port with
the same assertions: a model checkpoint resumes the round loop, and a
killed grid run resumed from its latest snapshot reproduces the straight
run bit for bit (history, y, scheduler stats, wire bytes, DP ledger, hop
ledger). Then the two packages together, on the tiny 64 -> 4 dense model
built from the same parameters (the reference's, carried across by
``repro_torch.bridge``):

* the same kill -> resume in both packages: the host side exactly
  (virtual clock, staleness, scheduler stats, measured and per-hop bytes,
  the DP summary, the shock history), losses and ``y`` within the
  tolerance ``tests/test_torch_grid.py`` states for this model (rel 1e-5,
  ``y`` within 1e-5 of max|y|; float32 training in another framework);
* the ``__grid_meta__`` JSON each package writes at the same flush:
  equal but for the history's ``loss`` / ``delta_norm`` (device values,
  within rel 1e-5); the arrays within the same tolerance;
* each package resumes from the other's snapshot, and the host side of
  the finished run equals the straight run's;
* ``checkpoint.load`` in each package reads the other's model file, the
  server state in JAX's leaf order (``sgd``'s ``()``, ``sgdm``, ``adam``
  with its integer step, DP-FTRL's state).
"""
import dataclasses as dc
import json
import math

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jckpt
from repro.checkpoint import grid_state as jgstate
from repro.core import dp as jdp
from repro.core import fedpt as jfedpt
from repro.nn import basic as jbasic
from repro.optim import optimizers as jopt
from repro.sim import dynamics as jdyn
from repro.sim import faults as jfaults
from repro.sim import grid as jgrid
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint import grid_state as gstate
from repro_torch.core import dp as dp_lib
from repro_torch.core import fedpt
from repro_torch.core import partition as part
from repro_torch.data import synthetic as syn
from repro_torch.models import paper_models as pm
from repro_torch.nn import basic, threefry
from repro_torch.optim import optimizers as topt
from repro_torch.sim import dynamics as dyn_lib
from repro_torch.sim import faults as faults_lib
from repro_torch.sim import grid as simgrid

REL = 1e-5


def _loss(params, b):
    logits = pm.emnist_cnn_forward(params, b["images"])
    lp = torch.log_softmax(logits, -1)
    return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}


def _train(y, ss, frozen, round_fn, ds, rounds, start=0):
    rng = np.random.default_rng(42)
    # regenerate the deterministic cohort stream and skip `start` rounds
    cohorts = []
    for r in range(start + rounds):
        cids = syn.sample_cohort(rng, 8, 4)
        batch, w = syn.cohort_batch(ds, cids, 1, 8, rng)
        cohorts.append((batch, w))
    for r in range(start, start + rounds):
        batch, w = cohorts[r]
        y, ss, _ = round_fn(y, ss, frozen, batch, w, threefry.key(r))
    return y, ss


def test_resume_equals_straight_run(tmp_path):
    ds = syn.make_federated_images(8, 24, (28, 28, 1), 62, seed=9)
    SEED = 5
    init_fn = lambda s: pm.init_emnist_cnn(s, device="cpu")  # noqa: E731
    y0, frozen = part.partition(init_fn(SEED), pm.EMNIST_FREEZE)
    rc = fedpt.RoundConfig(4, 1, 8, "sgd", 0.05, "sgdm", 0.5)
    round_fn, sopt = fedpt.make_round_fn(_loss, rc, device="cpu")

    # straight: 4 rounds
    yA, ssA = _train(y0, sopt.init(y0), frozen, round_fn, ds, 4)

    # split: 2 rounds -> checkpoint -> restore -> 2 rounds
    y1, ss1 = _train(y0, sopt.init(y0), frozen, round_fn, ds, 2)
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, y1, seed=SEED, freeze_spec=pm.EMNIST_FREEZE,
              server_state=ss1, round_num=2)
    y2, seed2, spec2, ss2, rnd, _ = ckpt.load(path, server_state_template=ss1,
                                              device="cpu")
    assert (seed2, spec2, rnd) == (SEED, pm.EMNIST_FREEZE, 2)
    frozen2 = part.partition(init_fn(seed2), tuple(spec2))[1]
    yB, ssB = _train(y2, ss2, frozen2, round_fn, ds, 2, start=2)

    for (ka, va), (kb, vb) in zip(basic.flatten_params(yA),
                                  basic.flatten_params(yB)):
        assert ka == kb
        np.testing.assert_allclose(va.numpy(), vb.numpy(), rtol=1e-6,
                                   atol=1e-7)
    # the whole model: trainable from the file, frozen from the seed
    full, rnd = ckpt.restore_full_model(path, init_fn, device="cpu")
    assert rnd == 2
    want = part.merge(y1, frozen)
    for (ka, va), (kb, vb) in zip(basic.flatten_params(full),
                                  basic.flatten_params(want)):
        assert ka == kb and torch.equal(va, vb)


def test_checkpoint_save_load_appends_npz_suffix(tmp_path):
    """save()/load() agree on the on-disk name even when the caller
    omits ``.npz`` (np.savez appends it on write)."""
    y = {"dense": basic.init_dense(0, "dense", 8, 4, torch.float32,
                                   bias=True, device="cpu")}
    bare = str(tmp_path / "model")            # no suffix
    ckpt.save(bare, y, seed=0, freeze_spec=(), round_num=3)
    assert (tmp_path / "model.npz").exists()
    y2, seed, spec, ss, rnd, meta = ckpt.load(bare, device="cpu")
    assert seed == 0 and rnd == 3
    for (ka, va), (kb, vb) in zip(basic.flatten_params(y),
                                  basic.flatten_params(y2)):
        assert ka == kb
        assert torch.equal(va, vb)


# ---------------------------------------------------------------------------
# grid-state snapshots: kill -> restore -> continue (chaos marker: these
# exercise the fault model end to end)

pytest_grid = pytest.mark.chaos


def _g_init(seed):
    return {"dense": basic.init_dense(seed, "dense", 64, 4, torch.float32,
                                      bias=True, device="cpu")}


def _g_loss(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = torch.log_softmax(basic.dense(x, params["dense"]), -1)
    return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}


def _g_ds():
    return syn.make_federated_images(12, 30, (8, 8, 1), 4, seed=0,
                                     test_examples=64)


G_RC = dict(clients_per_round=4, local_steps=2, local_batch=8,
            client_opt="sgd", client_lr=0.1, server_opt="sgd", server_lr=1.0)
CHAOS = dict(crash_compute=0.05, truncate_upload=0.05, corrupt_nan=0.08,
             corrupt_bitflip=0.08, duplicate_upload=0.05)
SHOCKS = dict(every=0.01, duration=0.05, residual=0.0)


def _leaves(tree):
    return [np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                       else v) for _, v in basic.flatten_params(tree)]


def _assert_same_run(a, b):
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    for ha, hb in zip(a.history, b.history):
        assert ha["virtual_seconds"] == hb["virtual_seconds"]
    for (ka, va), (kb, vb) in zip(basic.flatten_params(a.y),
                                  basic.flatten_params(b.y)):
        assert ka == kb
        assert torch.equal(va, vb), f"{ka} differs after resume"
    assert a.scheduler_stats == b.scheduler_stats
    assert a.comm.measured_up_bytes == b.comm.measured_up_bytes
    assert a.comm.measured_down_bytes == b.comm.measured_down_bytes
    assert a.dp == b.dp


def _run(gc, rc, n, seed=3, resume_from=None):
    if resume_from is not None:
        gc = dc.replace(gc, resume_from=resume_from)
    return simgrid.run_grid(_g_init, _g_loss, _g_ds(), rc, n, grid=gc,
                            seed=seed, device="cpu")


def _kill_then_resume(gbase, killed_cfg, rc, n, seed=3):
    """Run ``killed_cfg`` until ServerKilled, then resume ``gbase`` from
    the checkpoint the kill left behind."""
    with pytest.raises(faults_lib.ServerKilled) as ei:
        _run(killed_cfg, rc, n, seed)
    assert ei.value.checkpoint is not None
    return _run(gbase, rc, n, seed, resume_from=ei.value.checkpoint)


def _killed(gbase, straight, tmp_path, faults, lo=4):
    """``gbase`` killed between updates ``lo`` and ``lo + 1`` of the
    straight run, snapshotting every 2."""
    T = 0.5 * (straight.history[lo]["virtual_seconds"]
               + straight.history[lo + 1]["virtual_seconds"])
    return dc.replace(gbase, faults=dict(faults, server_kill_at=T),
                      checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "ckpt"))


@pytest_grid
def test_async_kill_resume_bitwise(tmp_path):
    """Chaos faults + sanitize + per-flush DP + jittered dynamics, killed
    mid-run, resumed from the latest snapshot: history, y, epsilon ledger
    and wire billing all match the uninterrupted run."""
    rc = fedpt.RoundConfig(**G_RC, dp_clip_norm=1.0, dp_noise_multiplier=0.6)
    gbase = simgrid.GridConfig(mode="async", faults=CHAOS, sanitize=True,
                               dynamics="jitter")
    straight = _run(gbase, rc, 8)
    resumed = _kill_then_resume(
        gbase, _killed(gbase, straight, tmp_path, CHAOS), rc, 8)
    _assert_same_run(straight, resumed)
    assert resumed.dp["epsilon"] == straight.dp["epsilon"]


@pytest_grid
def test_sync_kill_resume_bitwise(tmp_path):
    rc = fedpt.RoundConfig(**G_RC)
    gbase = simgrid.GridConfig(mode="sync", faults={"crash_compute": 0.1})
    straight = _run(gbase, rc, 8)
    resumed = _kill_then_resume(
        gbase, _killed(gbase, straight, tmp_path, {"crash_compute": 0.1}),
        rc, 8)
    _assert_same_run(straight, resumed)


@pytest_grid
def test_async_hierarchical_shock_kill_resume_bitwise(tmp_path):
    """Hierarchical + correlated-shock resume: the topology meta, the
    shock process and the per-region edge counters all ride the snapshot,
    down to the edge_server hop ledger."""
    rc = fedpt.RoundConfig(**G_RC)
    gbase = simgrid.GridConfig(
        mode="async", faults=CHAOS, sanitize=True, topology=3,
        dynamics=dyn_lib.DynamicsConfig(
            shocks=dyn_lib.RegionShocks(**SHOCKS)))
    straight = _run(gbase, rc, 8)
    resumed = _kill_then_resume(
        gbase, _killed(gbase, straight, tmp_path, CHAOS), rc, 8)
    _assert_same_run(straight, resumed)
    assert straight.comm.hop_traffic == resumed.comm.hop_traffic
    assert straight.comm.hop_traffic["edge_server"]["uploads"] > 0


@pytest_grid
def test_sync_hierarchical_shock_kill_resume_bitwise(tmp_path):
    rc = fedpt.RoundConfig(**G_RC)
    gbase = simgrid.GridConfig(
        mode="sync", faults={"crash_compute": 0.1}, topology=3,
        over_selection=1.5,
        dynamics=dyn_lib.DynamicsConfig(
            shocks=dyn_lib.RegionShocks(**SHOCKS)))
    straight = _run(gbase, rc, 8)
    resumed = _kill_then_resume(
        gbase, _killed(gbase, straight, tmp_path, {"crash_compute": 0.1}),
        rc, 8)
    _assert_same_run(straight, resumed)
    assert straight.comm.hop_traffic == resumed.comm.hop_traffic


@pytest_grid
def test_resume_topology_mismatch_rejected(tmp_path):
    """A snapshot from a 3-region run must not silently resume onto a
    different (or flat) topology."""
    rc = fedpt.RoundConfig(**G_RC)
    _run(simgrid.GridConfig(mode="sync", topology=3, checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "ckpt")), rc, 4)
    snap = gstate.latest(str(tmp_path / "ckpt"))
    assert snap is not None
    with pytest.raises(ValueError):
        _run(simgrid.GridConfig(mode="sync"), rc, 4, resume_from=snap)
    with pytest.raises(ValueError):
        _run(simgrid.GridConfig(mode="sync", topology=5), rc, 4,
             resume_from=snap)


@pytest_grid
def test_async_resume_multitier_adaptive_policy(tmp_path):
    """Resume carries the whole policy / plan state: a two-tier plan with
    the adaptive-capability policy continues exactly — kill-only fault
    config, resumed without faults."""
    rc = fedpt.RoundConfig(**G_RC)
    gbase = simgrid.GridConfig(mode="async",
                               plan={"full": (), "lite": (r"/kernel$",)},
                               selection="adaptive-capability",
                               fleet="pareto-mobile", dynamics="jitter")
    straight = _run(gbase, rc, 8)
    resumed = _kill_then_resume(
        gbase, _killed(gbase, straight, tmp_path, {}, lo=5), rc, 8)
    _assert_same_run(straight, resumed)
    assert straight.tier_stats == resumed.tier_stats


@pytest_grid
def test_resume_mode_mismatch_rejected(tmp_path):
    rc = fedpt.RoundConfig(**G_RC)
    _run(simgrid.GridConfig(mode="sync", checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "ckpt")), rc, 4)
    snap = gstate.latest(str(tmp_path / "ckpt"))
    assert snap is not None
    with pytest.raises(ValueError, match="mode must match"):
        _run(simgrid.GridConfig(mode="async"), rc, 4, resume_from=snap)


@pytest_grid
def test_grid_state_rejects_legacy_model_checkpoint(tmp_path):
    """A model checkpoint is not a grid-state snapshot: load_state fails
    with a pointer to checkpoint.load, which still reads it fine."""
    y = {"dense": _g_init(0)["dense"]}
    path = str(tmp_path / "model.npz")
    ckpt.save(path, y, seed=0, freeze_spec=(), round_num=1)
    with pytest.raises(ValueError, match="checkpoint.load"):
        gstate.load_state(path)
    y2, *_ = ckpt.load(path, device="cpu")
    assert torch.equal(y["dense"]["kernel"], y2["dense"]["kernel"])


@pytest_grid
def test_grid_state_version_gate(tmp_path):
    path = gstate.save_state(str(tmp_path / "future"),
                             {"grid_state_version": 999, "mode": "async"},
                             {})
    with pytest.raises(ValueError, match="version 999"):
        gstate.load_state(path)


@pytest_grid
def test_accountant_ledger_roundtrip():
    cfg = dp_lib.FlushDPConfig(clip_norm=1.0, noise_multiplier=0.8,
                               goal_count=5)
    a = dp_lib.FlushAccountant(cfg)
    a.record_flush(5, multiplicity=1, now=1.0)
    a.record_flush(3, multiplicity=2, now=2.0)   # padded, duplicated
    b = dp_lib.FlushAccountant(cfg)
    b.load_state(a.state_dict())
    assert b.summary() == a.summary()
    assert b.epsilon(1e-5) == a.epsilon(1e-5)
    # continuing the restored ledger composes identically
    a.record_flush(5, now=3.0)
    b.record_flush(5, now=3.0)
    assert math.isclose(a.epsilon(1e-5), b.epsilon(1e-5), rel_tol=0.0)
    # a different calibration must refuse the ledger
    other = dp_lib.FlushAccountant(
        dp_lib.FlushDPConfig(clip_norm=1.0, noise_multiplier=0.4,
                             goal_count=5))
    with pytest.raises(ValueError, match="calibration|sigma|match"):
        other.load_state(a.state_dict())


@pytest_grid
def test_rng_state_json_roundtrip_exact():
    g = np.random.default_rng(1234)
    g.standard_normal(17)
    state = json.loads(json.dumps(gstate.rng_state(g)))
    h = np.random.default_rng(0)
    gstate.set_rng_state(h, state)
    np.testing.assert_array_equal(g.standard_normal(32),
                                  h.standard_normal(32))


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


def _cfgs(**kw):
    """The same GridConfig in both packages; ``shocks`` builds each
    package's own RegionShocks."""
    shocks = kw.pop("shocks", None)
    out = []
    for grid_mod, dyn_mod in ((jgrid, jdyn), (simgrid, dyn_lib)):
        extra = ({} if shocks is None else dict(
            dynamics=dyn_mod.DynamicsConfig(
                shocks=dyn_mod.RegionShocks(**shocks))))
        out.append(grid_mod.GridConfig(**kw, **extra))
    return out


def _run_pkg(pkg, gc, rc_kw, n, resume_from=None, seed=3):
    if resume_from is not None:
        gc = dc.replace(gc, resume_from=resume_from)
    if pkg == "jax":
        return jgrid.run_grid(_j_init, _j_loss, _g_ds(),
                              jfedpt.RoundConfig(**rc_kw), n, grid=gc,
                              seed=seed)
    return simgrid.run_grid(_t_init, _g_loss, _g_ds(),
                            fedpt.RoundConfig(**rc_kw), n, grid=gc,
                            seed=seed, device="cpu")


def _kill_pkg(pkg, gc, rc_kw, n):
    kill = jfaults.ServerKilled if pkg == "jax" else faults_lib.ServerKilled
    with pytest.raises(kill) as ei:
        _run_pkg(pkg, gc, rc_kw, n)
    assert ei.value.checkpoint is not None
    return ei.value.checkpoint


def assert_host_side_equal(jres, tres, traces=True):
    """``traces``: compare the telemetry too (False where one run resumed,
    whose fresh tracer starts at the snapshot)."""
    assert len(tres.history) == len(jres.history)
    for hj, ht in zip(jres.history, tres.history):
        assert set(ht) == set(hj)
        for k, v in hj.items():
            if k not in ("loss", "delta_norm"):
                assert ht[k] == v, k
    assert tres.virtual_seconds == jres.virtual_seconds
    assert tres.scheduler_stats == jres.scheduler_stats
    for f in ("measured_down_bytes", "measured_up_bytes", "transfers",
              "hop_traffic", "tier_traffic"):
        assert getattr(tres.comm, f) == getattr(jres.comm, f), f
    assert tres.dp == jres.dp
    assert tres.faults == jres.faults
    if jres.topology is not None:
        np.testing.assert_array_equal(tres.topology.region_of,
                                      jres.topology.region_of)
        for name in ("edge_flushes", "edge_up_bytes", "edge_down_bytes",
                     "region_dispatches", "region_uploads"):
            assert (tres.metrics.counter(name).labels
                    == jres.metrics.counter(name).labels), name
    if traces and jres.telemetry is not None:
        # the traces record by record: the shocks fired, each dispatch,
        # upload, flush and edge flush; payload values the device computes
        # (losses, norms) within rel 1e-5
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
                elif k != "path":
                    assert a.payload[k] == v, (a.kind, k)


DEVICE_VALUES = ("loss", "norm", "delta_norm")


def assert_training_close(jres, tres):
    assert [h["loss"] for h in tres.history] == pytest.approx(
        [h["loss"] for h in jres.history], rel=REL)
    for a, b in zip(_leaves(tres.y), _leaves(jres.y)):
        assert float(np.abs(a - b).max()) <= REL * float(np.abs(b).max())


ASYNC_DP = dict(G_RC, dp_clip_norm=1.0, dp_noise_multiplier=0.6)


@pytest_grid
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_kill_resume_matches_jax(mode, tmp_path):
    """The flagship cases in both packages: the straight runs agree, and
    each package's resumed run equals its own straight run on the host
    side and JAX's within the stated tolerance."""
    if mode == "async":
        rc_kw, faults = ASYNC_DP, CHAOS
        gj, gt = _cfgs(mode="async", faults=CHAOS, sanitize=True,
                       dynamics="jitter", telemetry=True)
    else:
        rc_kw, faults = G_RC, {"crash_compute": 0.1}
        gj, gt = _cfgs(mode="sync", faults=faults, telemetry=True)
    jstraight = _run_pkg("jax", gj, rc_kw, 8)
    tstraight = _run_pkg("torch", gt, rc_kw, 8)
    assert_host_side_equal(jstraight, tstraight)
    assert_training_close(jstraight, tstraight)
    resumed = {}
    for pkg, gc in (("jax", gj), ("torch", gt)):
        killed = _killed(gc, jstraight, tmp_path / pkg, faults)
        resumed[pkg] = _run_pkg(pkg, gc, rc_kw, 8,
                                resume_from=_kill_pkg(pkg, killed, rc_kw, 8))
    assert_host_side_equal(jstraight, resumed["jax"], traces=False)
    assert_host_side_equal(jstraight, resumed["torch"], traces=False)
    assert_host_side_equal(resumed["jax"], resumed["torch"])
    _assert_same_run(tstraight, resumed["torch"])
    assert_training_close(resumed["jax"], resumed["torch"])


def _strip(meta):
    """The meta with the history's device values taken out."""
    out = json.loads(json.dumps(meta))
    for rec in out["history"]:
        rec.pop("loss", None)
        rec.pop("delta_norm", None)
    return out


@pytest_grid
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_grid_meta_equals_jax_at_the_same_flush(mode, tmp_path):
    """Every snapshot of the 4-region shocked run, written by each
    package at the same flush (round): the ``__grid_meta__`` JSON equal
    but for the history's losses / norms (within rel 1e-5), the same
    array keys, ``y`` and the in-flight deltas within the tolerance."""
    kw = dict(mode=mode, topology=4, shocks=SHOCKS, checkpoint_every=2,
              telemetry=True)
    if mode == "async":
        kw.update(faults=CHAOS, sanitize=True)
        rc_kw = ASYNC_DP
    else:
        kw.update(over_selection=1.5)
        rc_kw = G_RC
    dirs = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    gj, gt = _cfgs(**kw, checkpoint_dir=dirs["jax"])
    gt = dc.replace(gt, checkpoint_dir=dirs["torch"])
    jres = _run_pkg("jax", gj, rc_kw, 6)
    tres = _run_pkg("torch", gt, rc_kw, 6)
    assert_host_side_equal(jres, tres)
    for n in (2, 4, 6):
        name = f"grid_{mode}_{n:06d}.npz"
        jmeta, jarr = jgstate.load_state(f"{dirs['jax']}/{name}")
        tmeta, tarr = gstate.load_state(f"{dirs['torch']}/{name}")
        assert _strip(tmeta) == _strip(jmeta)
        for ht, hj in zip(tmeta["history"], jmeta["history"]):
            for k in ("loss", "delta_norm"):
                if k in hj:
                    assert ht[k] == pytest.approx(hj[k], rel=REL)
        assert sorted(tarr) == sorted(jarr)
        for k in jarr:
            assert tarr[k].dtype == jarr[k].dtype and \
                tarr[k].shape == jarr[k].shape, k
            scale = float(np.abs(jarr[k]).max(initial=0.0))
            assert float(np.abs(tarr[k] - jarr[k]).max(initial=0.0)) <= \
                REL * scale, k


@pytest_grid
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_resume_from_the_other_packages_snapshot(mode, tmp_path):
    """A 4-region shocked run killed in one package resumes in the other;
    the finished run's host side equals the straight JAX run's, and y
    the straight run's within the tolerance."""
    kw = dict(mode=mode, topology=4, shocks=SHOCKS, telemetry=True)
    if mode == "async":
        kw.update(faults=CHAOS, sanitize=True)
        rc_kw, faults = G_RC, CHAOS
    else:
        kw.update(faults={"crash_compute": 0.1}, over_selection=1.5)
        rc_kw, faults = G_RC, {"crash_compute": 0.1}
    gj, gt = _cfgs(**kw)
    jstraight = _run_pkg("jax", gj, rc_kw, 8)
    jsnap = _kill_pkg("jax", _killed(gj, jstraight, tmp_path / "j", faults),
                      rc_kw, 8)
    tsnap = _kill_pkg("torch", _killed(gt, jstraight, tmp_path / "t",
                                       faults), rc_kw, 8)
    port_from_jax = _run_pkg("torch", gt, rc_kw, 8, resume_from=jsnap)
    jax_from_port = _run_pkg("jax", gj, rc_kw, 8, resume_from=tsnap)
    for res in (port_from_jax, jax_from_port):
        assert_host_side_equal(jstraight, res, traces=False)
        assert_training_close(jstraight, res)
    assert_host_side_equal(jax_from_port, port_from_jax)
    assert jstraight.comm.hop_traffic["edge_server"]["uploads"] > 0


def _sstates(name, y_np):
    """(JAX state, port state) of a server optimizer after two updates
    from the same gradients."""
    g = {"dense": {"bias": np.full(4, 0.25, np.float32),
                   "kernel": np.linspace(-1, 1, 256, dtype=np.float32
                                         ).reshape(64, 4)}}
    if name == "dp-ftrl":
        jo = jdp.dp_ftrl_server_opt(jdp.DPFTRLConfig(
            lr=0.3, noise_multiplier=0.0, clip_norm=0.3,
            clients_per_round=4))
        to = dp_lib.dp_ftrl_server_opt(dp_lib.DPFTRLConfig(
            lr=0.3, noise_multiplier=0.0, clip_norm=0.3,
            clients_per_round=4))
    else:
        jo, to = jopt.get_optimizer(name, 0.1), topt.get_optimizer(name, 0.1)
    yj = jax.tree_util.tree_map(jnp.asarray, y_np)
    yt = bridge.from_numpy_tree(y_np, "cpu")
    sj, st = jo.init(yj), to.init(yt)
    for _ in range(2):
        yj, sj = jo.update(yj, jax.tree_util.tree_map(jnp.asarray, g), sj)
        yt, st = to.update(yt, bridge.from_numpy_tree(g, "cpu"), st)
    return sj, st


@pytest.mark.parametrize("opt", ["sgd", "sgdm", "adam", "dp-ftrl"])
def test_model_checkpoint_cross_loads(opt, tmp_path):
    """``checkpoint.load`` in each package reads the other's file: the
    trainable tree exactly, the server state leaf for leaf in JAX's
    order (within rel 1e-6 of each other: the same float32 updates in
    two frameworks), an integer step back as the template's type."""
    y_np = jax.tree_util.tree_map(np.asarray, _j_init(0))
    sj, st = _sstates(opt, y_np)
    yt = bridge.from_numpy_tree(y_np, "cpu")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jpath, y_np, seed=7, freeze_spec=(r"^conv",), server_state=sj,
               round_num=2, extra={"k": 1})
    ckpt.save(tpath, yt, seed=7, freeze_spec=(r"^conv",), server_state=st,
              round_num=2, extra={"k": 1})
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert json.loads(str(zj["__meta__"])) == json.loads(
            str(zt["__meta__"]))
        for k in zj.files:
            if k != "__meta__":
                assert zj[k].dtype == zt[k].dtype and \
                    zj[k].shape == zt[k].shape, k
    # the port reads JAX's file
    y2, seed, spec, s2, rnd, extra = ckpt.load(
        jpath, server_state_template=st, device="cpu")
    assert (seed, spec, rnd, extra) == (7, (r"^conv",), 2, {"k": 1})
    for a, b in zip(_leaves(y2), _leaves(yt)):
        assert np.array_equal(a, b)
    jl = jax.tree_util.tree_leaves(sj)
    tl = ckpt.state_leaves(s2)
    assert len(tl) == len(jl) == len(ckpt.state_leaves(st))
    for a, b, like in zip(tl, jl, ckpt.state_leaves(st)):
        assert type(a) is type(like)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    # JAX reads the port's file
    y3, seed, spec, s3, rnd, extra = jckpt.load(tpath,
                                                server_state_template=sj)
    assert (seed, tuple(spec), rnd) == (7, (r"^conv",), 2)
    for a, b in zip(jax.tree_util.tree_leaves(y3), _leaves(yt)):
        assert np.array_equal(np.asarray(a), b)
    assert jax.tree_util.tree_structure(s3) == \
        jax.tree_util.tree_structure(sj)
    for a, b in zip(jax.tree_util.tree_leaves(s3), jl):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("tree", [(), {"m": {"b": 1, "a": 2}, "t": 3,
                                       "v": (1, 2)}, [1, None], None, 5,
                                  {"x": ()}, (4,)])
def test_treedef_string_is_jaxs(tree):
    assert ckpt.treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    assert len(ckpt.state_leaves(tree)) == len(jax.tree_util.tree_leaves(
        tree))
