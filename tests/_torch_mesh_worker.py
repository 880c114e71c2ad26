"""One rank of the port's multi-rank mesh scenarios (``gloo`` on the CPU),
spawned by ``tests/test_torch_mesh.py`` and ``tests/test_torch_tp.py``:

    python tests/_torch_mesh_worker.py RANK WORLD STORE OUT INIT [tp]

joins a world of WORLD ranks over the file store STORE, runs every
scenario of that world size on the port's meshes and writes its results
to OUT/rank<RANK>.pkl. INIT holds the tiny and the wide dense models'
parameters (numpy, made once by the test from the reference's init),
the wide engines' inputs and the reduced StableLM's round inputs; with
``tp``, the tensor-parallel cases' configs, parameters and batches, and
only those run. The test imports this module for the scenarios'
settings and runs the unmeshed twins of its engines and grids itself.
Imports no JAX.
"""
import dataclasses
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.core import dp as dp_lib  # noqa: E402
from repro_torch.core import fedpt  # noqa: E402
from repro_torch.core import flat as flat_lib  # noqa: E402
from repro_torch.core import partition as part  # noqa: E402
from repro_torch.core import sanitize as sanitize_lib  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as shard_lib  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.nn import basic, threefry  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.sim import grid as simgrid  # noqa: E402

RC = fedpt.RoundConfig(4, 2, 8, "sgd", 0.1, "sgd", 1.0)
RC_DP = fedpt.RoundConfig(4, 2, 8, "sgd", 0.1, "sgd", 1.0,
                          dp_clip_norm=0.5, dp_noise_multiplier=0.4)
PLAN = {"full": (), "mid": (r"/bias$",), "lite": (r"/kernel$",)}
ASSIGN = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2]
# the wide cases: int8 uplinks, a DP clip and noise, and a screen tight
# enough to quarantine norm outliers of clean rows, on the 64 -> 64 dense
# model (its kernel leaf of four 1024-blocks spans both "model" ranks)
WIDE_RC = fedpt.RoundConfig(4, 2, 8, "sgd", 0.1, "sgd", 1.0, uplink_bits=8,
                            dp_clip_norm=0.5, dp_noise_multiplier=0.4)
WIDE_WIDTH = 64
SCREEN = {"norm_mult": 1.1}
FAULTS = {"corrupt_nan": 0.15, "corrupt_bitflip": 0.15}
THRESHOLDS = (None, 0)        # the tail's default route, and fused forced


def numpy_tree(tree):
    return basic.tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def summary(res):
    """What the test compares of a GridResult, as plain data (with the
    quarantine events when the run recorded telemetry)."""
    return {"history": res.history, "scheduler_stats": res.scheduler_stats,
            "up_bytes": res.comm.measured_up_bytes,
            "tier_traffic": res.comm.tier_traffic, "dp": res.dp,
            "tier_stats": res.tier_stats, "y": numpy_tree(res.y),
            "quarantine": None if res.telemetry is None else [
                dict(r.payload) for r in res.telemetry.of_kind(
                    "quarantine")]}


def make_ds():
    return syn.make_federated_images(12, 30, (8, 8, 1), 4, seed=0,
                                     test_examples=32)


def loss_fn(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = torch.log_softmax(basic.dense(x, params["dense"]), -1)
    return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}


def wide_grid(init, mesh, mode, threshold, device="cpu"):
    """One wide grid run (``WIDE_RC``, the screen, telemetry): sync, or
    async with corrupted uploads (NaN and exponent flips) for the screen
    to quarantine. ``mesh=None`` is the unmeshed run."""
    kw = (dict(mode="sync") if mode == "sync" else
          dict(mode="async", concurrency=5, goal_count=4, faults=FAULTS))
    gc = simgrid.GridConfig(mesh=mesh, sanitize=SCREEN, telemetry=True,
                            agg_tail_threshold=threshold, **kw)

    def init_fn(seed):
        return basic.tree_map(torch.as_tensor, init["wide"][seed])
    return simgrid.run_grid(init_fn, loss_fn, make_ds(), WIDE_RC,
                            4 if mode == "sync" else 6, grid=gc,
                            seed=1 if mode == "sync" else 2, device=device)


def sync_engine(init, plane, threshold):
    """One wide sync round from the same inputs (a NaN client and a large
    one in the cohort): y and the metrics, the screen's and the clip's
    per-row results among them."""
    y, z = part.partition(basic.tree_map(torch.as_tensor, init["wide"][0]),
                          ())
    round_fn, sopt = fedpt.make_round_fn(
        loss_fn, WIDE_RC, device="cpu",
        sanitize=sanitize_lib.resolve_sanitize(SCREEN),
        fused_threshold=threshold, constrain_flat_fn=plane)
    batch = {k: torch.as_tensor(v) for k, v in init["wide_batch"].items()}
    y_new, _, m = round_fn(y, sopt.init(y), z, batch,
                           torch.as_tensor(init["wide_weights"]),
                           threefry.key(5))
    return {"y": numpy_tree(y_new), **{k: v.numpy() for k, v in m.items()}}


def apply_engine(init, plane, threshold):
    """One wide flush with per-flush DP and the screen from the same (6,
    size) buffer (a NaN row, an outlier row, a padding row)."""
    y, _ = part.partition(basic.tree_map(torch.as_tensor, init["wide"][0]),
                          ())
    rows = torch.as_tensor(init["wide_rows"])
    sopt = opt_lib.sgd(1.0)
    apply = fedpt.make_buffered_apply(
        sopt, flush_dp=dp_lib.FlushDPConfig(clip_norm=0.5,
                                            noise_multiplier=0.4,
                                            goal_count=rows.shape[0]),
        sanitize=sanitize_lib.resolve_sanitize(SCREEN),
        fused_threshold=threshold, device="cpu", constrain_flat_fn=plane)
    y_new, _, m = apply(y, sopt.init(y), rows,
                        torch.as_tensor(init["wide_row_weights"]),
                        threefry.key(7))
    return {"y": numpy_tree(y_new), **{k: v.numpy() for k, v in m.items()}}


def wide_runs(init, mesh_name, mesh):
    plane = shard_lib.flat_constrainer(mesh)
    out = {}
    for thr in THRESHOLDS:
        for mode in ("sync", "async"):
            out["grid", mode, thr] = summary(wide_grid(init, mesh_name, mode,
                                                       thr))
        out["sync_engine", thr] = sync_engine(init, plane, thr)
        out["apply_engine", thr] = apply_engine(init, plane, thr)
    return out


def grid_runs(init, mesh, debug):
    ds = make_ds()

    def init_fn(seed):
        return basic.tree_map(torch.as_tensor, init[seed])

    def run(rc, rounds, seed, **gkw):
        gc = simgrid.GridConfig(mesh=mesh, **gkw)
        return summary(simgrid.run_grid(init_fn, loss_fn, ds, rc, rounds,
                                        grid=gc, seed=seed, device="cpu"))

    out = {"async": run(RC, 8, 2, mode="async", fleet="pareto-mobile",
                        concurrency=6, goal_count=3)}
    if not debug:
        return out
    out["sync"] = run(RC, 4, 1, mode="sync")
    out["async_dp"] = run(RC_DP, 6, 3, mode="async", concurrency=5,
                          goal_count=3)
    out["async_tiers"] = run(RC, 8, 2, mode="async", fleet="pareto-mobile",
                             concurrency=6, goal_count=3, plan=PLAN,
                             tier_assignment=ASSIGN)
    out["sync_tiers"] = run(RC, 4, 1, mode="sync",
                            plan={"full": (), "lite": (r"/bias$",)},
                            tier_assignment=[0, 1] * 6)
    # the deadline: midway between the 2nd and 3rd flush of the full run
    # (the test checks the cut against the unmeshed run's clock)
    out["drain"] = run(RC_DP, 6, 2, mode="async", concurrency=4,
                       goal_count=3, async_deadline=init["drain_cut"])
    return out


def apply_pairs(init, mesh):
    """The padded-flush cases of the reference's multidevice tests: the
    buffered apply on the mesh against the unmeshed one and against the
    mechanism composed by hand."""
    y, _ = part.partition(basic.tree_map(torch.as_tensor, init[0]), ())
    layout = flat_lib.FlatLayout.of(y)
    sopt = opt_lib.sgd(1.0)
    plane = shard_lib.flat_constrainer(mesh)
    K = 4
    rows = 0.01 * threefry.normal(threefry.key(0), (K, layout.size))
    out = {}
    w = torch.tensor([1.0, 0.5, 0.0, 0.0])
    sharded = fedpt.make_buffered_apply(sopt, device="cpu",
                                        constrain_flat_fn=plane)
    plain = fedpt.make_buffered_apply(sopt, device="cpu")
    garbage = rows.clone()
    garbage[2:] = 7.7
    want = plain(y, sopt.init(y), torch.cat([rows[:2], torch.zeros_like(
        rows[2:])]), w)
    out["padded"] = [(numpy_tree(want[0]), float(want[2]["delta_norm"]))]
    for padded in (flat_lib.pad_rows(rows[:2], K), garbage):
        ym, _, mm = sharded(y, sopt.init(y), padded, w)
        out["padded"].append((numpy_tree(ym), float(mm["delta_norm"])))

    flush_dp = dp_lib.FlushDPConfig(clip_norm=1.0, noise_multiplier=0.5,
                                    goal_count=K)
    sharded = fedpt.make_buffered_apply(sopt, flush_dp=flush_dp,
                                        device="cpu",
                                        constrain_flat_fn=plane)
    rows = 0.01 * threefry.normal(threefry.key(1), (K, layout.size))
    w_full = torch.tensor([1.0, 0.8, 0.6, 0.4])
    w_pad = torch.tensor([1.0, 0.8, 0.0, 0.0])
    rng = threefry.key(9)
    den = torch.tensor(float(K))

    def manual(mat, w):
        flat = flat_lib.add_noise(flat_lib.weighted_mean(mat, w, den),
                                  flush_dp.sigma, rng)
        return basic.tree_map(lambda a, d: a + d, y,
                              layout.unflatten(flat, torch.float32))

    res = []
    for mat, w in ((rows, w_full), (flat_lib.pad_rows(rows[:2], K), w_pad)):
        ym, _, _ = sharded(y, sopt.init(y), mat, w, rng)
        res.append((numpy_tree(ym), numpy_tree(manual(mat, w))))
    gap = (flat_lib.weighted_mean(rows, w_full, den)
           - flat_lib.weighted_mean(flat_lib.pad_rows(rows[:2], K), w_pad,
                                    den))
    out["dp_fixed"] = {"pairs": res, "gap": numpy_tree(
        layout.unflatten(gap, torch.float32))}
    return out


def flat_shardings(mesh, name):
    """The plane's placements as the reference's specs, and the presets'
    resolution."""
    plane = shard_lib.flat_constrainer(mesh)
    out = {"same": mesh_lib.resolve_mesh(mesh) is mesh
           and mesh_lib.resolve_mesh(name, "cpu") is mesh,
           "clients": shard_lib.spec_of(plane.placements(True), mesh, 2),
           "vector": shard_lib.spec_of(plane.placements(False), mesh, 1)}
    try:
        mesh_lib.resolve_mesh("galaxy-brain", "cpu")
    except ValueError as e:
        out["unknown"] = str(e)
    mat = torch.arange(4 * 4096, dtype=torch.float32).reshape(4, 4096)
    out["block"] = plane(mat, clients=True).numpy()
    out["cols"] = plane(mat[0], clients=False).numpy()
    return out


def train_step_case(init, mesh, key="stablelm"):
    """make_train_step on a reduced config over the mesh (``key``: the
    StableLM, tensor-parallel, or ``gathered``, a config that keeps the
    gathered layout), y and the server state placed as DTensors by the
    reference's rules."""
    cfg = init[f"{key}_cfg"]
    params = basic.tree_map(torch.as_tensor, init[f"{key}_params"])
    y, z = part.partition(params, cfg.freeze_spec)
    step, sopt = specs.make_train_step(cfg, mesh, y, device="cpu")
    shard_y = shard_lib.param_shardings(y, cfg, mesh)
    yd = basic.tree_map(lambda x, pl: shard_lib.distribute(x, mesh, pl),
                        y, shard_y)
    ss = basic.tree_map(lambda x, pl: shard_lib.distribute(x, mesh, pl),
                        sopt.init(y), shard_y)
    batch = {k: torch.as_tensor(v) for k, v in init[f"{key}_batch"].items()}
    w = torch.ones(batch["tokens"].shape[0])
    y_new, ss_new, m = step(yd, ss, z, batch, w, torch.zeros(1, dtype=torch.int32))
    return {"y": numpy_tree(shard_lib.gathered(y_new)),
            "ss": numpy_tree(shard_lib.gathered(ss_new)),
            "loss": float(m["loss"]),
            "tensor_parallel": shard_lib.tensor_parallel_ok(cfg, mesh),
            "placements": {p: repr(v.placements) for p, v in
                           basic.flatten_params(y_new)}}


# the kill -> resume cases on the mesh: (mode, rounds or updates, the
# fault model every run carries, the update or round the kill follows)
CKPT_CASES = {"sync": (6, {"crash_compute": 0.1}, 3),
              "async": (8, {"crash_compute": 0.05}, 4)}


def checkpoint_case(mesh_name, mode, out_dir):
    """A meshed grid with ``checkpoint_every=2`` killed between two
    updates of its straight run, then resumed from the snapshot the kill
    carries: the snapshot files, this rank's writes of them
    (``grid_state.save_state`` calls), and whether the resumed run is the
    straight one bit for bit."""
    from repro_torch.checkpoint import grid_state as gstate
    from repro_torch.sim import faults as faults_lib
    n, faults, lo = CKPT_CASES[mode]
    kw = dict(concurrency=6, goal_count=3) if mode == "async" else {}
    base = simgrid.GridConfig(mesh=mesh_name, mode=mode, faults=faults, **kw)
    ds = make_ds()

    def init_fn(seed):
        return {"dense": basic.init_dense(seed, "dense", 64, 4,
                                          torch.float32, bias=True,
                                          device="cpu")}

    def run(gc):
        return simgrid.run_grid(init_fn, loss_fn, ds, RC, n, grid=gc,
                                seed=3, device="cpu")
    straight = run(base)
    h = straight.history
    ckdir = os.path.join(out_dir, f"ckpt_{mode}")
    killed = dataclasses.replace(
        base, faults=dict(faults, server_kill_at=0.5 * (
            h[lo]["virtual_seconds"] + h[lo + 1]["virtual_seconds"])),
        checkpoint_every=2, checkpoint_dir=ckdir)
    writes = []
    save = gstate.save_state

    def spy(path, meta, arrays):
        writes.append(path)
        return save(path, meta, arrays)
    gstate.save_state = spy
    try:
        run(killed)
        path = None
    except faults_lib.ServerKilled as e:
        path = e.checkpoint
    finally:
        gstate.save_state = save
    dist.barrier()
    resumed = run(dataclasses.replace(base, resume_from=path))
    same = (straight.history == resumed.history
            and straight.scheduler_stats == resumed.scheduler_stats
            and straight.comm.measured_up_bytes
            == resumed.comm.measured_up_bytes
            and all(torch.equal(a, b) for a, b in
                    zip(basic.tree_leaves(straight.y),
                        basic.tree_leaves(resumed.y))))
    return {"files": sorted(os.listdir(ckdir)), "writes": len(writes),
            "path": path, "same": same}


# ---------------------------------------------------------------------------
# Tensor parallelism (tests/test_torch_tp.py): the reduced configs' train
# step and prefill on each rank's pieces


TP_ROUND = dict(clients=4, tau=2, batch=1, seq=16)
DECODE_MAX_LEN = 8           # the decode cases' cache length


class FrozenSeen:
    """Inside a ``with``, records the element counts of the frozen leaves
    (``paths``) that the decoder LM's ``train_loss`` and ``forward``
    receive: what the step's layers compute on, as against what the
    caller placed."""

    NAMES = ("train_loss", "forward")

    def __init__(self, paths):
        self.paths = set(paths)
        self.seen = {}

    def __enter__(self):
        from repro_torch.models import decoder_lm as dlm
        self.mod = dlm
        self.real = {n: getattr(dlm, n) for n in self.NAMES}
        for n, fn in self.real.items():
            setattr(dlm, n, self._spy(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.mod, n, fn)

    def _spy(self, fn):
        def spy(params, *args, **kw):
            for p, v in basic.flatten_params(params):
                if p in self.paths:
                    self.seen.setdefault(p, set()).add(v.numel())
            return fn(params, *args, **kw)
        return spy


def tp_case(case, mesh):
    """``specs.make_train_step`` (twice, from the same inputs) and
    ``specs.make_tp_prefill_step`` for one reduced config: y, the server
    state and the frozen tree placed as DTensors by the reference's rules,
    the batch's rows on the data axes."""
    from torch.distributed.tensor import DTensor
    cfg = case["cfg"]
    y, z = part.partition(basic.tree_map(torch.as_tensor, case["params"]),
                          cfg.freeze_spec)
    shard_y = shard_lib.param_shardings(y, cfg, mesh)
    shard_z = shard_lib.param_shardings(z, cfg, mesh)

    def placed(tree, pl):
        return basic.tree_map(
            lambda x, p: shard_lib.distribute(x, mesh, p), tree, pl)
    zd = placed(z, shard_z)
    step, sopt = specs.make_train_step(cfg, mesh, y, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    w = torch.ones(batch["tokens"].shape[0])
    runs = []
    paths = [p for p, _ in basic.flatten_params(z)]
    with FrozenSeen(paths) as train_seen:
        for _ in range(2):
            y_new, ss_new, m = step(placed(y, shard_y),
                                    placed(sopt.init(y), shard_y), zd, batch,
                                    w)
            runs.append((numpy_tree(shard_lib.gathered(y_new)),
                         float(m["loss"]), float(m["delta_norm"])))
    prefill = specs.make_tp_prefill_step(cfg, mesh, "cpu")
    tok = torch.as_tensor(case["prefill"])
    # the rows on every data axis, in torch.chunk's pieces (batch_sharding's
    # placements where the rows divide; else uneven, the last piece empty)
    rows = tuple(Shard(0) if n in mesh_lib.data_axes(mesh) else Replicate()
                 for n in mesh_lib.axis_names(mesh))
    tokd = shard_lib.distribute(tok, mesh, rows)
    with FrozenSeen(paths) as prefill_seen:
        logits = prefill(placed(y, shard_y), zd, {"tokens": tokd})
    decode = None
    if "decode" in case:
        decode = decode_case(cfg, mesh, part.merge(y, z), y, z,
                             torch.as_tensor(case["decode"]), rows)
    return {"runs": runs, "logits": logits.full_tensor().float().numpy(),
            "decode": decode,
            "logit_placements": repr(logits.placements),
            "y_placements": {p: repr(v.placements) for p, v in
                             basic.flatten_params(y_new)},
            "frozen_local": {p: (v.to_local().numel(), v.numel(),
                                 isinstance(v, DTensor))
                             for p, v in basic.flatten_params(zd)},
            "frozen_seen": {"train": train_seen.seen,
                            "prefill": prefill_seen.seen},
            "layout": specs.build_job(case["arch"], "train_4k", mesh,
                                      cfg_override=cfg).layout}


def warm_cache(cfg, params, tokens):
    """The decode cache after the unmeshed ``decode_step`` has taken every
    column of ``tokens`` (B, n) but the last: the state the meshed step
    starts from."""
    from repro_torch.models import decoder_lm as dlm
    cache = dlm.init_cache(cfg, tokens.shape[0], DECODE_MAX_LEN,
                           device="cpu")
    for i in range(tokens.shape[1] - 1):
        _, cache = dlm.decode_step(params, cfg, cache, tokens[:, i:i + 1])
    return cache


def decode_case(cfg, mesh, params, y, z, tokens, rows):
    """``specs.make_mesh_decode_step`` on the warm cache's rows split over
    the data axes (its sequence on "model", by ``cache_shardings``) for
    the last column of ``tokens``: the whole batch's logits, gathered."""
    cache = warm_cache(cfg, params, tokens)
    pl = shard_lib.cache_shardings(cache, cfg, mesh, False)
    cached = {"cache_len": cache["cache_len"],
              "slots": basic.tree_map(
                  lambda x, p: shard_lib.distribute(x.clone(), mesh, p),
                  cache["slots"], pl["slots"])}
    step = specs.make_mesh_decode_step(cfg, mesh, "cpu")
    last = shard_lib.distribute(tokens[:, -1:], mesh, rows)
    logits, _ = step(y, z, cached, last)
    whole = shard_lib.from_local(logits, mesh, rows,
                                 (tokens.shape[0],) + logits.shape[1:])
    return whole.full_tensor().float().numpy()


SPAWN_TIMEOUT = 420          # seconds a world may take, ranks together


def spawn(world, tmp, init, *scenarios):
    """Run this module on ``world`` ``gloo`` ranks (one process and one
    intra-op thread a rank) over ``init`` (pickled into ``tmp``) within
    SPAWN_TIMEOUT; returns each rank's results, in rank order."""
    import subprocess
    init_path = os.path.join(tmp, "init.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(init, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, tmp, init_path, *scenarios],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}:\n{log[-2000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main(rank, world, store, out_dir, init_path, scenarios="mesh"):
    torch.set_num_threads(1)
    with open(init_path, "rb") as f:
        init = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    name = {4: "debug", 8: "debug-pod"}[world]
    mesh = mesh_lib.resolve_mesh(name, "cpu")
    if scenarios == "tp":
        res = {k: tp_case(case, mesh) for k, case in init["tp"].items()}
    else:
        res = {"grid": grid_runs(init, name, debug=world == 4),
               "wide": wide_runs(init, name, mesh),
               "shardings": flat_shardings(mesh, name)}
    if world == 4 and scenarios != "tp":
        res["apply"] = apply_pairs(init, mesh)
        res["train_step"] = {k: train_step_case(init, mesh, k)
                             for k in ("stablelm", "gathered")}
        res["checkpoint"] = {mode: checkpoint_case(name, mode, out_dir)
                             for mode in CKPT_CASES}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
