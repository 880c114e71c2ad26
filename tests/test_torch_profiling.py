"""The port's profiler hooks (``repro_torch.obs.profiling``) and the
grid's ``TelemetryConfig(profile=True)`` on the CPU.

With profiling off the hooks return the callables they were given; on,
a run inside ``torch.profiler.profile`` shows one ``grid/round_fn`` range
a sync round, one ``grid/lane_step[<tier>]`` range a lane step and one
``grid/server_apply`` range a flush, counted against the virtual-time
trace's round and flush spans. Also here: the host copies of
``obs/analyze`` / ``report`` / ``compare`` read a port run's trace.
"""
import json

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import fedpt
from repro_torch.data import synthetic as syn
from repro_torch.nn import basic
from repro_torch.obs import analyze, compare, profiling, report
from repro_torch.sim import grid as simgrid


def init_fn(seed):
    return {"dense": basic.init_dense(seed, "dense", 64, 4, torch.float32,
                                      bias=True, device="cpu")}


def loss_fn(params, b):
    x = b["images"].reshape(b["images"].shape[0], -1)
    lp = torch.log_softmax(basic.dense(x, params["dense"]), -1)
    return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}


RC = fedpt.RoundConfig(clients_per_round=4, local_steps=2, local_batch=8,
                       client_opt="sgd", client_lr=0.1, server_opt="sgd",
                       server_lr=1.0)


def _ds():
    return syn.make_federated_images(12, 30, (8, 8, 1), 4, seed=0,
                                     test_examples=64)


def _ranges(prof, name):
    """Host ranges of ``name`` (on a card the profiler also mirrors each
    range as device-side annotations, which are not counted)."""
    return sum(e.name == name and e.device_type == DeviceType.CPU
               for e in prof.events())


def test_disabled_hooks_return_what_they_were_given():
    def fn(x):
        return x + 1
    fns = {0: fn, None: fn}
    assert profiling.annotate(fn, "grid/x", enabled=False) is fn
    assert profiling.annotate_map(fns, "grid/x", enabled=False) is fns
    wrapped = profiling.annotate(fn, "grid/x")
    assert wrapped is not fn and wrapped(1) == 2 and wrapped.__name__ == "fn"
    with profiling.capture(None) as prof:
        assert prof is None


def test_annotation_records_a_named_range_per_call():
    wrapped = profiling.annotate_map({0: torch.neg, 1: torch.abs}, "grid/t")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            wrapped[0](torch.ones(4))
        wrapped[1](torch.ones(4))
    assert _ranges(prof, "grid/t[0]") == 3
    assert _ranges(prof, "grid/t[1]") == 1


def test_capture_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    fn = profiling.annotate(lambda x: x * 2, "grid/capture")
    with profiling.capture(path):
        fn(torch.ones(8))
    with open(path) as f:
        trace = json.load(f)
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "grid/capture" in names


def _count_lane_steps(monkeypatch):
    """Count the calls of every lane step the grid builds."""
    calls = {}
    make = fedpt.make_lane_step

    def counting(*args, **kw):
        step = make(*args, **kw)
        key = None if kw.get("tier") is None else kw["tier"].index

        def run(*a):
            calls[key] = calls.get(key, 0) + 1
            return step(*a)
        return run
    monkeypatch.setattr(fedpt, "make_lane_step", counting)
    return calls


@pytest.mark.parametrize("plan", [None, {"full": (), "lite": (r"/kernel$",)}])
def test_async_run_ranges_match_its_flushes(plan, monkeypatch):
    calls = _count_lane_steps(monkeypatch)
    gc = simgrid.GridConfig(mode="async", fleet="pareto-mobile",
                            concurrency=6, goal_count=3, plan=plan,
                            telemetry={"profile": True})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = simgrid.run_grid(init_fn, loss_fn, _ds(), RC, 5, grid=gc,
                               seed=1, device="cpu")
    flushes = [e for e in res.telemetry.events if e.kind == "flush"]
    assert len(flushes) == len(res.history) == 5
    assert _ranges(prof, "grid/server_apply") == len(flushes)
    keys = [None] if plan is None else [0, 1]
    assert sum(calls.values()) >= len(flushes)
    for k in keys:
        assert _ranges(prof, f"grid/lane_step[{k}]") == calls.get(k, 0)
    # the same run unprofiled: the same history, and no range recorded
    with profile(activities=[ProfilerActivity.CPU]) as quiet:
        plain = simgrid.run_grid(
            init_fn, loss_fn, _ds(), RC, 5, seed=1, device="cpu",
            grid=simgrid.GridConfig(mode="async", fleet="pareto-mobile",
                                    concurrency=6, goal_count=3, plan=plan,
                                    telemetry=True))
    assert plain.history == res.history
    assert _ranges(quiet, "grid/server_apply") == 0


def test_sync_run_has_a_range_per_round():
    gc = simgrid.GridConfig(mode="sync", telemetry={"profile": True})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = simgrid.run_grid(init_fn, loss_fn, _ds(), RC, 4, grid=gc,
                               seed=1, device="cpu")
    rounds = [e for e in res.telemetry.events if e.kind == "round"]
    assert len(rounds) == 4
    assert _ranges(prof, "grid/round_fn") == len(rounds)


def test_sequential_engine_has_a_range_per_client_step():
    gc = simgrid.GridConfig(mode="async", concurrency=4, goal_count=2,
                            lanes=0, telemetry={"profile": True})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = simgrid.run_grid(init_fn, loss_fn, _ds(), RC, 3, grid=gc,
                               seed=1, device="cpu")
    assert _ranges(prof, "grid/client_step[None]") == \
        res.scheduler_stats["dispatches"]
    assert _ranges(prof, "grid/server_apply") == 3


def _traced(pkg, tmp_path):
    """A chaos + DP + 2-region async run in ``pkg``, its trace as JSONL
    and its metrics snapshot as JSON."""
    kw = dict(mode="async", fleet="pareto-mobile", concurrency=5,
              goal_count=3, telemetry="memory", faults="chaos",
              sanitize=True, topology=2)
    rc_kw = dict(clients_per_round=4, local_steps=2, local_batch=8,
                 client_opt="sgd", client_lr=0.1, server_opt="sgd",
                 server_lr=1.0, dp_clip_norm=1.0, dp_noise_multiplier=0.8)
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        from repro.core import fedpt as jfedpt
        from repro.nn import basic as jbasic
        from repro.obs import export as jexport
        from repro.sim import grid as jgrid

        def jinit(seed):
            return {"dense": jbasic.init_dense(seed, "dense", 64, 4,
                                               jnp.float32, bias=True)}

        def jloss(params, b):
            x = b["images"].reshape(b["images"].shape[0], -1)
            lp = jax.nn.log_softmax(jbasic.dense(x, params["dense"]))
            return -jnp.mean(jnp.take_along_axis(
                lp, b["labels"][:, None], 1)), {}
        res = jgrid.run_grid(jinit, jloss, _ds(), jfedpt.RoundConfig(**rc_kw),
                             4, grid=jgrid.GridConfig(**kw), seed=7)
        write = jexport.write_jsonl
    else:
        from repro_torch.obs import export
        res = simgrid.run_grid(init_fn, loss_fn, _ds(),
                               fedpt.RoundConfig(**rc_kw), 4,
                               grid=simgrid.GridConfig(**kw), seed=7,
                               device="cpu")
        write = export.write_jsonl
    jsonl = str(tmp_path / f"{pkg}.jsonl")
    write(res.telemetry.events, jsonl)
    snap = str(tmp_path / f"{pkg}.json")
    with open(snap, "w") as f:
        json.dump(res.metrics.snapshot(), f)
    return res, jsonl, snap


def test_analysis_layer_reads_a_port_trace(tmp_path):
    """``analyze``, ``report`` and ``compare`` (host copies) on a port
    run's trace and metrics: each flush's phases sum to its span, the
    report renders and cross-checks the metrics, a run compared with
    itself passes the strictest gate; and the analysis of the port's
    trace equals that of the JAX package's trace of the same run, since
    both are the same virtual-time events."""
    res, jsonl, snap = _traced("torch", tmp_path)
    an = analyze.analyze(jsonl)
    assert an.mode == "async" and len(an.breakdowns) == 4
    assert all(b.check_identity() for b in an.breakdowns)
    out = str(tmp_path / "report.md")
    assert report.main([jsonl, "--metrics", snap, "-o", out]) == 0
    text = open(out).read()
    assert "## Critical path" in text and "VIOLATED" not in text
    assert f"{res.dp['epsilon']:.4g}" in text
    assert "## Metrics cross-check" in text and "MISMATCH" not in text
    assert compare.main([snap, snap, "--fail-on", "*"]) == 0
    flat = compare.flatten(jsonl)
    assert flat["kind.flush"] == len(res.history)
    _, jjsonl, jsnap = _traced("jax", tmp_path)
    assert analyze.analyze(jjsonl).to_json() == an.to_json()
    rows, bad = compare.diff(compare.flatten(jsnap), compare.flatten(snap),
                             [("counter.*", 0.0)])
    assert not bad, bad
