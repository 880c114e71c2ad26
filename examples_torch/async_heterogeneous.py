"""Asynchronous FedPT on a heterogeneous phone fleet, on the PyTorch port.

The paper's communication reductions (Tables 1-3) matter most where
clients are slow, flaky and bandwidth-bound. This example trains the
EMNIST CNN with 95% of parameters frozen on the "pareto-mobile" fleet —
heavy-tailed link speeds, 80% availability, 10% mid-round dropout —
under FedBuff-style buffered async aggregation (goal count K, staleness
down-weighting), and compares against a synchronous cohort run with a
straggler deadline on the same fleet. Communication is *measured* at the
wire (serialized payload bytes), not estimated. The rounds run on the
CUDA card; ``--device cpu`` runs the kernels' plain versions on the host.

    PYTHONPATH=src python examples_torch/async_heterogeneous.py

With ``--tiers`` the fleet additionally gets a three-tier trainability
plan (core/plan.py): capable phones train the full trainable tree,
mid-tier phones freeze conv2, weak phones train only the norm + head.
The run is compared against the same fleet all-`full`, with per-tier
wire traffic from the CommReport ledger — the mixed fleet must bill
strictly fewer uplink bytes.

``--trace out.json`` records the async run's full event stream
(obs/trace.py) and writes a Chrome/Perfetto timeline, in the grid's
*virtual* clock; ``--trace-jsonl out.jsonl`` additionally writes the
raw schema-versioned event records (validate with ``python -m
repro_torch.obs.schema``).

``--chaos`` turns the fleet hostile (sim/faults.py "chaos" preset) and
runs it twice: once unscreened — the corrupted deltas NaN-poison the
server model — and once with the delta-quarantine screen
(core/sanitize.py) and periodic grid-state checkpoints on, which keeps
training finite. It then kills the server mid-run at a virtual time T
and resumes from the latest snapshot, asserting the resumed history
matches the uninterrupted run exactly.

``--regions`` runs the two-level aggregation topology (sim/topology.py):
a *one-region* hierarchical run is asserted bit-for-bit identical to the
flat grid, then a 4-region fleet with correlated region shocks prints
the per-hop wire ledger.

``--chaos --regions`` together run ONE hostile hierarchical fleet
(chaos faults + quarantine + 4-region topology); the per-mode
assertions are skipped, the combined run just has to stay finite.

``--report out.md`` renders the traced run as a markdown run report
(obs/report.py), and ``--metrics-out snap.json`` dumps the run's
MetricsRegistry snapshot for ``python -m repro_torch.obs.compare``.

    PYTHONPATH=src python examples_torch/async_heterogeneous.py \
        --chaos --regions --report report.md --metrics-out snap.json

``main(argv)`` returns the numbers it prints, by run name.
"""
import argparse
import dataclasses
import json
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fedpt
from repro_torch.core.plan import TrainPlan
from repro_torch.data import synthetic as syn
from repro_torch.models import paper_models as pm
from repro_torch.nn import basic
from repro_torch.obs.trace import TelemetryConfig
from repro_torch.sim import DynamicsConfig, GridConfig, RegionShocks, run_grid
from repro_torch.sim import faults as faults_lib

MB = 1024.0 * 1024.0

# tier 0 trains the whole (dense1-frozen) trainable tree; weaker tiers
# freeze progressively more of it and upload progressively less
TIERS = TrainPlan.of({
    "full": (),
    "mid": (r"^conv2/",),
    "lite": (r"^conv1/", r"^conv2/"),
})
ASYNC = dict(mode="async", fleet="pareto-mobile", concurrency=12,
             goal_count=6, staleness="polynomial")


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiers", action="store_true",
                    help="mixed-tier trainability plan vs all-full")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-injected fleet: unscreened vs quarantined, "
                         "plus a kill/checkpoint/resume demo")
    ap.add_argument("--regions", action="store_true",
                    help="hierarchical client->edge->server aggregation: "
                         "one-region vs flat bit-for-bit, then a 4-region "
                         "fleet with correlated region shocks and the "
                         "per-hop wire ledger")
    ap.add_argument("--rounds", type=int, default=12,
                    help="server updates per run (CI smoke uses fewer)")
    ap.add_argument("--trace", default=None, metavar="JSON",
                    help="write a Perfetto timeline of the async run "
                         "(open in ui.perfetto.dev)")
    ap.add_argument("--trace-jsonl", default=None, metavar="JSONL",
                    help="also write the raw schema-versioned event "
                         "stream as JSONL")
    ap.add_argument("--report", default=None, metavar="MD",
                    help="write a markdown run report of the traced run "
                         "(obs/report.py; enables memory telemetry)")
    ap.add_argument("--metrics-out", default=None, metavar="JSON",
                    help="dump the traced run's MetricsRegistry snapshot "
                         "as JSON (for repro_torch.obs.compare)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap


def loss_fn(params, batch):
    lp = torch.log_softmax(pm.emnist_cnn_forward(params, batch["images"]), -1)
    return -lp.gather(1, batch["labels"].long()[:, None]).mean(), {}


def _flat(y):
    return np.concatenate([v.detach().cpu().numpy().ravel()
                           for _, v in basic.flatten_params(y)])


def runs_for(args):
    """The grid configurations of the chosen mode, by run name (the last
    one is the traced one), and the checkpoint directory of ``--chaos``."""
    ckpt_dir = None
    if args.chaos and args.regions:
        # the combined hostile-hierarchical demo the CI telemetry job
        # traces: chaos faults + quarantine screen + 4-region edge topology
        runs = {"async chaos + regions": GridConfig(
            **ASYNC, faults="chaos", sanitize=True, topology=4)}
    elif args.chaos:
        ckpt_dir = tempfile.mkdtemp(prefix="chaos_ckpt_")
        runs = {
            "async unscreened": GridConfig(**ASYNC,
                                           faults={"corrupt_nan": 0.5}),
            "async chaos + quarantine": GridConfig(
                **ASYNC, faults="chaos", sanitize=True, checkpoint_every=2,
                checkpoint_dir=ckpt_dir),
        }
    elif args.regions:
        runs = {
            "async flat": GridConfig(**ASYNC),
            "async one-region": GridConfig(**ASYNC, topology=1),
            "async 4 regions + shocks": GridConfig(
                **ASYNC, topology=4,
                # the toy fleet's whole run spans a few virtual seconds,
                # so the outage process is scaled to match
                dynamics=DynamicsConfig(shocks=RegionShocks(
                    every=0.8, duration=1.2, residual=0.0))),
        }
    elif args.tiers:
        runs = {"async all-full": GridConfig(**ASYNC),
                "async tiered": GridConfig(**ASYNC, plan=TIERS)}
    else:
        runs = {
            "sync + deadline": GridConfig(mode="sync", fleet="pareto-mobile",
                                          over_selection=1.3,
                                          straggler_deadline=120.0),
            "async (FedBuff)": GridConfig(**ASYNC),
        }
    if args.trace or args.trace_jsonl or args.report:
        # trace the last (async) run
        traced = list(runs)[-1]
        runs[traced] = dataclasses.replace(
            runs[traced], telemetry=TelemetryConfig(
                jsonl_path=args.trace_jsonl, perfetto_path=args.trace))
    return runs, ckpt_dir


def print_run(name, res, args) -> dict:
    """The reference's lines for one run; returns their numbers."""
    st = res.scheduler_stats
    out = {"losses": [h["loss"] for h in res.history],
           "virtual_seconds": res.virtual_seconds,
           "scheduler_stats": dict(st),
           "down_bytes": res.comm.measured_down_bytes,
           "up_bytes": res.comm.measured_up_bytes,
           "transfers": res.comm.transfers,
           "reduction": res.comm.reduction,
           "uplink_reduction": res.comm.uplink_reduction}
    print(f"\n== {name} on fleet '{res.fleet.name}' ==")
    print(f"  loss {res.history[0]['loss']:.3f} -> "
          f"{res.history[-1]['loss']:.3f} over {len(res.history)} updates")
    print(f"  simulated wall-clock: {res.virtual_seconds:,.0f} s "
          f"({res.virtual_seconds / max(len(res.history), 1):.0f} s/update)")
    print(f"  dispatches {st['dispatches']}, uploads {st['uploads']}, "
          f"dropouts {st['dropouts']}, offline {st['offline']}, "
          f"deadline drops {st['deadline_drops']}")
    if res.mode == "async":
        out["staleness_max"] = max(h["staleness_max"] for h in res.history)
        print(f"  staleness max seen: {out['staleness_max']:.0f} "
              f"(down-weighted 1/sqrt(1+s))")
    print(f"  measured wire traffic: "
          f"{res.comm.measured_down_bytes / MB:.2f} MB down, "
          f"{res.comm.measured_up_bytes / MB:.2f} MB up "
          f"across {res.comm.transfers} transfers")
    print(f"  analytic ledger: {res.comm.reduction:.1f}x reduction vs "
          f"full-model FedAvg (uplink alone {res.comm.uplink_reduction:.1f}x)")
    if res.telemetry is not None:
        counts = res.telemetry.kind_counts()
        out["telemetry"] = dict(counts)
        print("  telemetry: " + " ".join(
            f"{k}={counts[k]}" for k in sorted(counts)))
        if args.trace:
            print(f"  wrote Perfetto timeline -> {args.trace} "
                  "(open in ui.perfetto.dev)")
        if args.trace_jsonl:
            print(f"  wrote event stream -> {args.trace_jsonl}")
    if res.faults is not None:
        out["faults"] = dict(res.faults)
        print("  faults: " + " ".join(
            f"{k}={v}" for k, v in res.faults.items()))
    if res.tier_stats:
        out["tier_stats"] = {t: dict(rec) for t, rec in res.tier_stats.items()}
        print("  tier      clients  dispatches  uploads      up KiB  "
              "KiB/upload")
        for tname, rec in res.tier_stats.items():
            per = rec["up_bytes_per_upload"] / 1024.0
            print(f"  {tname:<9s} {rec['clients']:>7d} {rec['transfers']:>11d}"
                  f" {rec['uploads']:>8d} {rec['up_bytes'] / 1024.0:>11.1f}"
                  f" {per:>11.2f}")
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    # the bit-for-bit checks (one region == flat, kill -> resume) hold on
    # the card under cuDNN's deterministic algorithms
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return run(args, dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def run(args, dev) -> dict:
    """The runs of ``args``' mode on ``dev``, their lines and checks."""
    ds = syn.make_federated_images(num_clients=40, examples_per_client=50,
                                   shape=(28, 28, 1), num_classes=62,
                                   alpha=1.0)
    # int8-quantized uplink on top of FedPT (the paper's §5: complementary)
    rc = fedpt.RoundConfig(clients_per_round=10, local_steps=2,
                           local_batch=16, client_opt="sgd", client_lr=0.05,
                           server_opt="sgd", server_lr=0.5, uplink_bits=8)

    def grid_run(gc):
        return run_grid(lambda s: pm.init_emnist_cnn(s, device=dev), loss_fn,
                        ds, rc, rounds=args.rounds, grid=gc,
                        freeze_spec=pm.EMNIST_FREEZE, seed=0, device=dev)

    runs, ckpt_dir = runs_for(args)
    results, summary = {}, {"runs": {}}
    for name, gc in runs.items():
        results[name] = res = grid_run(gc)
        summary["runs"][name] = print_run(name, res, args)

    if args.tiers:
        full = results["async all-full"].comm.measured_up_bytes
        mixed = results["async tiered"].comm.measured_up_bytes
        print(f"\nmixed-tier uplink: {mixed / MB:.2f} MB vs all-full "
              f"{full / MB:.2f} MB "
              f"({(1.0 - mixed / max(full, 1)) * 100.0:.0f}% less)")
        assert mixed < full, "tiered fleet must bill fewer uplink bytes"

    if args.regions and not args.chaos:
        flat, one = results["async flat"], results["async one-region"]
        # the one-region hierarchy is the flat grid, bit for bit: same
        # history, same final model, same schedule — only the billing view
        # (the hop ledger) is new
        assert [h["loss"] for h in flat.history] \
            == [h["loss"] for h in one.history], \
            "one-region history must match the flat grid exactly"
        assert [h["virtual_seconds"] for h in flat.history] \
            == [h["virtual_seconds"] for h in one.history]
        assert np.array_equal(_flat(flat.y), _flat(one.y)), \
            "one-region model must match the flat grid bitwise"
        assert flat.scheduler_stats == one.scheduler_stats
        assert flat.comm.measured_up_bytes == one.comm.measured_up_bytes
        print("\none-region hierarchy == flat grid, bit for bit "
              f"({len(one.history)} updates, "
              f"{one.comm.hop_traffic['edge_server']['uploads']} edge "
              "flushes)")

        sh = results["async 4 regions + shocks"]
        ce = sh.comm.hop_traffic["client_edge"]
        assert ce["down_bytes"] == sh.comm.measured_down_bytes
        assert ce["up_bytes"] == sh.comm.measured_up_bytes
        es = sh.comm.hop_traffic["edge_server"]
        assert es["uploads"] > 0
        print("\nper-hop wire ledger (4 regions, correlated shocks):")
        print("  hop           down MB     up MB  transfers  uploads")
        for hop, rec in sh.comm.hop_table().items():
            print(f"  {hop:<12s} {rec['down_mb']:>8.2f}  {rec['up_mb']:>8.2f}"
                  f"  {rec['transfers']:>9d}  {rec['uploads']:>7d}")
        reg_up = sh.metrics.counter("region_uploads").labels
        print("  uploads by region: " + " ".join(
            f"edge{k}={v}" for k, v in sorted(reg_up.items())))
        print(f"  edge->server carries {es['uploads']} pre-reduced buffers "
              f"vs {ce['uploads'] or sh.scheduler_stats['uploads']} client "
              "deltas on the first hop")
        summary["hop_table"] = sh.comm.hop_table()
        summary["region_uploads"] = dict(reg_up)

    if args.chaos and not args.regions:
        poisoned = results["async unscreened"]
        screened = results["async chaos + quarantine"]
        assert not np.all(np.isfinite(_flat(poisoned.y))), \
            "unscreened corrupt uploads should NaN-poison the model"
        assert np.all(np.isfinite(_flat(screened.y))), \
            "the quarantine screen must keep the model finite"
        assert screened.faults["quarantined"] > 0
        print(f"\nunscreened model is NaN-poisoned; quarantine zeroed "
              f"{screened.faults['quarantined']} corrupt rows and kept "
              f"training finite (final loss "
              f"{screened.history[-1]['loss']:.3f})")

        # kill the server mid-run, restore the latest snapshot, continue:
        # the resumed run must reproduce the uninterrupted one exactly
        h = screened.history
        t_kill = 0.5 * (h[-2]["virtual_seconds"] + h[-1]["virtual_seconds"])
        killed_gc = dataclasses.replace(
            runs["async chaos + quarantine"],
            faults=dataclasses.replace(faults_lib.resolve_faults("chaos"),
                                       server_kill_at=t_kill),
            telemetry=None)
        try:
            grid_run(killed_gc)
            raise AssertionError("server_kill_at should have fired")
        except faults_lib.ServerKilled as e:
            print(f"server killed at t={e.at:,.0f}s after {e.applied} "
                  f"updates; resuming from {e.checkpoint}")
            summary["killed_after"] = e.applied
            resumed = grid_run(dataclasses.replace(
                runs["async chaos + quarantine"], telemetry=None,
                resume_from=e.checkpoint))
        assert [r["loss"] for r in resumed.history] == \
            [r["loss"] for r in screened.history], \
            "resumed history must match the uninterrupted run"
        assert np.array_equal(_flat(resumed.y), _flat(screened.y)), \
            "resumed model must match the uninterrupted run bitwise"
        print(f"resume OK: {len(resumed.history)} updates, history and "
              "final model match the uninterrupted run exactly")
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    if args.chaos and args.regions:
        combined = results["async chaos + regions"]
        assert np.all(np.isfinite(_flat(combined.y))), \
            "quarantine must keep the hostile hierarchical run finite"
        es = combined.comm.hop_traffic["edge_server"]
        print(f"\nchaos+regions: quarantined "
              f"{combined.faults['quarantined']} corrupt rows, "
              f"{es['uploads']} edge->server buffers, final loss "
              f"{combined.history[-1]['loss']:.3f}")

    if args.report or args.metrics_out:
        traced_res = results[list(runs)[-1]]
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(traced_res.metrics.snapshot(), f, indent=1)
            print(f"\nwrote metrics snapshot -> {args.metrics_out}")
        if args.report:
            from repro_torch.obs import report as report_lib

            text = report_lib.build_report(
                traced_res.telemetry, metrics=traced_res.metrics.snapshot())
            with open(args.report, "w") as f:
                f.write(text)
            print(f"wrote run report -> {args.report} "
                  f"({len(text.splitlines())} lines)")
    return summary


if __name__ == "__main__":
    main()
