"""Adaptive tiered freezing on a live fleet (the paper's §5 future work),
on the PyTorch port.

Weak devices should train less of the model than strong ones — but
*which* devices are weak is something the server can only learn from the
wire. This demo runs the ``adaptive-capability`` selection policy
(``sim/selection.py``) on the ``pareto-mobile-diurnal`` fleet: phones
with heavy-tailed link speeds, per-device stochastic link jitter + RTT
floors, and a diurnal availability cycle (``sim/dynamics.py``). The
policy starts from the static capability->tier split, then re-tiers the
fleet every few server updates from an EMA of *observed* round-trip
times — devices whose links turn out slower than their profile promised
get demoted to lighter tiers (smaller uploads, cheaper local compute),
and the per-tier clock + wire ledger show the effect. The rounds run on
the CUDA card; ``--device cpu`` runs the kernels' plain versions.

    PYTHONPATH=src python examples_torch/adaptive_tiers.py [--rounds N]

(For the static-tier grid — capability assignment frozen for the run —
see examples_torch/async_heterogeneous.py --tiers.) ``main(argv)``
returns the numbers it prints.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fedpt
from repro_torch.core.plan import TrainPlan
from repro_torch.data import synthetic as syn
from repro_torch.models import paper_models as pm
from repro_torch.sim import GridConfig, run_grid
from repro_torch.sim.devices import quantile_tiers
from repro_torch.sim.selection import AdaptiveCapabilityPolicy

TIERS = TrainPlan.of({
    "full": (),
    "mid": (r"^conv2/",),
    "lite": (r"^conv1/", r"^conv2/"),
})


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=16,
                    help="async server updates (CI smoke uses fewer)")
    ap.add_argument("--refit-every", type=int, default=4,
                    help="re-tier the fleet every N server updates")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap


def loss_fn(params, batch):
    lp = torch.log_softmax(pm.emnist_cnn_forward(params, batch["images"]), -1)
    return -lp.gather(1, batch["labels"].long()[:, None]).mean(), {}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    ds = syn.make_federated_images(num_clients=40, examples_per_client=50,
                                   shape=(28, 28, 1), num_classes=62,
                                   alpha=1.0)
    rc = fedpt.RoundConfig(clients_per_round=10, local_steps=2,
                           local_batch=16, client_opt="sgd", client_lr=0.05,
                           server_opt="sgd", server_lr=0.5, uplink_bits=8)
    policy = AdaptiveCapabilityPolicy(refit_every=args.refit_every, ema=0.4)
    gc = GridConfig(mode="async", fleet="pareto-mobile-diurnal",
                    concurrency=12, goal_count=6, staleness="polynomial",
                    plan=TIERS, selection=policy)
    res = run_grid(lambda s: pm.init_emnist_cnn(s, device=dev), loss_fn, ds,
                   rc, rounds=args.rounds, grid=gc,
                   freeze_spec=pm.EMNIST_FREEZE, seed=0, device=dev)

    static_map = np.asarray(policy._tiers)
    final_map = np.asarray(policy.current_tiers())
    moved = int(np.sum(static_map != final_map))
    names = list(TIERS.names)
    census = [dict(zip(names, map(int, np.bincount(m, minlength=3))))
              for m in (static_map, final_map)]

    print(f"== adaptive-capability on fleet '{res.fleet.name}' ==")
    print(f"  loss {res.history[0]['loss']:.3f} -> "
          f"{res.history[-1]['loss']:.3f} over {len(res.history)} updates, "
          f"{res.virtual_seconds:,.0f} virtual seconds")
    st = res.scheduler_stats
    print(f"  dispatches {st['dispatches']}, uploads {st['uploads']}, "
          f"dropouts {st['dropouts']}, dark-window retries {st['retries']}")
    print(f"  re-tiered {policy.refits}x from observed RTTs: {moved}/"
          f"{len(final_map)} clients moved tier")
    print(f"  census static  -> {census[0]}")
    print(f"  census adapted -> {census[1]}")
    print("  tier   clients  uploads  up KiB/upload  compute s  rtt mean s")
    for tname, rec in res.tier_stats.items():
        print(f"  {tname:<6s} {rec['clients']:>7d} {rec['uploads']:>8d}"
              f" {rec['up_bytes_per_upload'] / 1024.0:>14.2f}"
              f" {rec['compute_seconds']:>10.4f} {rec['rtt_mean']:>11.2f}")

    # the feedback loop must actually be live: the scheduler reported real
    # round trips back (observe() fired) and they moved the EMA off its
    # profile-seeded estimates
    assert policy.observed.any(), "no upload ever reached observe()"
    seed_est = np.asarray(policy.rtt_estimate, np.float64)
    assert not np.allclose(policy.ema_rtt[policy.observed],
                           seed_est[policy.observed]), \
        "observed EMAs never moved off the static profile estimates"
    # and the split consumed those measurements: the final map is the
    # quantile split of the EMAs as of the LAST refit
    np.testing.assert_array_equal(final_map,
                                  quantile_tiers(1.0 / policy.refit_ema, 3))
    print("OK: adaptive re-tiering follows observed round-trip times")
    return {"losses": [h["loss"] for h in res.history],
            "virtual_seconds": res.virtual_seconds,
            "scheduler_stats": dict(st), "refits": policy.refits,
            "moved": moved, "clients": len(final_map),
            "census_static": census[0], "census_adapted": census[1],
            "tier_stats": {t: dict(r) for t, r in res.tier_stats.items()}}


if __name__ == "__main__":
    main()
