"""Quickstart: FedPT in ~40 lines, on the PyTorch port.

Trains the paper's EMNIST CNN federated with 95% of parameters frozen
(regenerated from a seed on every client), and shows the communication
ledger: the paper's Table 1 row. Runs on the CUDA card; ``--device cpu``
runs the kernels' plain versions on the host.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

import repro_torch.core.partition as part
from repro_torch import resolve_device
from repro_torch.core import comm, fedpt
from repro_torch.data import synthetic as syn
from repro_torch.models import paper_models as pm
from repro_torch.nn import threefry


def loss_fn(params, batch):
    """The task loss: mean cross-entropy of the CNN's logits."""
    lp = torch.log_softmax(pm.emnist_cnn_forward(params, batch["images"]), -1)
    return -lp.gather(1, batch["labels"].long()[:, None]).mean(), {}


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a federated dataset: 40 clients, Dirichlet(1) label skew
    ds = syn.make_federated_images(num_clients=40, examples_per_client=50,
                                   shape=(28, 28, 1), num_classes=62,
                                   alpha=1.0)

    # 2. split the model: trainable y + frozen-from-seed z (Algorithm 1, l.1)
    seed = 0
    y, frozen = part.partition(pm.init_emnist_cnn(seed, device=dev),
                               pm.EMNIST_FREEZE)
    ledger = comm.report_for(y, frozen)
    trainable = 100 * part.count_params(y) / 1_690_174
    print(f"trainable: {trainable:.2f}% of params")
    print(f"per-round communication reduction: {ledger.reduction:.1f}x "
          f"(paper: 20x)")

    # 3. a FedPT round: 10 clients x 2 local SGD steps, server SGD on the
    #    aggregated pseudo-gradient (generalized FedAvg)
    rc = fedpt.RoundConfig(clients_per_round=10, local_steps=2,
                           local_batch=16, client_opt="sgd", client_lr=0.05,
                           server_opt="sgd", server_lr=0.5)
    round_fn, server_opt = fedpt.make_round_fn(loss_fn, rc, device=dev)
    sstate = server_opt.init(y)

    rng = np.random.default_rng(0)
    losses = []
    for r in range(10):
        cids = syn.sample_cohort(rng, ds.num_clients, rc.clients_per_round)
        batch, w = syn.cohort_batch(ds, cids, rc.local_steps, rc.local_batch,
                                    rng)
        y, sstate, m = round_fn(y, sstate, frozen, batch, w,
                                threefry.key(r))
        losses.append(float(m["loss"]))
        print(f"round {r}: client loss {losses[-1]:.3f}")

    # 4. evaluate the merged model
    full = part.merge(y, frozen)
    with torch.no_grad():
        logits = pm.emnist_cnn_forward(
            full, torch.as_tensor(ds.test_images, device=dev))
    acc = float((logits.argmax(-1).cpu().numpy() == ds.test_labels).mean())
    print(f"test accuracy after 10 rounds: {acc:.3f} (chance {1/62:.3f})")
    return {"trainable_pct": trainable, "reduction": ledger.reduction,
            "losses": losses, "accuracy": acc}


if __name__ == "__main__":
    main()
