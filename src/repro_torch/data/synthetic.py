"""Synthetic federated image data (numpy only): the port's own copy of the
image part of ``repro/data/synthetic.py``, which it may not import. The
same seed gives the same arrays as the reference (test-enforced).

Each class has a Gaussian prototype image; client label distributions
are drawn from a symmetric Dirichlet(alpha) as in Hsu et al. 2019.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class FederatedImages:
    client_images: List[np.ndarray]   # per client (n_i, H, W, C) float32
    client_labels: List[np.ndarray]   # per client (n_i,) int32
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int

    @property
    def num_clients(self) -> int:
        return len(self.client_images)


def make_federated_images(num_clients: int, examples_per_client: int,
                          shape: Tuple[int, int, int], num_classes: int,
                          alpha: float = 1.0, noise: float = 0.35,
                          test_examples: int = 1000, seed: int = 0):
    """Class prototypes + Gaussian noise; Dirichlet(alpha) label skew."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (num_classes, *shape)).astype(np.float32)

    def sample(labels):
        x = protos[labels] + rng.normal(0, noise, (len(labels), *shape))
        return x.astype(np.float32)

    client_images, client_labels = [], []
    for _c in range(num_clients):
        p = rng.dirichlet(np.full(num_classes, alpha))
        labels = rng.choice(num_classes, size=examples_per_client, p=p)
        client_images.append(sample(labels))
        client_labels.append(labels.astype(np.int32))
    test_labels = rng.integers(0, num_classes, test_examples).astype(np.int32)
    return FederatedImages(client_images, client_labels,
                           sample(test_labels), test_labels, num_classes)


def sample_cohort(rng: np.random.Generator, num_clients: int, cohort: int):
    return rng.choice(num_clients, size=cohort, replace=False)


def client_batch_images(ds: FederatedImages, cid: int, tau: int, batch: int,
                        rng: np.random.Generator):
    """Returns ({'images': (tau,b,H,W,C), 'labels': (tau,b)}, weight)."""
    xs, ys = ds.client_images[cid], ds.client_labels[cid]
    idx = rng.integers(0, len(ys), (tau, batch))
    return {"images": xs[idx], "labels": ys[idx]}, float(len(ys))


def check_kind(kind: str) -> None:
    """Only image data is ported; the token data of the SO NWP task waits
    for its model."""
    if kind != "images":
        raise NotImplementedError(f"data kind {kind!r}: only 'images' is "
                                  "ported (tokens wait for the SO NWP "
                                  "model)")


def cohort_batch(ds: FederatedImages, cids, tau: int, batch: int, rng,
                 kind: str = "images"):
    """Stack per-client batches into the round engine's
    (clients, tau, batch, ...) layout plus the weight vector p_i."""
    check_kind(kind)
    batches, weights = [], []
    for cid in cids:
        b, w = client_batch_images(ds, int(cid), tau, batch, rng)
        batches.append(b)
        weights.append(w)
    out = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    return out, np.asarray(weights, np.float32)
