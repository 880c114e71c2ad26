"""Synthetic federated datasets: the port's copy of repro/data/synthetic.py.

The repository has no EMNIST / CIFAR-10 / Stack Overflow, so it generates
*learnable* synthetic stand-ins with the exact tensor geometry of the
paper's tasks and the same federation structure:

* image tasks: each class has a Gaussian prototype image; client label
  distributions are drawn from a symmetric Dirichlet(alpha) as in
  Hsu et al. 2019 (the paper uses alpha=1 for CIFAR-10);
* language task: tokens follow per-client Markov chains mixed with a
  global chain, so next-word prediction has learnable structure and
  client heterogeneity.

Accuracy numbers on these are *trend-comparable*, not absolute-comparable,
with the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Image classification (EMNIST / CIFAR shaped)


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


# ---------------------------------------------------------------------------
# Language (Stack Overflow NWP shaped)


@dataclasses.dataclass
class FederatedTokens:
    client_tokens: List[np.ndarray]   # per client (n_i, seq) int32
    test_tokens: np.ndarray
    vocab: int


def make_federated_tokens(num_clients: int, sentences_per_client: int,
                          seq_len: int = 20, vocab: int = 10004,
                          test_sentences: int = 512, mix: float = 0.7,
                          seed: int = 0) -> FederatedTokens:
    """Markov-chain text: a shared sparse transition table plus a
    client-specific one, mixed with weight `mix` on the shared table."""
    rng = np.random.default_rng(seed)
    branch = 8  # successors per token

    def make_table(r):
        return r.integers(0, vocab, (vocab, branch)).astype(np.int32)

    shared = make_table(rng)

    def gen(table_local, n, r):
        out = np.empty((n, seq_len), np.int32)
        tok = r.integers(0, vocab, n)
        for t in range(seq_len):
            out[:, t] = tok
            use_shared = r.random(n) < mix
            nxt_s = shared[tok, r.integers(0, branch, n)]
            nxt_l = table_local[tok, r.integers(0, branch, n)]
            tok = np.where(use_shared, nxt_s, nxt_l)
        return out

    client_tokens = []
    for c in range(num_clients):
        r = np.random.default_rng(seed + 1 + c)
        local = make_table(r)
        client_tokens.append(gen(local, sentences_per_client, r))
    r = np.random.default_rng(seed + 10_000)
    test = gen(make_table(r), test_sentences, r)
    return FederatedTokens(client_tokens, test, vocab)


# ---------------------------------------------------------------------------
# Cohort batching for the round engine


def sample_cohort(rng: np.random.Generator, num_clients: int, cohort: int):
    return rng.choice(num_clients, size=cohort, replace=False)


def client_batch_images(ds: FederatedImages, cid: int, tau: int, batch: int,
                        rng: np.random.Generator):
    """Returns ({'images': (tau,b,H,W,C), 'labels': (tau,b)}, weight)."""
    xs, ys = ds.client_images[cid], ds.client_labels[cid]
    idx = rng.integers(0, len(ys), (tau, batch))
    return {"images": xs[idx], "labels": ys[idx]}, float(len(ys))


def client_batch_tokens(ds: FederatedTokens, cid: int, tau: int, batch: int,
                        rng: np.random.Generator):
    xs = ds.client_tokens[cid]
    idx = rng.integers(0, len(xs), (tau, batch))
    return {"tokens": xs[idx]}, float(len(xs))


def cohort_batch(ds, cids, tau: int, batch: int, rng, kind: str = "images"):
    """Stack per-client batches into the round engine's
    (clients, tau, batch, ...) layout plus the weight vector p_i."""
    fn = client_batch_images if kind == "images" else client_batch_tokens
    batches, weights = [], []
    for cid in cids:
        b, w = fn(ds, int(cid), tau, batch, rng)
        batches.append(b)
        weights.append(w)
    out = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    return out, np.asarray(weights, np.float32)
