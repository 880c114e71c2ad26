"""Hyperparameter grid search — the paper's §C.1 protocol (grid over
client/server learning rates, best final accuracy reported), used by the
DP-FTRL experiments.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Sequence


def grid(**axes: Sequence) -> List[Dict]:
    """grid(client_lr=[...], server_lr=[...]) -> list of dicts."""
    keys = sorted(axes)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(axes[k] for k in keys))]


PAPER_DP_GRID = grid(
    client_lr=[10 ** -1.5, 10 ** -1.0, 10 ** -0.5],
    server_lr=[10 ** -1.5, 10 ** -1.0, 10 ** -0.5, 10 ** 0.0, 10 ** 0.25],
)


def search(run_fn: Callable[[Dict], float], candidates: Iterable[Dict],
           maximize: bool = True, log: bool = False):
    """run_fn(point) -> score. Returns (best_point, best_score, history)."""
    best, best_score, hist = None, None, []
    for point in candidates:
        score = run_fn(point)
        hist.append({**point, "score": score})
        if log:
            print(f"  {point} -> {score:.4f}")
        if best_score is None or (score > best_score) == maximize:
            best, best_score = point, score
    return best, best_score, hist
