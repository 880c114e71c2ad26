"""FedPT parameter partitioning (Algorithm 1, line 1), port of
``repro/core/partition.py``: split the tree into trainable ``y`` and
frozen ``z`` by matching parameter paths against the freeze-spec regexes
(shared unchanged with the JAX package), and merge them back.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

from repro_torch.nn import basic


def partition(params: Dict[str, Any], freeze_spec) -> Tuple[Dict, Dict]:
    """Returns (trainable, frozen) trees with disjoint leaves."""
    train, frozen = {}, {}
    for path, leaf in basic.flatten_params(params):
        if any(re.search(p, path) for p in freeze_spec):
            frozen[path] = leaf
        else:
            train[path] = leaf
    return basic.unflatten_params(train), basic.unflatten_params(frozen)


def merge(trainable: Dict[str, Any], frozen: Dict[str, Any]) -> Dict[str, Any]:
    """Reassemble the full parameter tree from the two disjoint halves."""
    flat = dict(basic.flatten_params(trainable))
    flat.update(dict(basic.flatten_params(frozen)))
    return basic.unflatten_params(flat)


def count_params(tree) -> int:
    return basic.tree_size(tree)


def trainable_fraction(params, freeze_spec) -> float:
    y, z = partition(params, freeze_spec)
    ny, nz = basic.tree_size(y), basic.tree_size(z)
    return ny / max(ny + nz, 1)
