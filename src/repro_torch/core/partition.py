"""FedPT parameter partitioning (Algorithm 1, line 1), port of
``repro/core/partition.py``: split the tree into trainable ``y`` and
frozen ``z`` by matching parameter paths against the freeze-spec regexes
(shared unchanged with the JAX package), and merge them back.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

from repro_torch.core import comm
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


def summarize(params, freeze_spec) -> Dict[str, float]:
    """The paper's Table-1/2/3 row for a model and freeze spec: parameter
    counts, the trainable percentage, the communication reduction
    (download y + seed, upload delta y, against twice the full model;
    ``comm.CommReport`` is the one formula) and the byte split. The
    reference reaches it as the one-tier case of ``summarize_plan``;
    trainability plans are not ported, so it is computed here directly."""
    y, z = partition(params, freeze_spec)
    ny, nz = basic.tree_size(y), basic.tree_size(z)
    rep = comm.report_for(y, z)
    total = ny + nz
    return {
        "total_params": total,
        "trainable_params": ny,
        "frozen_params": nz,
        "trainable_pct": 100.0 * ny / total,
        "comm_reduction": rep.reduction,
        "trainable_bytes": rep.trainable_bytes,
        "frozen_bytes": rep.full_bytes - rep.trainable_bytes,
    }
