"""FedPT parameter partitioning (Algorithm 1, line 1), port of
``repro/core/partition.py``: split the tree into trainable ``y`` and
frozen ``z`` by matching parameter paths against the freeze-spec regexes
(shared unchanged with the JAX package), merge them back, and split per
tier under a trainability plan (``partition_plan``, ``summarize_plan``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

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


def stop_gradient_frozen(trainable, frozen):
    """Merge with the frozen side detached (gradients are only taken with
    respect to the trainable argument anyway)."""
    return merge(trainable, basic.tree_map(torch.Tensor.detach, frozen))


def count_params(tree) -> int:
    return basic.tree_size(tree)


def trainable_fraction(params, freeze_spec) -> float:
    y, z = partition(params, freeze_spec)
    ny, nz = basic.tree_size(y), basic.tree_size(z)
    return ny / max(ny + nz, 1)


def summarize(params, freeze_spec) -> Dict[str, float]:
    """The paper's Table-1/2/3 row for a model and freeze spec: the
    one-tier case of :func:`summarize_plan`."""
    from repro_torch.core import plan as plan_lib
    row = dict(summarize_plan(params, freeze_spec,
                              plan_lib.TrainPlan.single())[0])
    row.pop("tier")
    return row


def partition_plan(params, freeze_spec, plan):
    """Per-tier (trainable, frozen) splits under a trainability plan.

    ``freeze_spec`` defines the global trainable tree; each tier's additive
    spec moves more of it to the frozen side. Returns ``(compiled_plan,
    [(train_t, frozen_t), ...])``: ``merge(train_t, frozen_t)`` is always
    the full model, and a one-tier plan with no extra spec reproduces
    :func:`partition`."""
    from repro_torch.core import plan as plan_lib
    y, z = partition(params, freeze_spec)
    cplan = plan_lib.compile_plan(plan, y)
    splits = []
    for t in cplan.tiers:
        y_t, extra = cplan.split(y, t)
        splits.append((y_t, merge(z, extra)))
    return cplan, splits


def summarize_plan(params, freeze_spec, plan) -> list:
    """Per-tier Table-1 rows: :func:`summarize`'s columns plus the tier
    name. These are the analytic per-spec numbers (tier t's row is what
    Table 1 would print had the whole fleet used tier t's combined spec,
    downlink = tier trainable + seed); the grid's measured ledger differs
    on the downlink, which every tier pays in full in a mixed fleet."""
    cplan, splits = partition_plan(params, freeze_spec, plan)
    rows = []
    for t, (y_t, z_t) in zip(cplan.tiers, splits):
        ny, nz = basic.tree_size(y_t), basic.tree_size(z_t)
        rep = comm.report_for(y_t, z_t)
        total = ny + nz
        rows.append({
            "tier": t.name,
            "total_params": total,
            "trainable_params": ny,
            "frozen_params": nz,
            "trainable_pct": 100.0 * ny / total,
            # download (y + seed) + upload (delta y), against twice the
            # full model; comm.CommReport is the one formula
            "comm_reduction": rep.reduction,
            "trainable_bytes": rep.trainable_bytes,
            "frozen_bytes": rep.full_bytes - rep.trainable_bytes,
        })
    return rows
