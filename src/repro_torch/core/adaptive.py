"""Adaptive (tiered) partial training, the paper's section 5 future work,
port of ``repro/core/adaptive.py``: "selectively freeze more parameters
for devices with smaller bandwidth and/or computational capacity".

Tiers are ordered freeze specs (tier 0 the most capable, fewest frozen
leaves; higher tiers freeze supersets). The server keeps one trainable
tree y, the union. Each client gets a per-leaf 0/1 mask for its tier;
masked leaves get zero local updates (the mask multiplies the gradients
each local step) and are left out of that client's upload. The mean is
per-leaf mask-weighted, delta[l] = sum_i w_i m_i[l] delta_i[l] /
sum_i w_i m_i[l], so leaves nobody trained keep delta 0.

This is the leaf-level prototype; the grid's path is ``core/plan.py``,
whose compiled tiers reach the flat round engine, the async lanes, the
scheduler and the per-tier wire billing (``sim/grid.GridConfig.plan``).
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import comm, fedpt
from repro_torch.nn import basic
from repro_torch.optim import optimizers as opt_lib


def tier_masks(y_tree, tier_specs: Sequence[tuple]):
    """Per-tier 0/1 leaf masks (0-d float32 tensors on each leaf's device)
    over the union trainable tree. ``tier_specs[t]`` is the *additional*
    freeze spec of tier t relative to the union (tier 0 usually ())."""
    flat = dict(basic.flatten_params(y_tree))
    return [basic.unflatten_params(
        {p: torch.tensor(0.0 if any(re.search(s, p) for s in spec) else 1.0,
                         dtype=torch.float32, device=leaf.device)
         for p, leaf in flat.items()})
        for spec in tier_specs]


def make_tiered_round_fn(loss_fn: Callable, rc: fedpt.RoundConfig,
                         tier_specs: Sequence[tuple],
                         server_opt: Optional[opt_lib.Optimizer] = None,
                         device=None):
    """round_step(y, sstate, frozen, batch, weights, tiers, rng=None) ->
    (y_new, sstate, {"delta_norm"}), on ``device`` (CUDA by default).

    tiers: (clients,) tier index per sampled client. Each client's masks
    are picked outside ``vmap`` by indexing each leaf's (n_tiers,) stack
    with the tier ids (exact: the masks are 0/1), then the clients train
    under ``torch.func.vmap``."""
    dev = resolve_device(device)
    client_opt = opt_lib.get_optimizer(rc.client_opt, rc.client_lr)
    if server_opt is None:
        server_opt = opt_lib.get_optimizer(rc.server_opt, rc.server_lr)
    client_update = fedpt.make_client_update(loss_fn, client_opt,
                                             rc.local_steps)

    def round_step(y, server_state, frozen, batch, weights, tiers, rng=None):
        # stack masks: leaf -> (n_tiers,), then each client's (clients,)
        stacked = basic.tree_map(lambda *ms: torch.stack(ms),
                                 *tier_masks(y, tier_specs))
        tids = torch.as_tensor(tiers, dtype=torch.long, device=dev)
        masks = basic.tree_map(lambda s: s[tids], stacked)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        w = torch.as_tensor(weights, dtype=torch.float32, device=dev)

        def one(cb, mask):
            return client_update(y, frozen, cb, mask)[0]

        deltas = torch.func.vmap(one)(batch, masks)
        num = basic.tree_map(
            lambda d, m: torch.tensordot(w * m, d.float(), dims=1),
            deltas, masks)
        den = basic.tree_map(
            lambda m: torch.clamp_min(torch.sum(w * m), 1e-12), masks)
        delta = basic.tree_map(lambda n, d: n / d, num, den)
        neg = basic.tree_map(torch.neg, delta)
        y_new, server_state = server_opt.update(y, neg, server_state)
        return y_new, server_state, {
            "delta_norm": opt_lib.tree_global_norm(delta)}

    return round_step, server_opt


def tier_comm_report(y_tree, frozen_tree, tier_specs) -> List[comm.CommReport]:
    """Per-tier communication ledger: tier t uploads only its unmasked
    leaves (plus the shared seed downstream)."""
    full_bytes = basic.tree_bytes(y_tree) + basic.tree_bytes(frozen_tree)
    flat_y = dict(basic.flatten_params(y_tree))
    reports = []
    for m in tier_masks(y_tree, tier_specs):
        flat_m = dict(basic.flatten_params(m))
        byt = sum(v.numel() * v.element_size() for p, v in flat_y.items()
                  if float(flat_m[p]) > 0)
        reports.append(comm.CommReport(full_bytes=full_bytes,
                                       trainable_bytes=byt))
    return reports
