"""FedPT round engine — Algorithm 1 of the paper, port of the synchronous
round of ``repro/core/fedpt.py`` (untiered, no sharding hooks).

One federated round:
  1. every sampled client starts from the server's trainable tree ``y``
     and the frozen tree regenerated from the seed;
  2. each runs tau local ClientOpt steps with gradients into ``y`` only
     (``torch.func.grad`` of a function of ``y``, the frozen side
     detached);
  3. the client deltas form the (clients, size) flat buffer, aggregated
     by the server tail (``kernels/ops.agg_tail``: optional quarantine
     screen, int-k uplink fake-quantize, clip, weighted or fixed-
     denominator mean, DP Gaussian noise; staged or fused by size);
  4. ServerOpt treats -delta as a pseudo-gradient.

The client axis is ``torch.func.vmap``, as in the reference, so each op
of the local step is dispatched once for the whole cohort; the tau-step
``scan`` is a Python loop over steps. The engine takes any
``loss_fn(params, batch)`` that ``vmap`` can batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import flat as flat_lib
from repro_torch.core import partition as part
from repro_torch.core import sanitize as sanitize_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.nn.basic import tree_leaves, tree_map
from repro_torch.optim import optimizers as opt_lib


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    clients_per_round: int
    local_steps: int            # tau
    local_batch: int
    client_opt: str = "sgd"
    client_lr: float = 0.05
    server_opt: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    # DP (DP-FedAvg clip/noise)
    dp_clip_norm: float = 0.0   # 0 = off
    dp_noise_multiplier: float = 0.0
    uniform_weights: bool = False  # DP requires fixed (uniform) weighting
    # lossy uplink compression of client deltas (0 = off)
    uplink_bits: int = 0


def make_client_update(loss_fn: Callable, client_opt: opt_lib.Optimizer,
                       local_steps: int):
    """Returns f(y, frozen, client_batch) -> (delta, metrics).

    client_batch: dict of tensors with leading axis tau (one microbatch
    per local step). Gradients are taken with respect to y only."""

    def client_update(y0, frozen, client_batch):
        frozen = tree_map(torch.Tensor.detach, frozen)

        def loss_of_y(yy, mb):
            out = loss_fn(part.merge(yy, frozen), mb)
            return (out[0], out[1]) if isinstance(out, tuple) else (out, {})

        grad_fn = torch.func.grad_and_value(loss_of_y, has_aux=True)
        y, st = y0, client_opt.init(y0)
        losses = []
        for t in range(local_steps):
            grads, (loss, _aux) = grad_fn(
                y, {k: v[t] for k, v in client_batch.items()})
            y, st = client_opt.update(y, grads, st)
            losses.append(loss)
        delta = opt_lib.tree_sub(y, y0)
        return delta, {"client_loss": torch.stack(losses).mean()}

    return client_update


def resolve_server_opt(rc: RoundConfig) -> opt_lib.Optimizer:
    """The ServerOpt a RoundConfig names."""
    if rc.server_opt == "sgdm":
        return opt_lib.sgdm(rc.server_lr, rc.server_momentum)
    return opt_lib.get_optimizer(rc.server_opt, rc.server_lr)


def make_round_fn(loss_fn: Callable, rc: RoundConfig,
                  server_opt: Optional[opt_lib.Optimizer] = None,
                  device=None,
                  sanitize: Optional[sanitize_lib.SanitizeConfig] = None,
                  fused_threshold: Optional[int] = None):
    """Builds round_step(y, server_state, frozen, batch, weights, rng=None)
    -> (y_new, server_state, metrics), running on ``device`` (CUDA by
    default; raises when there is none and the CPU was not asked for).

    batch: dict of arrays, leaves (clients, tau, local_batch, ...);
    weights: (clients,) — e.g. #examples per client (the paper's p_i).
    Both may be numpy arrays; they are moved to ``device``. ``y`` and
    ``frozen`` must already lie there. ``rng``: the round's threefry key
    (``nn/threefry.key``, the counterpart of ``jax.random.key``), needed
    when DP noise is on. Under DP the mean divides by the fixed
    ``clients_per_round`` and the noise std is ``dp_noise_multiplier *
    dp_clip_norm / clients_per_round``.

    ``sanitize`` (a ``core/sanitize.SanitizeConfig``) screens the delta
    buffer first; quarantined rows get zero weight and the masks land in
    the metrics. ``fused_threshold`` overrides the tail's size threshold
    for the fused route (0 forces it).

    metrics: ``loss`` (mean client loss), ``delta_norm`` (norm of the
    aggregated update: of the flat vector through the sumsq kernel on
    CUDA, or of the unflattened tree when noised, since pad slots carry
    noise), ``update_norm`` when clipping, and ``quarantine_nonfinite``
    / ``quarantine_outlier`` / ``quarantine_norms`` (per row) with the
    screen on."""
    dev = resolve_device(device)
    noised = rc.dp_clip_norm > 0 and rc.dp_noise_multiplier > 0
    sigma = (rc.dp_noise_multiplier * rc.dp_clip_norm
             / rc.clients_per_round) if noised else 0.0
    client_opt = opt_lib.get_optimizer(rc.client_opt, rc.client_lr)
    if server_opt is None:
        server_opt = resolve_server_opt(rc)
    client_update = make_client_update(loss_fn, client_opt, rc.local_steps)

    def round_step(y, server_state, frozen, batch, weights, rng=None):
        if noised and rng is None:
            raise ValueError("DP noise is on: round_step needs the round's "
                             "threefry key rng")
        for leaf in tree_leaves(y) + tree_leaves(frozen):
            if leaf.device != dev:
                raise ValueError(f"parameters on {leaf.device}, the round "
                                 f"runs on {dev}")
        layout = flat_lib.FlatLayout.of(y)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)

        # --- local training on every sampled client, vmapped over the
        # client axis; deltas are born flat, one (clients, size) buffer --
        def flat_client(cb):
            delta, metrics = client_update(y, frozen, cb)
            return layout.flatten(delta), metrics["client_loss"]

        deltas, losses = torch.func.vmap(flat_client)(batch)

        # --- server tail: screen / quantize / clip / mean / noise --------
        flat_delta, ainfo = kernel_ops.agg_tail(
            deltas, weights,
            block_leaf=layout.block_leaf(),
            n_leaves=len(layout.sizes),
            align=layout.align,
            bits=rc.uplink_bits or 0,
            clip_norm=rc.dp_clip_norm if rc.dp_clip_norm > 0 else 0.0,
            uniform=bool(rc.uniform_weights or rc.dp_clip_norm > 0),
            wsum_fixed=(float(rc.clients_per_round)
                        if rc.dp_clip_norm > 0 else None),
            sigma=sigma, rng=rng if noised else None,
            screen=sanitize, threshold=fused_threshold)

        # --- ServerOpt on the pseudo-gradient ---------------------------
        delta = layout.unflatten(flat_delta, dtype=torch.float32)
        neg = tree_map(torch.neg, delta)
        y_new, server_state = server_opt.update(y, neg, server_state)
        out_metrics = {"loss": losses.mean(),
                       "delta_norm": opt_lib.tree_global_norm(delta)
                       if noised else torch.sqrt(
                           flat_lib.sumsq(flat_delta, layout.align))}
        if "update_norms" in ainfo:
            out_metrics["update_norm"] = ainfo["update_norms"].mean()
        if sanitize is not None:
            out_metrics["quarantine_nonfinite"] = ainfo["nonfinite"]
            out_metrics["quarantine_outlier"] = ainfo["outlier"]
            out_metrics["quarantine_norms"] = ainfo["norms"]
        return y_new, server_state, out_metrics

    return round_step, server_opt
