"""FedPT round engine — Algorithm 1 of the paper, port of
``repro/core/fedpt.py``.

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
``loss_fn(params, batch)`` that ``vmap`` can batch. A cohort whose
clients' copies of ``y`` pass ``VMAP_BYTES`` is vmapped a chunk of
clients at a time, each chunk's rows written into the one delta buffer
(DeepSeek-V2's 1.25 G trainable values: a client at a time).

The async grid's hooks follow: staleness weightings, the single-client
and lane-batched client steps, and the buffered server apply.

Each engine takes a trainability plan (``core/plan.CompiledPlan``): the
sync round masks each client's gradients with its tier's leaf mask and
divides each block by its tier-mask-weighted weight sum; a tiered client
or lane step trains the tier's own subtree at its ``tier_size`` width;
the tiered apply re-masks each row to its tier. A trivial (one-tier)
plan takes the untiered code.

On a mesh each engine takes the reference's sharding hooks, made by
``launch/sharding.py``. Every rank runs the same host code from the same
inputs (SPMD). ``constrain_flat_fn`` is the mesh's flat plane: a rank
trains the clients (or lane slots) of its rows along the data axes, the
tail runs on its block of the delta buffer
(``kernels/ops.agg_tail``), and the update's columns are gathered whole;
a lane's rows are gathered whole, since the async grid buffers them on
the host. ``constrain_fn(y, clients)`` gives the tree the clients train
from (``clients=True``) and lays the new ``y`` out as the server holds
it (``clients=False``), e.g. DTensors gathered and re-sharded. With no
hook the engines are the unmeshed ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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


# The bytes of float32 ``y`` copies that one vmap over clients may hold:
# every client holds its own y and gradient, and the optimizer step a
# third, so a larger cohort runs in chunks of clients.
VMAP_BYTES = 8 << 30


def _vmap_clients(fn, n: int, row_size: int, dev, *args):
    """``torch.func.vmap(fn)(*args)`` for fn -> (float32 row (row_size,),
    loss), the client axis leading every leaf of ``args``; when n rows
    pass VMAP_BYTES, ``VMAP_BYTES // (4 * row_size)`` clients (at least
    one) at a time, their rows written into one (n, row_size) buffer on
    ``dev``, allocated before the first chunk runs."""
    chunk = max(1, VMAP_BYTES // (4 * row_size))
    if chunk >= n:
        return torch.func.vmap(fn)(*args)
    rows = torch.empty((n, row_size), dtype=torch.float32, device=dev)
    losses = []
    for a in range(0, n, chunk):
        part_rows, part_losses = torch.func.vmap(fn)(
            *(tree_map(lambda x: x[a:a + chunk], t) for t in args))
        rows[a:a + part_rows.shape[0]] = part_rows
        losses.append(part_losses)
        del part_rows
    return rows, torch.cat(losses)


def _vmap_rows(fn, n: int, row_size: int, dev, *args):
    """:func:`_vmap_clients`, or empty rows and losses for a rank with no
    rows of its own (a cohort or lane narrower than the data axes)."""
    if n == 0:
        return (torch.zeros((0, row_size), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev))
    return _vmap_clients(fn, n, row_size, dev, *args)


def make_client_update(loss_fn: Callable, client_opt: opt_lib.Optimizer,
                       local_steps: int):
    """Returns f(y, frozen, client_batch[, grad_mask]) -> (delta, metrics).

    client_batch: dict of tensors with leading axis tau (one microbatch
    per local step). Gradients are taken with respect to y only.
    ``grad_mask`` (optional 0/1 tree over y) zeroes the gradient of the
    leaves a client's tier freezes at each local step (exact freezing
    under SGD-family ClientOpts), and the final delta is masked again, so
    a tiered client's upload is zero outside its tier."""

    def client_update(y0, frozen, client_batch, grad_mask=None):
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
            if grad_mask is not None:
                grads = tree_map(lambda g, m: g * m.to(g.dtype), grads,
                                 grad_mask)
            y, st = client_opt.update(y, grads, st)
            losses.append(loss)
        delta = opt_lib.tree_sub(y, y0)
        if grad_mask is not None:
            delta = tree_map(lambda d, m: d * m.to(d.dtype), delta,
                             grad_mask)
        return delta, {"client_loss": torch.stack(losses).mean()}

    return client_update


def clip_delta(delta, clip_norm: float):
    """Per-client L2 clipping: delta * min(1, C/||delta||), over the flat
    buffer (the clip kernel on CUDA, its plain version on the CPU).
    Accepts and returns a tree, or a flat float32 vector, in which case
    no unflatten round-trip is paid; returns (clipped, pre-clip norm)."""
    if isinstance(delta, torch.Tensor) and delta.ndim == 1:
        return flat_lib.clip(delta, clip_norm)
    layout = flat_lib.FlatLayout.of(delta)
    clipped, nrm = flat_lib.clip(layout.flatten(delta), clip_norm, layout)
    # leaves keep their dtype, as on the tree path
    return layout.unflatten(clipped), nrm


def resolve_server_opt(rc: RoundConfig) -> opt_lib.Optimizer:
    """The ServerOpt a RoundConfig names."""
    if rc.server_opt == "sgdm":
        return opt_lib.sgdm(rc.server_lr, rc.server_momentum)
    return opt_lib.get_optimizer(rc.server_opt, rc.server_lr)


def make_round_fn(loss_fn: Callable, rc: RoundConfig,
                  server_opt: Optional[opt_lib.Optimizer] = None,
                  device=None,
                  sanitize: Optional[sanitize_lib.SanitizeConfig] = None,
                  fused_threshold: Optional[int] = None, plan=None,
                  constrain_fn: Optional[Callable] = None,
                  constrain_flat_fn=None, model_shards=None):
    """Builds round_step(y, server_state, frozen, batch, weights, rng=None)
    -> (y_new, server_state, metrics), running on ``device`` (CUDA by
    default; raises when there is none and the CPU was not asked for); or,
    under a non-trivial trainability ``plan``, round_step(y, server_state,
    frozen, batch, weights, tiers, rng=None) with ``tiers`` (clients,) the
    tier index of each cohort slot.

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

    ``plan`` (a ``core/plan.CompiledPlan``): a trivial plan takes the
    untiered round. Otherwise each client's gradients are masked with its
    tier's leaf mask every local step, so the blocks its tier froze carry
    zero delta, and, without a clip, the mean divides each block by the
    tier-mask-weighted weight sum (zero weight there too); under DP the
    denominator stays the fixed ``clients_per_round``. The per-client
    masks are picked outside ``vmap`` by indexing each leaf's (n_tiers,)
    0/1 stack with the tier ids, which is exact.

    metrics: ``loss`` (mean client loss), ``delta_norm`` (norm of the
    aggregated update: of the flat vector through the sumsq kernel on
    CUDA, or of the unflattened tree when noised, since pad slots carry
    noise), ``update_norm`` when clipping, and ``quarantine_nonfinite``
    / ``quarantine_outlier`` / ``quarantine_norms`` (per row) with the
    screen on.

    The mesh hooks (module docstring): ``constrain_flat_fn`` (the flat
    plane, ``launch/sharding.flat_constrainer``) makes each rank train its
    rows of the cohort (the plane's rows of the batch) and aggregate its
    block; ``constrain_fn`` lays out ``y``.

    ``model_shards`` (``launch/sharding.ModelShards``): the tensor-parallel
    step. ``y``, the server state and ``frozen`` are this rank's pieces on
    "model" and ``loss_fn`` computes on them; each client's row of the
    flat buffer (its layout is the whole tree's) is made from the delta's
    pieces gathered over "model", this rank's columns only
    (``model_shards.flat_cols``), and the server steps on its pieces of
    the aggregated update. Every rank trains as many client rows as the plane's first
    rank (a client's layers may exchange over the data axes, a collective
    each rank must join): a shorter rank adds copies of the cohort's first
    row and drops their deltas and losses."""
    dev = resolve_device(device)
    plane = constrain_flat_fn
    noised = rc.dp_clip_norm > 0 and rc.dp_noise_multiplier > 0
    sigma = (rc.dp_noise_multiplier * rc.dp_clip_norm
             / rc.clients_per_round) if noised else 0.0
    client_opt = opt_lib.get_optimizer(rc.client_opt, rc.client_lr)
    if server_opt is None:
        server_opt = resolve_server_opt(rc)
    client_update = make_client_update(loss_fn, client_opt, rc.local_steps)
    tiered = plan is not None and not plan.trivial
    if tiered and model_shards is not None:
        raise NotImplementedError("a trainability plan in the tensor-"
                                  "parallel round (model_shards)")
    if tiered:
        # leaf -> (n_tiers,) 0/1 on the device, made once
        stacked = tree_map(lambda *ms: torch.stack(ms).to(dev),
                           *plan.leaf_masks())
        bmasks = plan.block_masks_on(dev)

    def _round_step(y, server_state, frozen, batch, weights, tiers, rng):
        if noised and rng is None:
            raise ValueError("DP noise is on: round_step needs the round's "
                             "threefry key rng")
        if constrain_fn is not None:
            y = constrain_fn(y, clients=True)
        for leaf in tree_leaves(y) + tree_leaves(frozen):
            if leaf.device != dev:
                raise ValueError(f"parameters on {leaf.device}, the round "
                                 f"runs on {dev}")
        layout = flat_lib.FlatLayout.of(
            y if model_shards is None else model_shards.struct)
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        n = weights.shape[0]
        r0, r1 = (0, n) if plane is None else plane.rows(n)
        pad = 0
        if plane is not None:
            if model_shards is not None:
                pad = -(-n // plane.D) - (r1 - r0)
            batch = {k: torch.cat([plane.local_rows(v)]
                                  + [v[:1]] * pad) if pad else
                     plane.local_rows(v) for k, v in batch.items()}
        batch = _on(dev, batch)

        # --- local training on every sampled client, vmapped over the
        # client axis; deltas are born flat, one (clients, size) buffer
        # (under model_shards, this rank's columns of it) ----------------
        c0, c1 = (0, layout.size) if plane is None else plane.cols(
            layout.size)
        width = layout.size if model_shards is None else c1 - c0

        def flat_client(cb, mask=None):
            delta, metrics = client_update(y, frozen, cb, mask)
            row = (layout.flatten(delta) if model_shards is None else
                   model_shards.flat_cols(delta, layout, c0, c1))
            return row, metrics["client_loss"]

        bmask = None
        if tiered:
            tids = torch.as_tensor(tiers, dtype=torch.long, device=dev)
            masks = tree_map(lambda st: st[tids[r0:r1]], stacked)
            deltas, losses = _vmap_rows(flat_client, r1 - r0, layout.size,
                                        dev, batch, masks)
            if rc.dp_clip_norm <= 0:
                bmask = bmasks[tids]
        else:
            deltas, losses = _vmap_rows(flat_client, r1 - r0 + pad, width,
                                        dev, batch)
            if pad:
                deltas, losses = deltas[:r1 - r0], losses[:r1 - r0]
        if plane is not None:
            if model_shards is None:
                deltas = plane.local_cols(deltas).contiguous()
            losses = plane.gather_rows(losses, n)

        # --- server tail: screen / quantize / clip / mean / noise --------
        flat_delta, ainfo = kernel_ops.agg_tail(
            deltas, weights,
            block_leaf=layout.block_leaf_on(dev),
            n_leaves=len(layout.sizes),
            align=layout.align,
            bits=rc.uplink_bits or 0,
            clip_norm=rc.dp_clip_norm if rc.dp_clip_norm > 0 else 0.0,
            uniform=bool(rc.uniform_weights or rc.dp_clip_norm > 0),
            wsum_fixed=(float(rc.clients_per_round)
                        if rc.dp_clip_norm > 0 else None),
            sigma=sigma, rng=rng if noised else None,
            # per-block mask-weighted mean for tiers; under DP / clip the
            # mean keeps the fixed denominator instead
            bmask=bmask, block_denom=bmask is not None,
            screen=sanitize, constrain_fn=plane, threshold=fused_threshold)
        del deltas                 # the (clients, size) buffer, consumed
        if plane is not None:
            flat_delta = plane.gather_cols(flat_delta, layout.size)

        # --- ServerOpt on the pseudo-gradient ---------------------------
        delta = layout.unflatten(flat_delta, dtype=torch.float32)
        delta_norm = (opt_lib.tree_global_norm(delta) if noised else
                      torch.sqrt(flat_lib.sumsq(flat_delta, layout.align)))
        neg = tree_map(torch.neg, delta if model_shards is None
                       else model_shards.local(delta))
        del delta, flat_delta      # the server steps on its pieces alone
        y_new, server_state = server_opt.update(y, neg, server_state)
        if constrain_fn is not None:
            y_new = constrain_fn(y_new, clients=False)
        out_metrics = {"loss": losses.mean(), "delta_norm": delta_norm}
        if "update_norms" in ainfo:
            out_metrics["update_norm"] = ainfo["update_norms"].mean()
        if sanitize is not None:
            out_metrics["quarantine_nonfinite"] = ainfo["nonfinite"]
            out_metrics["quarantine_outlier"] = ainfo["outlier"]
            out_metrics["quarantine_norms"] = ainfo["norms"]
        return y_new, server_state, out_metrics

    if tiered:
        def round_step(y, server_state, frozen, batch, weights, tiers,
                       rng=None):
            return _round_step(y, server_state, frozen, batch, weights,
                               tiers, rng)
    else:
        def round_step(y, server_state, frozen, batch, weights, rng=None):
            return _round_step(y, server_state, frozen, batch, weights,
                               None, rng)

    return round_step, server_opt


# ---------------------------------------------------------------------------
# Asynchronous (buffered) aggregation hooks — used by sim/scheduler.py.
#
# FedBuff-style servers weight each buffered client delta by a function of
# its *staleness* s = (server version now) - (server version the client
# downloaded). The weighting is pluggable; the named defaults follow
# Nguyen et al. 2022 (polynomial, a=0.5) and Xie et al. 2019 (hinge).


def staleness_constant():
    """No down-weighting (plain buffered FedAvg)."""
    return lambda s: 1.0


def staleness_polynomial(power: float = 0.5):
    """w(s) = (1+s)^-a; a=0.5 is FedBuff's 1/sqrt(1+s)."""
    return lambda s: (1.0 + float(s)) ** (-power)


def staleness_hinge(delay: float = 4.0, slope: float = 0.5):
    """w(s) = 1 while s <= delay, then 1/(slope*(s-delay)+1)."""
    def fn(s):
        s = float(s)
        return 1.0 if s <= delay else 1.0 / (slope * (s - delay) + 1.0)
    return fn


STALENESS_FNS = {
    "constant": staleness_constant,
    "polynomial": staleness_polynomial,
    "hinge": staleness_hinge,
}


def get_staleness_fn(name="polynomial", **kw) -> Callable[[float], float]:
    """Resolve a staleness weighting: a callable passes through, a name
    looks up STALENESS_FNS (kw forwarded to the factory)."""
    if callable(name):
        return name
    try:
        return STALENESS_FNS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown staleness_fn {name!r}; "
                         f"options: {sorted(STALENESS_FNS)}") from None


def _uplink_tail(rc: RoundConfig, layout, rows: torch.Tensor):
    """The client-side uplink model over (rows, size) flat deltas, in the
    reference client step's order: int-k fake-quantize, then the DP clip.
    Each row gets what the reference's step gives that client alone.
    Returns (rows, pre-clip norms or None)."""
    if rc.uplink_bits:
        rows = flat_lib.fake_quantize(rows, layout, rc.uplink_bits)
    nrm = None
    if rc.dp_clip_norm > 0:
        rows, nrm = flat_lib.clip(rows, rc.dp_clip_norm, layout)
    return rows, nrm


def _on(dev, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _tier_split(y, frozen, tier, plan):
    """(trained subtree, frozen side) of a client step: ``y`` and
    ``frozen`` untiered; for a tier, its subtree of ``y`` and the frozen
    side with the tier's extra-frozen leaves merged in."""
    if tier is None:
        return y, frozen
    y_t, extra = plan.split(y, tier)
    return y_t, part.merge(frozen, extra)


def make_client_step(loss_fn: Callable, rc: RoundConfig,
                     client_opt: Optional[opt_lib.Optimizer] = None,
                     tier=None, plan=None, scatter: bool = True,
                     device=None):
    """Single-client step for the async grid's sequential engine:
    (y, frozen, client_batch) -> (flat_delta (size,), metrics). The delta
    is born flat on the ``FlatLayout`` of ``y``; the uplink quantization
    and the DP clip then run over it as a one-row buffer, through the
    same kernels as a lane (:func:`make_lane_step`). metrics:
    ``client_loss`` (a 0-d tensor, left on the device) and, when
    clipping, ``update_norm``. Runs on ``device`` (CUDA by default).

    ``tier`` (a ``core/plan.TierSlice``, with its ``plan``) builds the
    step for one trainability tier: ``y`` is split structurally (the
    tier's extra-frozen leaves join the frozen side), the delta is the
    tier's contiguous ``(tier_size,)`` slice, and the quantization scales
    and clip norm come from that slice, equal to those of the
    zero-scattered full row. With ``scatter=True`` the step returns the
    slice scattered to the global ``(size,)`` width, else the slice (the
    wire payload)."""
    if tier is not None and plan is None:
        raise ValueError("a tiered client step needs the owning "
                         "CompiledPlan (plan=...)")
    dev = resolve_device(device)
    if client_opt is None:
        client_opt = opt_lib.get_optimizer(rc.client_opt, rc.client_lr)
    client_update = make_client_update(loss_fn, client_opt, rc.local_steps)

    def client_step(y, frozen, client_batch):
        y_t, z_t = _tier_split(y, frozen, tier, plan)
        layout = flat_lib.FlatLayout.of(y_t)
        delta, metrics = client_update(y_t, z_t, _on(dev, client_batch))
        rows, nrm = _uplink_tail(rc, layout, layout.flatten(delta)[None])
        if nrm is not None:
            metrics = dict(metrics, update_norm=nrm[0])
        flat_delta = rows[0]
        if tier is not None and scatter:
            flat_delta = plan.scatter(flat_delta, tier)
        return flat_delta, metrics

    return client_step


def make_lane_step(loss_fn: Callable, rc: RoundConfig, lane: int,
                   client_opt: Optional[opt_lib.Optimizer] = None,
                   tier=None, plan=None, device=None,
                   constrain_flat_fn=None):
    """Batched client step for the async grid's fixed-width lanes:
    (y, frozen, lane_batch) -> (flat_deltas (lane, size), losses (lane,)).

    Local training and the flatten run under ``torch.func.vmap`` over the
    lane; the uplink quantization and the DP clip then take the whole
    (lane, size) buffer in one kernel call each (a ctypes kernel cannot
    run inside ``vmap``), row by row what the reference's vmapped client
    step gives each client. Runs on ``device`` (CUDA by default).

    With a ``tier`` / ``plan`` pair the lane is tier-homogeneous: the
    clients train the tier's subtree, the quantize and clip kernels run
    at the tier's ``(lane, tier_size)`` width over its own block map, and
    one static-index scatter widens the rows to the global ``(lane,
    size)`` buffer, exact zeros outside the tier.

    ``constrain_flat_fn`` (the mesh's flat plane): each rank trains, and
    quantizes and clips, the lane slots of its rows along the data axes,
    then the rows and losses are gathered whole on every rank."""
    if tier is not None and plan is None:
        raise ValueError("a tiered lane step needs the owning CompiledPlan "
                         "(plan=...)")
    dev = resolve_device(device)
    if client_opt is None:
        client_opt = opt_lib.get_optimizer(rc.client_opt, rc.client_lr)
    client_update = make_client_update(loss_fn, client_opt, rc.local_steps)

    plane = constrain_flat_fn

    def lane_step(y, frozen, lane_batch):
        y_t, z_t = _tier_split(y, frozen, tier, plan)
        layout = flat_lib.FlatLayout.of(y_t)

        def flat_client(cb):
            delta, metrics = client_update(y_t, z_t, cb)
            return layout.flatten(delta), metrics["client_loss"]

        width = len(next(iter(lane_batch.values())))
        if width != lane:
            raise ValueError(f"lane batch of {width} clients, the lane is "
                             f"{lane} wide")
        if plane is not None:
            lane_batch = {k: plane.local_rows(v)
                          for k, v in lane_batch.items()}
        r0, r1 = (0, lane) if plane is None else plane.rows(lane)
        if r1 > r0:
            rows, losses = torch.func.vmap(flat_client)(_on(dev, lane_batch))
            rows, _ = _uplink_tail(rc, layout, rows)
        else:
            rows, losses = _vmap_rows(flat_client, 0, layout.size, dev)
        if tier is not None:
            rows = plan.scatter(rows, tier)
        if plane is not None:
            rows = plane.gather_rows(rows, lane)
            losses = plane.gather_rows(losses, lane)
        return rows, losses

    return lane_step


def make_buffered_apply(server_opt: opt_lib.Optimizer, flush_dp=None,
                        plan=None, sanitize=None, fused_threshold=None,
                        device=None, constrain_flat_fn=None):
    """Server-side flush of an async buffer: apply(y, server_state,
    flat_deltas, weights, rng=None) -> (y_new, server_state, metrics),
    with ``flat_deltas`` the (K, size) stack of flat client deltas and
    weights (K,) already including the staleness factor. The tail
    (``kernels/ops.agg_tail``) takes the weighted mean, ServerOpt the
    pseudo-gradient, as in the sync engine.

    K is a fixed shape: short buffers (a drained final flush) are padded
    with zero-weight rows by the caller, which fall out of the weighted
    mean. ``flush_dp`` (a :class:`repro_torch.core.dp.FlushDPConfig`)
    turns on per-flush DP: the mean divides by the FIXED ``goal_count``
    and ``rng`` (the flush's threefry key) drives ONE Gaussian draw over
    the flat buffer; client deltas must arrive clipped. ``sanitize``
    screens the buffer first; the quarantine masks ride back on the
    metrics. metrics: ``delta_norm`` (of the flat update through the
    sumsq kernel, or of the unflattened tree when noised, since pad
    slots carry noise).

    ``plan`` (a non-trivial ``core/plan.CompiledPlan``) switches to
    apply(y, server_state, flat_deltas, weights, tier_ids, rng=None):
    ``tier_ids`` (K,) names each row's tier; the rows are re-masked to
    their tiers and, without ``flush_dp``, each block is divided by its
    tier-mask-weighted weight sum; with ``flush_dp`` the denominator
    stays the fixed ``goal_count``. Padding rows carry weight 0 and tier
    0.

    ``constrain_flat_fn`` (the mesh's flat plane): each rank aggregates
    its block of the buffer (its rows along the data axes, its blocks
    along "model"), and the update's columns are gathered whole."""
    dev = resolve_device(device)
    noised = flush_dp is not None and flush_dp.noise_multiplier > 0
    tiered = plan is not None and not plan.trivial
    bmasks = plan.block_masks_on(dev) if tiered else None
    plane = constrain_flat_fn

    def _apply(y, server_state, flat_deltas, weights, tier_ids, rng):
        if noised and rng is None:
            raise ValueError("flush DP noise needs a per-flush rng key")
        layout = flat_lib.FlatLayout.of(y)
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        bmask = None
        if tiered:
            bmask = bmasks[torch.as_tensor(tier_ids, dtype=torch.long,
                                           device=dev)]
        if plane is not None:
            flat_deltas = plane(flat_deltas, clients=True).contiguous()
        flat_delta, ainfo = kernel_ops.agg_tail(
            flat_deltas, weights,
            block_leaf=layout.block_leaf_on(dev),
            n_leaves=len(layout.sizes),
            align=layout.align,
            wsum_fixed=(float(flush_dp.goal_count)
                        if flush_dp is not None else None),
            sigma=flush_dp.sigma if noised else 0.0,
            rng=rng if noised else None,
            bmask=bmask, remask_rows=tiered,
            block_denom=tiered and flush_dp is None,
            screen=sanitize, constrain_fn=plane, threshold=fused_threshold)
        if plane is not None:
            flat_delta = plane.gather_cols(flat_delta, layout.size)
        delta = layout.unflatten(flat_delta, dtype=torch.float32)
        neg = tree_map(torch.neg, delta)
        y_new, server_state = server_opt.update(y, neg, server_state)
        out = {"delta_norm": opt_lib.tree_global_norm(delta) if noised
               else torch.sqrt(flat_lib.sumsq(flat_delta, layout.align))}
        if sanitize is not None:
            out["quarantine_nonfinite"] = ainfo["nonfinite"]
            out["quarantine_outlier"] = ainfo["outlier"]
            out["quarantine_norms"] = ainfo["norms"]
        return y_new, server_state, out

    if tiered:
        def apply_fn(y, server_state, flat_deltas, weights, tier_ids,
                     rng=None):
            return _apply(y, server_state, flat_deltas, weights, tier_ids,
                          rng)
    else:
        def apply_fn(y, server_state, flat_deltas, weights, rng=None):
            return _apply(y, server_state, flat_deltas, weights, None, rng)

    return apply_fn


def make_eval_fn(loss_fn: Callable):
    """Centralized eval of the merged model: eval_step(y, frozen, batch)
    -> loss."""

    def eval_step(y, frozen, batch):
        with torch.no_grad():
            out = loss_fn(part.merge(y, frozen), batch)
        return out[0] if isinstance(out, tuple) else out

    return eval_step
