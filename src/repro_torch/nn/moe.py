"""Mixture-of-Experts, port of ``repro/nn/moe.py``: a top-k router and a
capacity-bounded dispatch into a dense (experts, capacity, d_model)
buffer, the expert FFNs (a matrix product an expert), and the weighted
combine.
Tokens past an expert's capacity are dropped (Switch / GShard
semantics); shared experts (DeepSeek-V2) run densely on every token.

The reference places each routed token by a stable sort over expert ids;
its place in the buffer is its rank among the earlier tokens routed to
the same expert. Here the stable sort's position of each entry is one
flat cumulative sum over the expert-major one-hot choices, the rank that
position less its expert's start (an exclusive cumulative sum of the
per-expert counts): the same integers without the sort. The buffer is a
gather from the tokens padded with a zero row through an integer index
scattered once. The combine gathers each token's k expert rows and adds
them in a fixed order, where the reference scatter-adds: no float
atomics, and at k = 2 the reference's bits given the same expert outputs
((0 + a) + b is commutative). Every step is a ``torch.func.vmap``-
batchable op, since the round engine vmaps the clients.

A serving step whose batch rows are split over data ranks (the meshed
prefill and decode, ``launch/mesh.data_split``) keeps the reference's
global-batch rule: the capacity is counted over the global batch's
tokens and each entry's rank within its expert is its place in the
global stable order, its local rank plus the earlier data ranks' counts
for that expert (one small integer all-gather). The expert FFN is
row-independent, so a rank keeps its local buffer and marks ``keep``
from the global rank.

The reference's three sharding hints sit at its sites
(``nn/basic.maybe_constrain``: the dispatch buffer, the experts' hidden
activations, their outputs), no-ops without an ambient mesh or on plain
tensors.

Under tensor parallelism (``launch/mesh.tensor_parallel``) the expert
stacks are this rank's pieces: E / m experts (the ``model`` mode) or
each expert's FFN columns (``ffn``). Routing and dispatch stay the same
on every rank (a float32 router on the same tokens); the rank runs its
pieces, combines its partial output and the partials are summed over
"model" in rank order (at k = 2 in the ``model`` mode, the unmeshed bits
given the same expert outputs: one rank's partial holds both of a
token's rows or each holds one, and the float32 sum of two bf16 rows is
exact before its one rounding).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import basic


def init_moe(seed, path, cfg: ModelConfig, dtype, device=None):
    d, e = cfg.d_model, cfg.num_experts
    ff = cfg.expert_d_ff
    p = {
        "router": basic.init_dense(seed, f"{path}/router", d, e, dtype,
                                   device=device),
        # stacked expert weights: (E, d, ff) / (E, ff, d)
        "wi_gate": basic.normal_init(seed, f"{path}/wi_gate", (e, d, ff),
                                     dtype, fan_in=d, device=device),
        "wi_up": basic.normal_init(seed, f"{path}/wi_up", (e, d, ff), dtype,
                                   fan_in=d, device=device),
        "wo": basic.normal_init(seed, f"{path}/wo", (e, ff, d), dtype,
                                fan_in=ff, device=device),
    }
    if cfg.num_shared_experts > 0:
        sff = cfg.expert_d_ff * cfg.num_shared_experts
        p["shared"] = basic.init_mlp(seed, f"{path}/shared", d, sff, dtype,
                                     gated=True, device=device)
    return p


def _one_hot(idx, e: int, dtype):
    return (idx[..., None] == torch.arange(e, device=idx.device)).to(dtype)


def router_topk(x, p, cfg: ModelConfig):
    """Returns (weights (T,k) in x's dtype, experts (T,k) int32, aux loss
    float32 scalar). Logits and softmax are float32."""
    logits = basic.dense(x, p["router"], torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    e = cfg.num_experts
    me = probs.mean(0)
    ce = _one_hot(idx, e, torch.float32).sum(1).mean(0)
    aux = e * (me * ce).sum()
    return w.to(x.dtype), idx.to(torch.int32), aux


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``max(1, round(T * k / E * cf))``, Python's
    round, as the reference computes it."""
    return int(max(1, round(tokens * cfg.num_experts_per_tok
                            / cfg.num_experts * cfg.moe_capacity_factor)))


def _global_slots(idx, cfg: ModelConfig, row_len):
    """Under a data split (``launch/mesh.current_data_split``): the
    capacity of the global batch's tokens (``row_len`` positions a row)
    and, per expert, the count of the earlier data ranks' entries routed
    to it (an exclusive prefix in data-rank order, the global row
    order)."""
    ds = mesh_lib.current_data_split()
    if row_len is None:
        raise ValueError("moe_ffn on a batch split over data ranks needs "
                         "row_len, the positions a row")
    e = cfg.num_experts
    counts = _one_hot(idx.reshape(-1).long(), e, torch.long).sum(0)
    every = mesh_lib.data_gather(counts)                  # (D, E)
    return capacity(ds.rows * row_len, cfg), every[:ds.rank].sum(0)


def _sort_dispatch(x, w, idx, e: int, cap: int, cd, offset=None):
    """Dispatch of (T, d) tokens into an (E, cap, d) buffer.

    Entry f = t * k + j (token t's j-th expert) takes slot ``expert * cap
    + rank``, its rank being the count of earlier entries routed to the
    same expert (the reference's stable-sort position), plus
    ``offset[expert]`` (the earlier data ranks' entries, from
    :func:`_global_slots`); ranks from cap on are dropped. Returns (buf,
    meta), meta = (slot, keep, weight) per entry in token order for
    :func:`_combine_local`."""
    T, d = x.shape
    k = idx.shape[1]
    n = T * k
    flat_e = idx.reshape(-1).long()                       # (T*k,)
    hot = _one_hot(flat_e, e, torch.long).T               # (E, T*k)
    # the expert-major running count (one scan of a flat vector): at
    # (expert of f, f) it is f's position in the stable sort, plus one
    pos = torch.cumsum(hot.reshape(-1), 0).reshape(e, n)
    pos = pos.gather(0, flat_e[None, :])[0] - 1
    counts = hot.sum(1)
    rank = pos - (torch.cumsum(counts, 0) - counts).gather(0, flat_e)
    if offset is not None:
        rank = rank + offset.gather(0, flat_e)
    keep = rank < cap
    entry = torch.arange(n, device=x.device)
    # a dropped entry takes a drop row of its own past the E*cap slots, so
    # that no two entries share a row of the scattered index
    slot = torch.where(keep, flat_e * cap + rank, e * cap + entry)
    src = torch.full((e * cap + n,), T, dtype=torch.long, device=x.device)
    src = src.scatter(0, slot, entry // k)                # token of each slot
    xp = torch.cat([x.to(cd), torch.zeros((1, d), dtype=cd, device=x.device)])
    buf = xp.index_select(0, src[:e * cap]).reshape(e, cap, d)
    return buf, (slot, keep, w.reshape(-1))


def _combine_local(y_flat, meta, T: int, e: int, cap: int, cd):
    """Inverse of :func:`_sort_dispatch`: each token's k weighted expert
    rows, gathered and summed in a fixed order into (T, d)."""
    slot, keep, sw = meta
    d = y_flat.shape[-1]
    rows = y_flat.index_select(0, torch.clamp_max(slot, e * cap - 1))
    gathered = torch.where(keep[:, None], rows, 0.0) * sw[:, None].to(cd)
    # k named, not -1: a data rank with no rows has T = 0
    gathered = gathered.reshape(T, slot.shape[-1] // max(T, 1), d)
    out = torch.zeros((T, d), dtype=cd, device=y_flat.device)
    for j in range(gathered.shape[1]):
        out = out + gathered[:, j]
    return out


def _experts(buf, p, cd, ff_axis=None):
    """The expert FFNs on the (..., E, cap, d) dispatch buffer, in ``cd``:
    silu(x @ wi_gate[e]) * (x @ wi_up[e]) @ wo[e] for each expert e's
    (..., cap, d) slots. One matrix product an expert: under ``vmap`` the
    clients' rows then stack onto one unbatched weight, where a batched
    (E, cap, d) x (E, d, ff) product copies the weights once a client.
    ``ff_axis`` hints each expert's hidden activations' FFN dim onto that
    mesh axis (an expert's slice of the reference's hint)."""
    out = []
    for e in range(buf.shape[-3]):
        x = buf.select(-3, e)
        g = x @ p["wi_gate"][e].to(cd)
        u = x @ p["wi_up"][e].to(cd)
        h = basic.maybe_constrain(torch.nn.functional.silu(g) * u,
                                  (None, ff_axis))
        out.append(h @ p["wo"][e].to(cd))
    return torch.stack(out, dim=-3)


def _expert_split(p, cfg: ModelConfig):
    """How this rank's expert stacks are split under the ambient tensor-
    parallel group: "model" (the expert dim on "model": E / m experts a
    rank), "ffn" (each expert's FFN dim), or None (whole)."""
    if mesh_lib.current_tp() is None:
        return None
    el, ffl = p["wi_gate"].shape[-3], p["wi_gate"].shape[-1]
    split = {(True, True): None, (False, True): "model",
             (True, False): "ffn"}.get((el == cfg.num_experts,
                                       ffl == cfg.expert_d_ff), "2d")
    if split == "2d":
        raise NotImplementedError("experts split on both the expert and "
                                  "the FFN dim (2-D expert sharding)")
    return split


def _experts_tp(buf, p, cfg: ModelConfig, cd, split, ff_axis=None):
    """:func:`_experts` on this rank's pieces of the expert stacks
    (``split`` from :func:`_expert_split`) -> y (..., E, cap, d). In the
    ``model`` mode the rank runs its experts' slots and the others' rows
    are zero; in the ``ffn`` mode it runs every expert on its FFN columns.
    Either way the output combined from it is this rank's partial sum; the
    dispatch buffer, the same on every rank, enters through ``tp_copy``."""
    if split is None:
        return _experts(buf, p, cd, ff_axis)
    buf = mesh_lib.tp_copy(buf)
    if split == "ffn":
        return _experts(buf, p, cd, ff_axis)
    el = p["wi_gate"].shape[-3]
    e0 = mesh_lib.current_tp().rank * el
    y = _experts(buf.narrow(-3, e0, el), p, cd, ff_axis)

    def zeros(n):
        return y.new_zeros(y.shape[:-3] + (n,) + y.shape[-2:])
    return torch.cat([zeros(e0), y, zeros(cfg.num_experts - e0 - el)],
                     dim=-3)


def _partial_meta(meta):
    """The combine's per-entry (slot, keep, weight) for a partial combine:
    the router weights, the same on every rank, enter through
    ``tp_copy`` (each rank's combine reads them for its own rows)."""
    slot, keep, sw = meta
    return slot, keep, mesh_lib.tp_copy(sw)


def moe_ffn(x, p, cfg: ModelConfig, row_len=None):
    """x: (T, d) flat tokens -> ((T, d), aux loss).

    Capacity from :func:`capacity`. With ``cfg.moe_dispatch_groups > 1``
    (and T divisible into groups of at least k tokens) routing, dispatch
    and combine run per group (:func:`_moe_ffn_grouped`). Under a data
    split the capacity and the slot ranks are the global batch's
    (:func:`_global_slots`; ``row_len``: the positions of a row); the aux
    loss stays this rank's tokens'."""
    T, d = x.shape
    g = cfg.moe_dispatch_groups
    split_rows = mesh_lib.current_data_split() is not None
    if split_rows and g and g > 1:
        raise NotImplementedError(
            f"moe_dispatch_groups={g} on a batch split over data ranks: "
            "the reference's groups span the global batch")
    if g and g > 1 and T % g == 0 and T // g >= cfg.num_experts_per_tok:
        return _moe_ffn_grouped(x, p, cfg, g)
    e = cfg.num_experts
    cd = cfg.cdtype
    w, idx, aux = router_topk(x, p, cfg)
    cap, offset = ((capacity(T, cfg), None) if not split_rows
                   else _global_slots(idx, cfg, row_len))
    # the expert dim's mesh axis mirrors launch/sharding.py: "data" for
    # huge banks (2-D expert sharding), else "model" (the FFN dim then
    # left to the weights' own layout)
    if cfg.num_experts >= 64:
        expert_axis, ff_axis = "data", "model"
    else:
        expert_axis, ff_axis = "model", None
    split = _expert_split(p, cfg)
    buf, meta = _sort_dispatch(x, w, idx, e, cap, cd, offset)
    buf = basic.maybe_constrain(buf, (expert_axis, None, None))
    y = _experts_tp(buf, p, cfg, cd, split, ff_axis)
    y = basic.maybe_constrain(y, (expert_axis, None, None))
    if split:
        meta = _partial_meta(meta)
    out = _combine_local(y.reshape(e * cap, d), meta, T, e, cap, cd)
    if split:
        out = mesh_lib.tp_reduce(out)
    if cfg.num_shared_experts > 0:
        out = out + _shared(x, p, cfg, cd)
    return out, aux


def _shared(x, p, cfg: ModelConfig, cd):
    return basic.mlp(x, p["shared"], "silu", cd,
                     d_ff=cfg.expert_d_ff * cfg.num_shared_experts)


def _moe_ffn_grouped(x, p, cfg: ModelConfig, g: int):
    """Group-local dispatch: tokens reshape to (g, T/g, d); routing,
    dispatch and combine run per group (vmapped), the expert products over
    all groups at once. Capacity is per group; aux is the groups' mean."""
    T, d = x.shape
    e = cfg.num_experts
    cd = cfg.cdtype
    Tl = T // g
    cap = capacity(Tl, cfg)

    def local(xl):
        w, idx, aux = router_topk(xl, p, cfg)
        buf, meta = _sort_dispatch(xl, w, idx, e, cap, cd)
        return buf, meta, aux

    bufs, metas, auxs = torch.func.vmap(local)(x.reshape(g, Tl, d))
    split = _expert_split(p, cfg)
    y = _experts_tp(bufs, p, cfg, cd, split)
    if split:
        metas = _partial_meta(metas)
    out = torch.func.vmap(
        lambda yl, *m: _combine_local(yl.reshape(e * cap, d), m, Tl, e, cap,
                                      cd))(y, *metas)
    out = out.reshape(T, d)
    if split:
        out = mesh_lib.tp_reduce(out)
    if cfg.num_shared_experts > 0:
        out = out + _shared(x, p, cfg, cd)
    return out, auxs.mean()


def moe_ffn_dense_fallback(x, p, cfg: ModelConfig):
    """Reference: run every expert on every token in float32 and mask
    (the oracle for the tests)."""
    T, d = x.shape
    cd = torch.float32
    w, idx, aux = router_topk(x, p, cfg)
    xf = x.to(cd)
    g = torch.einsum("td,edf->tef", xf, p["wi_gate"].to(cd))
    u = torch.einsum("td,edf->tef", xf, p["wi_up"].to(cd))
    h = torch.nn.functional.silu(g) * u
    y = torch.einsum("tef,efd->ted", h, p["wo"].to(cd))
    # a token's k experts are distinct: one weight a (token, expert)
    mask = torch.zeros((T, cfg.num_experts), dtype=cd, device=x.device)
    mask = mask.scatter(1, idx.long(), w.to(cd))
    out = torch.einsum("ted,te->td", y, mask)
    if cfg.num_shared_experts > 0:
        out = out + basic.mlp(xf, p["shared"], "silu", cd)
    return out.to(x.dtype), aux
