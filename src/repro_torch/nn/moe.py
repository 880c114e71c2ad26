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
stacks are this rank's pieces: E / m experts (the ``model`` mode), each
expert's FFN columns (``ffn``), or E / D experts on their FFN columns
(``2d``: the expert dim on "data", under ``launch/mesh.expert_parallel``).
Routing and the slot ranks stay the same on every "model" rank (a
float32 router on the same tokens). A rank dispatches only the slots of
the experts it holds, as the reference's placements keep the buffer: in
the ``model`` mode its E / m experts' (E / m, cap, d) narrow of the
buffer, bit for bit, and its combine reads only those rows, an entry of
another rank's expert counting as zero (no (E, cap, d) buffer and no
zero rows for the others); in the ``ffn`` mode every expert's. The
rank's partial outputs are summed over "model" in rank order (at k = 2
in the ``model`` mode, the unmeshed bits given the same expert outputs:
one rank's partial holds both of a token's rows or each holds one, and
the float32 sum of two bf16 rows is exact before its one rounding). In
the ``2d`` mode a client's buffer (the train step) goes to the data
ranks that hold its experts and the outputs come back
(``launch/mesh.expert_exchange`` / ``expert_return``); a batch split
over the data ranks (the prefill) shares its tokens and entries over
"data" instead (``expert_share``): each expert rank fills only its E / D
experts' slots of the global layout, runs them once and sends each data
rank its tokens' partial combine, added there in rank order in float32
(``expert_reduce``) before the sum over "model" and one rounding.
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


def _slots(idx, e: int, cap: int, offset=None):
    """Each entry's slot in the (E * cap) global slot layout, and whether
    it is kept.

    Entry f = t * k + j (token t's j-th expert) takes slot ``expert * cap
    + rank``, its rank being the count of earlier entries routed to the
    same expert (the reference's stable-sort position), plus
    ``offset[expert]`` (the earlier data ranks' entries, from
    :func:`_global_slots`); ranks from cap on are dropped, and a dropped
    entry takes a slot of its own past the E * cap (``E * cap + f``)."""
    n = idx.shape[0] * idx.shape[1]
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
    entry = torch.arange(n, device=idx.device)
    return torch.where(keep, flat_e * cap + rank, e * cap + entry), keep


def _fill(xp, slot, row, lo: int, n: int, empty: int):
    """The (n, d) rows of slots [lo, lo + n): each the row ``row[f]`` of
    ``xp`` of the entry f that holds the slot, row ``empty`` (a zero row)
    where none does. A copy: the rows' bits."""
    m = slot.shape[-1]
    local = slot - lo
    inside = (local >= 0) & (local < n)
    # an entry outside takes an index row of its own past the n, so that
    # no two entries share a row of the scattered index
    spare = n + torch.arange(m, device=slot.device)
    src = torch.full((n + m,), empty, dtype=torch.long, device=slot.device)
    src = src.scatter(0, torch.where(inside, local, spare), row)
    return xp.index_select(0, src[:n])


def _sort_dispatch(x, w, idx, e: int, cap: int, cd, offset=None,
                   experts=None):
    """Dispatch of (T, d) tokens into the (el, cap, d) slots of experts
    [e0, e0 + el) (``experts`` = (e0, el); all E by default): the whole
    (E, cap, d) buffer's narrow to them, bit for bit (:func:`_slots`).
    Returns (buf, meta), meta = (slot, keep, weight) per entry in token
    order for :func:`_combine_local`."""
    T, d = x.shape
    k = idx.shape[1]
    e0, el = experts or (0, e)
    slot, keep = _slots(idx, e, cap, offset)
    row = torch.arange(slot.shape[-1], device=x.device) // k  # its token
    xp = torch.cat([x.to(cd), torch.zeros((1, d), dtype=cd, device=x.device)])
    buf = _fill(xp, slot, row, e0 * cap, el * cap, T).reshape(el, cap, d)
    return buf, (slot, keep, w.reshape(-1))


def _combine_local(y_flat, meta, T: int, e: int, cap: int, cd,
                   experts=None):
    """Inverse of :func:`_sort_dispatch`: each token's k weighted expert
    rows, gathered and summed in a fixed order into (T, d). With
    ``experts`` = (e0, el), ``y_flat`` holds those experts' (el * cap, d)
    rows alone and an entry of another expert counts as zero: the partial
    combine of this rank's experts. The whole bank's combine gathers all
    (T * k, d) rows at once; a range's, a token's j-th rows (T, d) at a
    time (the same adds in the same order), so that it holds no more than
    its own slots' share of them."""
    slot, keep, sw = meta
    e0, el = experts or (0, e)
    n, d = el * cap, y_flat.shape[-1]
    # k named, not -1: a data rank with no rows has T = 0
    k = slot.shape[-1] // max(T, 1)
    step = max(k, 1) if el == e else 1
    local = (slot - e0 * cap).reshape(T, k)
    inside = (keep.reshape(T, k) & (local >= 0) & (local < n))[..., None]
    local = local.clamp(0, n - 1)
    sw = sw.reshape(T, k, 1).to(cd)
    out = torch.zeros((T, d), dtype=cd, device=y_flat.device)
    for j0 in range(0, k, step):
        js = slice(j0, j0 + step)
        rows = y_flat.index_select(0, local[:, js].reshape(-1))
        rows = torch.where(inside[:, js], rows.reshape(T, -1, d), 0.0)
        rows = rows * sw[:, js]
        for j in range(rows.shape[1]):
            out = out + rows[:, j]
    return out


def _experts(buf, p, cd, ff_axis=None):
    """The expert FFNs on the (..., E, cap, d) dispatch buffer, in ``cd``:
    silu(x @ wi_gate[e]) * (x @ wi_up[e]) @ wo[e] for each expert e's
    (..., cap, d) slots. One matrix product an expert: under ``vmap`` the
    clients' rows then stack onto one unbatched weight, where a batched
    (E, cap, d) x (E, d, ff) product copies the weights once a client.
    ``ff_axis`` hints each expert's hidden activations' FFN dim onto that
    mesh axis (an expert's slice of the reference's hint)."""
    return torch.stack([_expert(buf.select(-3, e), p, e, cd, ff_axis)
                        for e in range(buf.shape[-3])], dim=-3)


def _expert(x, p, e: int, cd, ff_axis=None):
    """Expert e of this rank's stacks on its (..., cap, d) slots."""
    g = x @ p["wi_gate"][e].to(cd)
    u = x @ p["wi_up"][e].to(cd)
    h = basic.maybe_constrain(torch.nn.functional.silu(g) * u,
                              (None, ff_axis))
    return h @ p["wo"][e].to(cd)


def _expert_split(p, cfg: ModelConfig):
    """How this rank's expert stacks are split: (the expert dim's axis,
    "model", "data" (under the ambient expert-parallel group) or None;
    whether each expert's FFN dim is split on "model"). ``(None, False)``
    is whole."""
    tp, ep = mesh_lib.current_tp(), mesh_lib.current_ep()
    el, ffl = p["wi_gate"].shape[-3], p["wi_gate"].shape[-1]
    e_axis = None
    if el != cfg.num_experts:
        e_axis = "data" if ep is not None else "model"
    ff_split = ffl != cfg.expert_d_ff
    if (e_axis == "model" or ff_split) and tp is None:
        raise ValueError("the expert stacks hold pieces on 'model' outside "
                         "a tensor-parallel step")
    return e_axis, ff_split


def _partial(split) -> bool:
    """True when the combine of this rank's expert outputs is its partial
    sum over "model" (the experts or their FFN columns split there)."""
    return split[0] == "model" or split[1]


def _hint_axes(cfg: ModelConfig, split):
    """The mesh axes of the expert dim and of the experts' hidden FFN dim
    for the sharding hints: where this rank's pieces put them, or, with
    whole stacks, the reference's choice ("data" / "model" for huge
    banks, the 2-D mode; else "model" / None)."""
    if split != (None, False):
        return split[0], "model" if split[1] else None
    if cfg.num_experts >= 64:
        return "data", "model"
    return "model", None


def _own_experts(p, cfg: ModelConfig, split):
    """The experts (e0, el) whose slots this rank dispatches and combines:
    in the ``model`` mode its own E / m, else all E."""
    if split[0] != "model":
        return 0, cfg.num_experts
    el = p["wi_gate"].shape[-3]
    return mesh_lib.current_tp().rank * el, el


def _experts_tp(buf, p, cd, split, ff_axis=None):
    """:func:`_experts` on this rank's pieces of the expert stacks
    (``split`` from :func:`_expert_split`) and its dispatch buffer: its
    own experts' slots in the ``model`` mode, every expert's on its FFN
    columns in the ``ffn`` mode. With the expert dim on "data", the buffer
    (..., E, cap, d) of the rank's own tokens (a client's, in the train
    step) goes to the data ranks that hold its experts
    (``expert_exchange``), the rank runs its E / D experts on every
    source's rows for them, and ``expert_return`` sends each source its
    rows back, (..., E, cap, d)."""
    if split[0] != "data":
        return _experts(buf, p, cd, ff_axis)
    y = _experts(mesh_lib.expert_exchange(buf), p, cd, ff_axis)
    return mesh_lib.expert_return(y)


@torch.no_grad()
def _experts_shared_rows(x, slot, sw, p, cfg: ModelConfig, cap: int,
                         row_len, ff_axis=None):
    """The ``2d`` mode on a batch whose rows are split over the data ranks
    (the prefill; no gradient): this rank's tokens x (T, d), their
    entries' global slots (:func:`_slots`; a dropped entry's past the E *
    cap) and weights (T * k,) -> (T, d) float32, the data ranks' partial
    combines for them added in data-rank order (this "model" rank's
    partial when the FFN dim is split).

    Every data rank pads its tokens and entries to the most a data rank
    holds (``torch.chunk``'s first piece: from the global rows and
    ``row_len`` alone), a zero row after its tokens, and hands them to
    every other (``launch/mesh.expert_share``); the rank fills its E / D
    experts' slots of the global slot layout from all of them (a copy of
    the rows the whole buffer holds there), runs its experts once and
    combines each source's entries of its experts; each source gets its
    tokens' partials back and adds them in rank order
    (``expert_reduce``). A data rank with no rows joins with padding."""
    ep, ds = mesh_lib.current_ep(), mesh_lib.current_data_split()
    cd = cfg.cdtype
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    el = p["wi_gate"].shape[-3]
    e0 = ep.rank * el
    T, d = x.shape
    tm = -(-ds.rows // ds.size) * row_len
    if T > tm:
        raise ValueError(f"{T} tokens on a data rank; the split's pieces "
                         f"hold at most {tm}")
    pad = (tm - T) * k
    # a padded entry's slot is past the E * cap, as a dropped one's is
    xs = torch.cat([x.to(cd), x.new_zeros((tm + 1 - T, d), dtype=cd)])
    xs = mesh_lib.expert_share(xs)                        # (D, tm + 1, d)
    S = mesh_lib.expert_share(torch.cat([slot, slot.new_full((pad,),
                                                             e * cap)]))
    W = mesh_lib.expert_share(torch.cat([sw, sw.new_zeros((pad,))]))
    D, n = S.shape
    # entry f of source s is token f // k of that source's rows; row tm,
    # source 0's zero row, fills an empty slot
    row = (torch.arange(D, device=x.device)[:, None] * (tm + 1)
           + torch.arange(n, device=x.device)[None, :] // k).reshape(-1)
    buf = _fill(xs.reshape(-1, d), S.reshape(-1), row, e0 * cap, el * cap,
                tm).reshape(el, cap, d)
    del xs
    # no gradient: each expert's outputs overwrite its slots (the bits of
    # :func:`_experts`, one buffer's bytes)
    for j in range(el):
        buf[j] = _expert(buf[j], p, j, cd, ff_axis)
    y = buf.reshape(el * cap, d)
    del buf
    parts = y.new_empty((D, tm, d))
    for s in range(D):
        parts[s] = _combine_local(y, (S[s], S[s] < e * cap, W[s]), tm, e,
                                  cap, cd, (e0, el))
    del y
    return mesh_lib.expert_reduce(parts)[:T]


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
    split = _expert_split(p, cfg)
    expert_axis, ff_axis = _hint_axes(cfg, split)
    if split[0] == "data" and split_rows:
        slot = _slots(idx, e, cap, offset)[0]
        out = _experts_shared_rows(x, slot, w.reshape(-1), p, cfg, cap,
                                   row_len, ff_axis)
    else:
        experts = _own_experts(p, cfg, split)
        # the tokens, the same on every "model" rank, feed each rank's own
        # slots or FFN columns
        xd = mesh_lib.tp_copy(x) if _partial(split) else x
        buf, meta = _sort_dispatch(xd, w, idx, e, cap, cd, offset, experts)
        buf = basic.maybe_constrain(buf, (expert_axis, None, None))
        y = _experts_tp(buf, p, cd, split, ff_axis)
        y = basic.maybe_constrain(y, (expert_axis, None, None))
        if _partial(split):
            meta = _partial_meta(meta)
        out = _combine_local(y.reshape(-1, d), meta, T, e, cap, cd, experts)
    if _partial(split):
        out = mesh_lib.tp_reduce(out)
    out = out.to(cd)
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
    split = _expert_split(p, cfg)
    experts = _own_experts(p, cfg, split)
    xd = mesh_lib.tp_copy(x) if _partial(split) else x

    def local(xl, xdl):
        w, idx, aux = router_topk(xl, p, cfg)
        buf, meta = _sort_dispatch(xdl, w, idx, e, cap, cd, None, experts)
        return buf, meta, aux

    bufs, metas, auxs = torch.func.vmap(local)(x.reshape(g, Tl, d),
                                               xd.reshape(g, Tl, d))
    y = _experts_tp(bufs, p, cd, split)
    if _partial(split):
        metas = _partial_meta(metas)
    out = torch.func.vmap(
        lambda yl, *m: _combine_local(yl.reshape(-1, d), m, Tl, e, cap, cd,
                                      experts))(y, *metas)
    out = out.reshape(T, d)
    if _partial(split):
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
