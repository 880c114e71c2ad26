"""Decoder-only LM, port of the dense family of ``repro/models/decoder_lm.py``.

The layer stack is a *periodic program*: ``num_layers / period`` identical
groups of ``period`` slots. Each leaf of the stack is stacked over the
groups along a leading axis, as the reference's ``jax.vmap`` init stacks
it, and the forward pass loops over the groups where the reference
scans. Group g's leaves are drawn from ``fold_in(path_key(seed,
"<name>/stack"), g)``, so they are the reference's bits.

KV caches: full-length buffers for global attention, or a ring buffer of
``sliding_window`` entries when the window is shorter than the cache
(Mistral-style rolling cache, the ``long_500k`` serving shape). The
cache's ``cache_len`` is a Python int (the decode loop is eager).

Dense attention slots only: MoE, Mamba, xLSTM, MLA, VLM and
encoder-decoder slots raise ``NotImplementedError`` until the slices that
port ``nn/moe.py``, ``nn/ssm.py`` and MLA.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import basic, threefry


# ---------------------------------------------------------------------------
# Layer program


class Slot(NamedTuple):
    kind: str       # attn | mamba | mlstm | slstm
    use_moe: bool


def layer_program(cfg: ModelConfig) -> Tuple[Tuple[Slot, ...], int]:
    """Returns (slots-per-group, n_groups)."""
    kinds = cfg.block_kinds()
    period = 1
    if cfg.family == "hybrid" and cfg.attn_period:
        period = cfg.attn_period
    if cfg.family == "ssm" and cfg.slstm_every:
        period = cfg.slstm_every
    if cfg.num_experts > 0 and cfg.moe_period > 1:
        period = math.lcm(period, cfg.moe_period)
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"multiple of the period {period}")
    slots = tuple(Slot(kind=kinds[i], use_moe=cfg.layer_uses_moe(i))
                  for i in range(period))
    return slots, cfg.num_layers // period


def _dense_only(cfg: ModelConfig, slots) -> None:
    """Raise for what this slice does not port."""
    if cfg.family == "vlm" or cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} stack is "
                                  f"not ported yet")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA is not ported yet")
    for slot in slots:
        if slot.kind != ATTN:
            raise NotImplementedError(f"{cfg.name}: {slot.kind} slots "
                                      f"(nn/ssm.py) are not ported yet")
        if slot.use_moe:
            raise NotImplementedError(f"{cfg.name}: MoE FFNs (nn/moe.py) "
                                      f"are not ported yet")


# ---------------------------------------------------------------------------
# Init


def _init_slot(key, cfg: ModelConfig, slot: Slot, si: int, device=None):
    dt = cfg.pdtype
    path = f"layers/slot{si}"
    return {
        "ln1": basic.init_norm(key, f"{path}/ln1", cfg.d_model, dt,
                               cfg.norm_type, device),
        "attn": attn_lib.init_attention(key, f"{path}/attn", cfg, dt, device),
        "ln2": basic.init_norm(key, f"{path}/ln2", cfg.d_model, dt,
                               cfg.norm_type, device),
        "ffn": basic.init_mlp(key, f"{path}/ffn", cfg.d_model, cfg.d_ff, dt,
                              gated=cfg.gated_mlp, device=device),
    }


def _stack(trees):
    """Leafwise stack of same-structure trees along a new leading axis."""
    return basic.tree_map(lambda *xs: torch.stack(xs), *trees)


def _init_stack(seed, cfg: ModelConfig, device=None):
    slots, n_groups = layer_program(cfg)
    root = basic.path_key(seed, f"{cfg.name}/stack")
    keys = [threefry.fold_in(root, g) for g in range(n_groups)]
    return {f"slot{si}": _stack([_init_slot(k, cfg, slot, si, device)
                                 for k in keys])
            for si, slot in enumerate(slots)}


def init_model(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """The parameter tree, on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    _dense_only(cfg, layer_program(cfg)[0])
    dt = cfg.pdtype
    p: Dict[str, Any] = {
        "embed": basic.init_embedding(seed, "embed", cfg.vocab_size,
                                      cfg.d_model, dt, dev),
        "final_norm": basic.init_norm(seed, "final_norm", cfg.d_model, dt,
                                      cfg.norm_type, dev),
        "layers": _init_stack(seed, cfg, dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"kernel": basic.normal_init(
            seed, "unembed/kernel", (cfg.d_model, cfg.vocab_size), dt,
            fan_in=cfg.d_model, device=dev)}
    return p


# ---------------------------------------------------------------------------
# Forward (training / prefill)


def sinusoid_pos(positions, d_model, dtype):
    """Classic sinusoidal position embedding: positions (..., S) -> (..., S, d)."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _apply_slot(x, sp, cfg: ModelConfig, slot: Slot, positions, aux):
    """One residual block. Returns (x, aux, cache_entry)."""
    cd = cfg.cdtype
    h = basic.apply_norm(x, sp["ln1"], cfg.norm_type)
    q, k, v = attn_lib.qkv_project(h, sp["attn"], cfg)
    if cfg.use_rope:
        cos, sin = attn_lib.rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                       positions)
        q = attn_lib.apply_rope(q, cos, sin)
        k = attn_lib.apply_rope(k, cos, sin)
    o = attn_lib.flash_attention(q, k, v, cfg)
    o = basic.dense(o.reshape(o.shape[0], o.shape[1], -1), sp["attn"]["wo"], cd)
    x = x + o
    h2 = basic.apply_norm(x, sp["ln2"], cfg.norm_type)
    y = basic.mlp(h2, sp["ffn"], cfg.act, cd)
    return x + y, aux, (k, v)


def _group(tree, g: int):
    return basic.tree_map(lambda x: x[g], tree)


def _run_stack(stack_params, cfg: ModelConfig, x, positions,
               collect_caches=False):
    slots, n_groups = layer_program(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_group = []
    for g in range(n_groups):
        gp = _group(stack_params, g)
        caches = []
        for si, slot in enumerate(slots):
            x, aux, c = _apply_slot(x, gp[f"slot{si}"], cfg, slot, positions,
                                    aux)
            caches.append(c)
        if collect_caches:
            per_group.append(tuple(caches))
    caches = ()
    if collect_caches:  # the scan's stacked outputs: (G, ...) per slot entry
        caches = tuple(tuple(torch.stack([pg[si][j] for pg in per_group])
                             for j in range(len(per_group[0][si])))
                       for si in range(len(slots)))
    return x, aux, caches


def _logits(x, params, cfg: ModelConfig):
    x = basic.apply_norm(x, params["final_norm"], cfg.norm_type)
    if cfg.tie_embeddings:
        return basic.unembed(x, params["embed"], cfg.cdtype)
    return x @ params["unembed"]["kernel"].to(cfg.cdtype)


def forward(params, cfg: ModelConfig, tokens, return_caches: bool = False):
    """tokens: (B, S) integer tensor on the parameters' device.

    Returns (logits (B, S, V), metrics[, caches]); caches hold each slot's
    (k, v), (G, B, S, kv_heads, head_dim), stacked over groups."""
    cd = cfg.cdtype
    _dense_only(cfg, layer_program(cfg)[0])
    x = basic.embed(tokens, params["embed"], cd)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if not cfg.use_rope:
        x = x + sinusoid_pos(positions, cfg.d_model, cd)
    x, aux, caches = _run_stack(params["layers"], cfg, x, positions,
                                collect_caches=return_caches)
    logits = _logits(x, params, cfg)
    metrics = {"moe_aux_loss": aux}
    if return_caches:
        return logits, metrics, caches
    return logits, metrics


# ---------------------------------------------------------------------------
# Loss


def lm_loss(logits, labels, mask=None):
    """Cross-entropy; labels: (B, S) integer, mask 1.0 where counted."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = lp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


# ---------------------------------------------------------------------------
# Decode (serving): single-token step against per-layer caches. RoPE is
# applied at absolute positions on write, so relative geometry survives
# the ring.


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window and cfg.sliding_window < max_len:
        return cfg.sliding_window
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Zero caches for decoding up to max_len tokens: a per-slot entry
    stacked over groups, plus ``cache_len`` (an int). On the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    cd = dtype or cfg.cdtype
    slots, G = layer_program(cfg)
    _dense_only(cfg, slots)
    S = cache_capacity(cfg, max_len)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    entries = {f"slot{i}": {
        "k": torch.zeros((G, batch, S, kvh, hd), dtype=cd, device=dev),
        "v": torch.zeros((G, batch, S, kvh, hd), dtype=cd, device=dev)}
        for i in range(len(slots))}
    return {"slots": entries, "cache_len": 0}


def _decode_slot(x, sp, cfg: ModelConfig, slot: Slot, cache, cache_len: int,
                 pos):
    """x: (B,1,d). Returns (x, new_cache); the cache is written in place."""
    cd = cfg.cdtype
    h = basic.apply_norm(x, sp["ln1"], cfg.norm_type)
    S = cache["k"].shape[1]
    widx = cache_len % S                       # ring write index
    cl_eff = min(cache_len + 1, S)
    q, k, v = attn_lib.qkv_project(h, sp["attn"], cfg)
    if cfg.use_rope:
        cos, sin = attn_lib.rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                       pos[None, :])
        q = attn_lib.apply_rope(q, cos, sin)
        k = attn_lib.apply_rope(k, cos, sin)
    cache["k"][:, widx:widx + 1] = k.to(cache["k"].dtype)
    cache["v"][:, widx:widx + 1] = v.to(cache["v"].dtype)
    o = attn_lib.decode_attention(q, cache["k"], cache["v"], cl_eff,
                                  cfg.with_(sliding_window=0))
    x = x + basic.dense(o.reshape(o.shape[0], 1, -1), sp["attn"]["wo"], cd)
    h2 = basic.apply_norm(x, sp["ln2"], cfg.norm_type)
    return x + basic.mlp(h2, sp["ffn"], cfg.act, cd), cache


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1) integer -> (logits (B, 1, V), new cache).

    The reference returns a new cache; this one writes the new token's K/V
    into the ring slots of ``cache`` in place (saving a copy of every
    layer's cache per token) and returns it with ``cache_len + 1``."""
    cd = cfg.cdtype
    slots, G = layer_program(cfg)
    _dense_only(cfg, slots)
    cache_len = int(cache["cache_len"])
    pos = torch.tensor([cache_len], device=tokens.device)
    x = basic.embed(tokens, params["embed"], cd)
    if not cfg.use_rope:
        x = x + sinusoid_pos(pos[None, :], cfg.d_model, cd)
    for g in range(G):
        gp = _group(params["layers"], g)
        for si, slot in enumerate(slots):
            key = f"slot{si}"
            gc = _group(cache["slots"][key], g)
            x, _ = _decode_slot(x, gp[key], cfg, slot, gc, cache_len, pos)
    return _logits(x, params, cfg), {**cache, "cache_len": cache_len + 1}
