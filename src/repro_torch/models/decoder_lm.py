"""Decoder-only LM, port of the dense and MoE families of
``repro/models/decoder_lm.py``.

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

Attention slots with a dense or MoE (``nn/moe.py``) FFN. Mamba, xLSTM,
MLA, VLM and encoder-decoder stacks raise ``NotImplementedError`` until
the slices that port ``nn/ssm.py``, MLA, the VLM prefix and the
encoder-decoder stack.

``forward`` takes the attention function explicitly: the serving prefill
runs ``nn/attention.flash_attention`` (the ``swa_attention`` kernel on
the card), while ``train_loss`` passes ``nn/attention.chunked_attention``,
the reference's own chunked scan, which ``torch.func.vmap`` and ``grad``
can trace (the kernel has no backward, as the TPU kernel has none).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import basic, moe as moe_lib, threefry


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


def _refuse_mla_ssm_vlm_encdec(cfg: ModelConfig, slots) -> None:
    """Raise for the stacks not ported yet: MLA, SSM slots, the VLM prefix
    and the encoder-decoder stack."""
    if cfg.family == "vlm" or cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} stack is "
                                  f"not ported yet")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA is not ported yet")
    for slot in slots:
        if slot.kind != ATTN:
            raise NotImplementedError(f"{cfg.name}: {slot.kind} slots "
                                      f"(nn/ssm.py) are not ported yet")


# ---------------------------------------------------------------------------
# Init


def _init_slot(key, cfg: ModelConfig, slot: Slot, si: int, device=None):
    dt = cfg.pdtype
    path = f"layers/slot{si}"
    p = {
        "ln1": basic.init_norm(key, f"{path}/ln1", cfg.d_model, dt,
                               cfg.norm_type, device),
        "attn": attn_lib.init_attention(key, f"{path}/attn", cfg, dt, device),
        "ln2": basic.init_norm(key, f"{path}/ln2", cfg.d_model, dt,
                               cfg.norm_type, device),
    }
    if slot.use_moe:
        p["moe"] = moe_lib.init_moe(key, f"{path}/moe", cfg, dt, device)
    else:
        p["ffn"] = basic.init_mlp(key, f"{path}/ffn", cfg.d_model, cfg.d_ff,
                                  dt, gated=cfg.gated_mlp, device=device)
    return p


def _init_stack(seed, cfg: ModelConfig, device=None):
    """Each slot's tree, its leaves stacked over the groups: group g's
    leaves are drawn from ``fold_in(root, g)`` and copied into the stacked
    leaves at once, so that one group's tree is held beside the stack."""
    slots, n_groups = layer_program(cfg)
    root = basic.path_key(seed, f"{cfg.name}/stack")
    stacked = {}
    for g in range(n_groups):
        key = threefry.fold_in(root, g)
        for si, slot in enumerate(slots):
            tree = _init_slot(key, cfg, slot, si, device)
            if g == 0:
                stacked[f"slot{si}"] = basic.tree_map(
                    lambda x: x.new_empty((n_groups,) + tuple(x.shape)), tree)
            basic.tree_map(lambda dst, src: dst[g].copy_(src),
                           stacked[f"slot{si}"], tree)
    return stacked


def init_model(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """The parameter tree, on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    _refuse_mla_ssm_vlm_encdec(cfg, layer_program(cfg)[0])
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


def _ffn(h2, sp, cfg: ModelConfig, slot: Slot):
    """The slot's FFN on (B, S, d): the gated MLP, or ``moe_ffn`` on the
    (B*S, d) tokens. Returns (y, the MoE aux loss or None)."""
    if not slot.use_moe:
        return basic.mlp(h2, sp["ffn"], cfg.act, cfg.cdtype), None
    B, S, D = h2.shape
    y, aux = moe_lib.moe_ffn(h2.reshape(B * S, D), sp["moe"], cfg)
    return y.reshape(B, S, D), aux


def _apply_slot(x, sp, cfg: ModelConfig, slot: Slot, positions, aux,
                attention):
    """One residual block; ``attention`` is ``flash_attention`` or
    ``chunked_attention``. Returns (x, aux, cache_entry)."""
    cd = cfg.cdtype
    h = basic.apply_norm(x, sp["ln1"], cfg.norm_type)
    q, k, v = attn_lib.qkv_project(h, sp["attn"], cfg)
    if cfg.use_rope:
        cos, sin = attn_lib.rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                                       positions)
        q = attn_lib.apply_rope(q, cos, sin)
        k = attn_lib.apply_rope(k, cos, sin)
    o = attention(q, k, v, cfg)
    o = basic.dense(o.reshape(o.shape[0], o.shape[1], -1), sp["attn"]["wo"], cd)
    x = x + o
    h2 = basic.apply_norm(x, sp["ln2"], cfg.norm_type)
    y, aux_l = _ffn(h2, sp, cfg, slot)
    if aux_l is not None:
        aux = aux + aux_l
    return x + y, aux, (k, v)


def _group(tree, g: int):
    return basic.tree_map(lambda x: x[g], tree)


def _run_stack(stack_params, cfg: ModelConfig, x, positions, attention,
               collect_caches=False):
    slots, n_groups = layer_program(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_group = []
    for g in range(n_groups):
        gp = _group(stack_params, g)
        caches = []
        for si, slot in enumerate(slots):
            x, aux, c = _apply_slot(x, gp[f"slot{si}"], cfg, slot, positions,
                                    aux, attention)
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


def forward(params, cfg: ModelConfig, tokens, return_caches: bool = False,
            attention=None):
    """tokens: (B, S) integer tensor on the parameters' device.

    ``attention``: the attention function of every layer, with
    ``flash_attention``'s signature; None is ``nn/attention.flash_attention``
    (the kernel on the card, the serving prefill's). Returns (logits (B,
    S, V), metrics[, caches]); metrics' ``moe_aux_loss`` (float32) sums
    the MoE layers' aux losses; caches hold each slot's (k, v), (G, B, S,
    kv_heads, head_dim), stacked over groups."""
    cd = cfg.cdtype
    attention = attention or attn_lib.flash_attention
    _refuse_mla_ssm_vlm_encdec(cfg, layer_program(cfg)[0])
    x = basic.embed(tokens, params["embed"], cd)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if not cfg.use_rope:
        x = x + sinusoid_pos(positions, cfg.d_model, cd)
    x, aux, caches = _run_stack(params["layers"], cfg, x, positions,
                                attention, collect_caches=return_caches)
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


def train_loss(params, cfg: ModelConfig, batch):
    """The shifted next-token cross-entropy of ``batch["tokens"]``
    against ``batch["labels"]`` (optional ``batch["mask"]``), plus
    ``router_aux_loss`` times the MoE aux loss. Returns (loss, metrics).

    The forward runs ``nn/attention.chunked_attention``, the reference's
    chunked scan, on every device: the round engine takes its gradient
    under ``torch.func.vmap``, which the attention kernel does not
    support. The VLM and encoder-decoder stacks raise in
    :func:`forward`."""
    logits, metrics = forward(params, cfg, batch["tokens"],
                              attention=attn_lib.chunked_attention)
    mask = batch.get("mask", None)
    if mask is not None:
        mask = mask[:, 1:].float()
    loss = lm_loss(logits[:, :-1, :], batch["labels"][:, 1:], mask)
    if cfg.router_aux_loss and cfg.num_experts:
        loss = loss + cfg.router_aux_loss * metrics["moe_aux_loss"]
    return loss, metrics


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
    _refuse_mla_ssm_vlm_encdec(cfg, slots)
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
    return x + _ffn(h2, sp, cfg, slot)[0], cache


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1) integer -> (logits (B, 1, V), new cache).

    The reference returns a new cache; this one writes the new token's K/V
    into the ring slots of ``cache`` in place (saving a copy of every
    layer's cache per token) and returns it with ``cache_len + 1``."""
    cd = cfg.cdtype
    slots, G = layer_program(cfg)
    _refuse_mla_ssm_vlm_encdec(cfg, slots)
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
