"""The decoder LM, port of ``repro/models/decoder_lm.py``: the dense,
MoE, hybrid (Jamba), SSM (xLSTM), VLM (PaliGemma) and encoder-decoder
(Whisper) families, with GQA or MLA attention, Mamba, mLSTM and sLSTM
blocks (``nn/ssm.py``).

The layer stack is a *periodic program*: ``num_layers / period`` identical
groups of ``period`` slots. Each leaf of the stack is stacked over the
groups along a leading axis, as the reference's ``jax.vmap`` init stacks
it, and the forward pass loops over the groups where the reference
scans. Group g's leaves are drawn from ``fold_in(path_key(seed,
"<name>/stack"), g)`` (an encoder-decoder's decoder stack from
``"<name>/stack/dec"``, its encoder stack from ``"<name>/stack"``), so
they are the reference's bits.

KV caches: full-length buffers for global attention, or a ring buffer of
``sliding_window`` entries when the window is shorter than the cache
(Mistral-style rolling cache, the ``long_500k`` serving shape); MLA
caches the compressed (c_kv, k_pe) pair instead of K and V. Mamba,
mLSTM and sLSTM slots carry constant-size recurrent states (float32,
their conv windows in the compute dtype), which decode writes in place
as it writes K / V. The cache's ``cache_len`` is a Python int (the
decode loop is eager).

Attention slots (GQA, or MLA when ``cfg.use_mla``) and Mamba slots take a
dense or MoE (``nn/moe.py``) FFN after a second norm; mLSTM and sLSTM
blocks carry their own projections and have none.

The VLM projects ``prefix_embeds`` (B, P, 1152), the stubbed vision
tower's patch embeddings, through ``mm_proj`` and prepends them; every
attention layer sees the P prefix positions from every query (a
bidirectional prefix), and ``train_loss`` drops their logits. The
encoder-decoder runs ``encoder_embeds`` (B, E, d_model), the stubbed audio
frontend's frames, through a non-causal encoder stack (sinusoid
positions, no window) and ``enc_norm``; each decoder attention slot then
adds cross-attention (``ln_cross``, ``cross_attn``) from the decoder's
queries to the encoder's keys and values. Decode runs text only: the
VLM without a prefix, the encoder-decoder against the cache's ``cross``
K / V (zeros from ``init_cache``, the encoder's from
``build_cross_cache``).

Under tensor parallelism (``launch/mesh.tensor_parallel``, the train step
and prefill of ``launch/specs`` on a mesh) each rank holds its pieces of
the parameters, placed by the reference's rules: attention slots run
``nn/attention.tp_attention`` (MLA's ``tp_mla``) on the rank's heads, the
encoder's non-causal ones and the decoder's cross-attention too (k and v
from the encoder's output, which every rank holds whole), the VLM's
``mm_proj`` (which no rule splits) whole on every rank,
Mamba slots on the rank's channels and mLSTM slots with their
projections split and their cell whole (``nn/ssm``; the sLSTM whole on
every rank), the FFNs and experts their pieces
(``nn/basic.mlp``, ``nn/moe``), the embedding a masked lookup of the
rank's vocab rows, the logits the rank's vocab columns, and ``lm_loss``
the vocab-parallel cross-entropy; the (B, S, V) logits are never
gathered in training.

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
from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import basic, moe as moe_lib, ssm as ssm_lib, threefry


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


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``encoder_layers`` layers, no window."""
    return cfg.with_(num_layers=cfg.encoder_layers or cfg.num_layers,
                     sliding_window=0)


# ---------------------------------------------------------------------------
# Init

# the width of the stubbed vision tower's patch embeddings (SigLIP's), which
# the VLM's ``mm_proj`` takes to d_model
VISION_TOWER_DIM = 1152


def _init_slot(key, cfg: ModelConfig, slot: Slot, si: int, device=None,
               decoder_cross: bool = False):
    dt = cfg.pdtype
    path = f"layers/slot{si}"
    p = {"ln1": basic.init_norm(key, f"{path}/ln1", cfg.d_model, dt,
                                cfg.norm_type, device)}
    if slot.kind == ATTN:
        p["attn"] = (attn_lib.init_mla if cfg.use_mla else
                     attn_lib.init_attention)(key, f"{path}/attn", cfg, dt,
                                              device)
        if decoder_cross:
            p["ln_cross"] = basic.init_norm(key, f"{path}/ln_cross",
                                            cfg.d_model, dt, cfg.norm_type,
                                            device)
            p["cross_attn"] = attn_lib.init_attention(
                key, f"{path}/cross_attn", cfg, dt, device)
    else:
        init = {MAMBA: ssm_lib.init_mamba, MLSTM: ssm_lib.init_mlstm,
                SLSTM: ssm_lib.init_slstm}[slot.kind]
        p[slot.kind] = init(key, f"{path}/{slot.kind}", cfg, dt, device)
    if slot.kind not in (ATTN, MAMBA):  # the xLSTM cells have no FFN
        return p
    p["ln2"] = basic.init_norm(key, f"{path}/ln2", cfg.d_model, dt,
                               cfg.norm_type, device)
    if slot.use_moe:
        p["moe"] = moe_lib.init_moe(key, f"{path}/moe", cfg, dt, device)
    else:
        p["ffn"] = basic.init_mlp(key, f"{path}/ffn", cfg.d_model, cfg.d_ff,
                                  dt, gated=cfg.gated_mlp, device=device)
    return p


def _init_stack(seed, cfg: ModelConfig, device=None,
                decoder_cross: bool = False):
    """Each slot's tree, its leaves stacked over the groups: group g's
    leaves are drawn from ``fold_in(root, g)`` and copied into the stacked
    leaves at once, so that one group's tree is held beside the stack. An
    encoder-decoder's decoder stack (``decoder_cross``: attention slots
    with cross-attention) has the root ``"<name>/stack/dec"``."""
    slots, n_groups = layer_program(cfg)
    root = basic.path_key(seed, f"{cfg.name}/stack"
                          + ("/dec" if decoder_cross else ""))
    stacked = {}
    for g in range(n_groups):
        key = threefry.fold_in(root, g)
        for si, slot in enumerate(slots):
            tree = _init_slot(key, cfg, slot, si, device, decoder_cross)
            if g == 0:
                stacked[f"slot{si}"] = basic.tree_map(
                    lambda x: x.new_empty((n_groups,) + tuple(x.shape)), tree)
            basic.tree_map(lambda dst, src: dst[g].copy_(src),
                           stacked[f"slot{si}"], tree)
    return stacked


def init_model(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """The parameter tree, on the card unless ``device="cpu"``. The VLM
    adds ``mm_proj``; the encoder-decoder ``enc_layers`` and
    ``enc_norm``, its decoder stack drawn from its own root (the reference
    draws a plain decoder stack first and replaces it: the bits come from
    the ``/dec`` root alone, so that one is never made)."""
    dev = resolve_device(device)
    dt = cfg.pdtype
    p: Dict[str, Any] = {
        "embed": basic.init_embedding(seed, "embed", cfg.vocab_size,
                                      cfg.d_model, dt, dev),
        "final_norm": basic.init_norm(seed, "final_norm", cfg.d_model, dt,
                                      cfg.norm_type, dev),
        "layers": _init_stack(seed, cfg, dev,
                              decoder_cross=cfg.is_encoder_decoder),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"kernel": basic.normal_init(
            seed, "unembed/kernel", (cfg.d_model, cfg.vocab_size), dt,
            fan_in=cfg.d_model, device=dev)}
    if cfg.family == "vlm":
        p["mm_proj"] = basic.init_dense(seed, "mm_proj", VISION_TOWER_DIM,
                                        cfg.d_model, dt, bias=True,
                                        device=dev)
    if cfg.is_encoder_decoder:
        p["enc_layers"] = _init_stack(seed, _encoder_cfg(cfg), dev)
        p["enc_norm"] = basic.init_norm(seed, "enc_norm", cfg.d_model, dt,
                                        cfg.norm_type, dev)
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
        return basic.mlp(h2, sp["ffn"], cfg.act, cfg.cdtype,
                         d_ff=cfg.d_ff), None
    B, S, D = h2.shape
    y, aux = moe_lib.moe_ffn(h2.reshape(B * S, D), sp["moe"], cfg,
                             row_len=S)
    return y.reshape(B, S, D), aux


def _apply_slot(x, sp, cfg: ModelConfig, slot: Slot, positions, aux,
                attention, causal=True, encoder_out=None, prefix_len=0):
    """One residual block; ``attention`` is ``flash_attention`` or
    ``chunked_attention``. A decoder slot with ``cross_attn`` attends to
    ``encoder_out`` after its self-attention. Returns (x, aux,
    cache_entry): an attention slot's (k, v) or MLA's (c_kv, k_pe),
    Mamba's (h, conv tail), the mLSTM's (C, n), the sLSTM's (c, n, h,
    m)."""
    h = basic.apply_norm(x, sp["ln1"], cfg.norm_type)
    if slot.kind == MLSTM:
        o, cache = ssm_lib.mlstm_forward(h, sp["mlstm"], cfg)
        return x + o, aux, cache
    if slot.kind == SLSTM:      # no rule splits the sLSTM: whole on every rank
        o, cache = ssm_lib.slstm_forward(h, sp["slstm"], cfg)
        return x + o, aux, cache
    if slot.kind == MAMBA:
        o, cache = ssm_lib.mamba_forward(h, sp["mamba"], cfg)
        x = x + o
    else:
        x, cache = _attend(x, h, sp, cfg, positions, attention, causal,
                           prefix_len)
        if "cross_attn" in sp and encoder_out is not None:
            x = x + _cross_attend(x, encoder_out, sp, cfg, attention)
    h2 = basic.apply_norm(x, sp["ln2"], cfg.norm_type)
    y, aux_l = _ffn(h2, sp, cfg, slot)
    if aux_l is not None:
        aux = aux + aux_l
    return x + y, aux, cache


def _attend(x, h, sp, cfg: ModelConfig, positions, attention, causal=True,
            prefix_len=0):
    """The attention half of an attention slot: (x + attention output,
    the cache entry)."""
    cd = cfg.cdtype
    if cfg.use_mla and attn_lib.mla_heads_split(sp["attn"], cfg):
        o, cache = attn_lib.tp_mla(h, sp["attn"], cfg, positions, attention,
                                   causal, prefix_len)
        return x + o, cache
    if cfg.use_mla:
        q, k, v, cache = attn_lib.mla_qkv(h, sp["attn"], cfg, positions)
        o = attention(q, k, v, cfg.with_(sliding_window=0), causal=causal,
                      prefix_len=prefix_len)
    elif attn_lib.heads_split(sp["attn"], cfg):
        o, cache = attn_lib.tp_attention(h, sp["attn"], cfg, positions,
                                         attention, causal, prefix_len)
        return x + o, cache
    else:
        q, k, v = attn_lib.qkv_project(h, sp["attn"], cfg)
        if cfg.use_rope:
            cos, sin = attn_lib.rope_freqs(cfg.resolved_head_dim,
                                           cfg.rope_theta, positions)
            q = attn_lib.apply_rope(q, cos, sin)
            k = attn_lib.apply_rope(k, cos, sin)
        o = attention(q, k, v, cfg, causal=causal, prefix_len=prefix_len)
        cache = (k, v)
    del q, k, v
    o = basic.dense(o.flatten(2), sp["attn"]["wo"], cd)
    return x + o, cache


def _cross_kv(enc, p, cfg: ModelConfig):
    """Cross-attention's k and v (b, e, kv_heads, hd) of the encoder's
    output (the k / v half of ``qkv_project``)."""
    b, e, _ = enc.shape
    shape = (b, e, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (basic.dense(enc, p["wk"], cfg.cdtype).reshape(shape),
            basic.dense(enc, p["wv"], cfg.cdtype).reshape(shape))


def _cross_q(x, sp, cfg: ModelConfig):
    """Cross-attention's q (b, s, heads, hd) from the decoder's x, normed
    by ``ln_cross`` (the q half of ``qkv_project``)."""
    b, s, _ = x.shape
    hc = basic.apply_norm(x, sp["ln_cross"], cfg.norm_type)
    return basic.dense(hc, sp["cross_attn"]["wq"], cfg.cdtype).reshape(
        b, s, cfg.num_heads, cfg.resolved_head_dim)


def _cross_attend(x, encoder_out, sp, cfg: ModelConfig, attention):
    """The cross-attention output of a decoder slot: its queries against
    the encoder's keys, non-causal, no window. Under tensor parallelism
    with its heads split, ``tp_attention`` on this rank's heads: q from
    ``ln_cross(x)``, k and v from the encoder's output (replicated on
    "model", entering through ``tp_copy`` once a layer), no RoPE, ``wo``
    row-parallel."""
    c = cfg.with_(sliding_window=0)
    if attn_lib.heads_split(sp["cross_attn"], cfg):
        hc = basic.apply_norm(x, sp["ln_cross"], cfg.norm_type)
        return attn_lib.tp_attention(hc, sp["cross_attn"], c, None,
                                     attention, causal=False,
                                     kv=encoder_out)[0]
    kc, vc = _cross_kv(encoder_out, sp["cross_attn"], cfg)
    oc = attention(_cross_q(x, sp, cfg), kc, vc, c, causal=False)
    return basic.dense(oc.flatten(2),
                       sp["cross_attn"]["wo"], cfg.cdtype)


def _group(tree, g: int):
    return basic.tree_map(lambda x: x[g], tree)


def _run_stack(stack_params, cfg: ModelConfig, x, positions, attention,
               collect_caches=False, causal=True, encoder_out=None,
               prefix_len=0):
    slots, n_groups = layer_program(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_group = []
    for g in range(n_groups):
        gp = _group(stack_params, g)
        caches = []
        for si, slot in enumerate(slots):
            x, aux, c = _apply_slot(x, gp[f"slot{si}"], cfg, slot, positions,
                                    aux, attention, causal, encoder_out,
                                    prefix_len)
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
    """The logits (B, S, V); under tensor parallelism with the vocab
    split on "model", this rank's vocab columns of them."""
    x = basic.apply_norm(x, params["final_norm"], cfg.norm_type)
    if cfg.tie_embeddings:
        return basic.unembed(x, params["embed"], cfg.cdtype,
                             vocab=cfg.vocab_size)
    kernel = params["unembed"]["kernel"]
    if mesh_lib.current_tp() is not None \
            and kernel.shape[-1] != cfg.vocab_size:
        x = mesh_lib.tp_copy(x)
    return x @ kernel.to(cfg.cdtype)


def encode(params, cfg: ModelConfig, encoder_embeds, attention=None):
    """The encoder-decoder's encoder output (B, E, d_model) in the compute
    dtype: ``encoder_embeds`` (B, E, d_model) plus sinusoid positions
    through the non-causal encoder stack (no window) and ``enc_norm``."""
    cd = cfg.cdtype
    attention = attention or attn_lib.flash_attention
    pos = torch.arange(encoder_embeds.shape[1],
                       device=encoder_embeds.device)[None, :]
    x = encoder_embeds.to(cd)
    if not cfg.use_rope:
        x = x + sinusoid_pos(pos, cfg.d_model, cd)
    x = _run_stack(params["enc_layers"], _encoder_cfg(cfg), x, pos,
                   attention, causal=False)[0]
    return basic.apply_norm(x, params["enc_norm"], cfg.norm_type)


def forward(params, cfg: ModelConfig, tokens, return_caches: bool = False,
            attention=None, prefix_embeds=None, encoder_embeds=None):
    """tokens: (B, S) integer tensor on the parameters' device.
    ``prefix_embeds`` (B, P, 1152): the VLM's stubbed vision input,
    projected and prepended (the logits then cover P + S positions);
    ``encoder_embeds`` (B, E, d_model): the encoder-decoder's stubbed
    audio frames, encoded for the decoder's cross-attention. Without them
    the VLM runs text only and the decoder without cross-attention, as in
    the reference.

    ``attention``: the attention function of every layer, with
    ``flash_attention``'s signature; None is ``nn/attention.flash_attention``
    (the kernel on the card, the serving prefill's). Returns (logits (B,
    S, V), metrics[, caches]); metrics' ``moe_aux_loss`` (float32) sums
    the MoE layers' aux losses; caches hold each slot's entry stacked over
    groups: an attention slot's (k, v), (G, B, S, kv_heads, head_dim), or
    with MLA its (c_kv (G, B, S, kv_lora_rank), k_pe (G, B, S,
    qk_rope_head_dim)); Mamba's (h (G, B, d_inner, d_state) float32, the
    pre-conv tail (G, B, d_conv - 1, d_inner)); the mLSTM's (C (G, B, nh,
    dh, dh), n (G, B, nh, dh)); the sLSTM's (c, n, h, m), each (G, B, nh,
    dh), all float32."""
    cd = cfg.cdtype
    attention = attention or attn_lib.flash_attention
    x = basic.embed(tokens, params["embed"], cd, vocab=cfg.vocab_size)
    prefix_len = 0
    if cfg.family == "vlm" and prefix_embeds is not None:
        pe = basic.dense(prefix_embeds.to(cd), params["mm_proj"], cd)
        x = torch.cat([pe, x], dim=1)
        prefix_len = pe.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if not cfg.use_rope:
        x = x + sinusoid_pos(positions, cfg.d_model, cd)
    encoder_out = None
    if cfg.is_encoder_decoder and encoder_embeds is not None:
        encoder_out = encode(params, cfg, encoder_embeds, attention)
    x, aux, caches = _run_stack(params["layers"], cfg, x, positions,
                                attention, collect_caches=return_caches,
                                encoder_out=encoder_out,
                                prefix_len=prefix_len)
    logits = _logits(x, params, cfg)
    metrics = {"moe_aux_loss": aux}
    if return_caches:
        return logits, metrics, caches
    return logits, metrics


# ---------------------------------------------------------------------------
# Loss


def _vocab_parallel_ll(logits, labels, tp):
    """Each position's log-likelihood of its label from this rank's vocab
    columns of the logits: the max, the sum of exponentials and the
    label's logit summed over the "model" ranks (float32); the (B, S, V)
    logits are never gathered."""
    lf = logits.float()
    n = lf.shape[-1]
    m = mesh_lib.tp_max(lf.amax(-1))
    s = mesh_lib.tp_reduce(torch.exp(lf - m[..., None]).sum(-1))
    local = labels.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    t = lf.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    t = mesh_lib.tp_reduce(torch.where(inside, t, 0.0))
    return t - m - torch.log(s)


def lm_loss(logits, labels, mask=None, vocab: int = 0):
    """Cross-entropy; labels: (B, S) integer, mask 1.0 where counted.
    Under tensor parallelism, logits holding this rank's columns of a
    ``vocab``-wide vocab give the vocab-parallel cross-entropy."""
    tp = mesh_lib.current_tp()
    if tp is not None and vocab and logits.shape[-1] != vocab:
        ll = _vocab_parallel_ll(logits, labels, tp)
    else:
        lp = torch.log_softmax(logits.float(), dim=-1)
        ll = lp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def train_loss(params, cfg: ModelConfig, batch):
    """The shifted next-token cross-entropy of ``batch["tokens"]``
    against ``batch["labels"]`` (optional ``batch["mask"]``), plus
    ``router_aux_loss`` times the MoE aux loss. Returns (loss, metrics).
    The VLM takes ``batch["prefix_embeds"]`` and drops the prefix's
    logits; the encoder-decoder takes ``batch["encoder_embeds"]``.

    The forward runs ``nn/attention.chunked_attention``, the reference's
    chunked scan, on every device: the round engine takes its gradient
    under ``torch.func.vmap``, which the attention kernel does not
    support."""
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if cfg.is_encoder_decoder:
        kw["encoder_embeds"] = batch["encoder_embeds"]
    logits, metrics = forward(params, cfg, batch["tokens"],
                              attention=attn_lib.chunked_attention, **kw)
    if cfg.family == "vlm":   # the logits cover prefix + text
        logits = logits[:, kw["prefix_embeds"].shape[1]:]
    mask = batch.get("mask", None)
    if mask is not None:
        mask = mask[:, 1:].float()
    loss = lm_loss(logits[:, :-1, :], batch["labels"][:, 1:], mask,
                   vocab=cfg.vocab_size)
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
    stacked over groups, plus ``cache_len`` (an int). Attention slots hold
    K / V (or MLA's c_kv / k_pe) in ``dtype`` (default the compute
    dtype); Mamba slots h (G, B, d_inner, d_state) and the conv window
    (G, B, d_conv - 1, d_inner); mLSTM slots C, n and the conv window (G,
    B, 3, d_in); sLSTM slots c, n, h, m (m = -30) and the conv window (G,
    B, 3, d_model): the states float32, the windows in ``dtype``. An
    encoder-decoder's cache adds ``cross``: zero K / V (G, B,
    encoder_seq_len, kv_heads, head_dim) a decoder attention slot, which
    :func:`build_cross_cache` fills. On the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    cd = dtype or cfg.cdtype
    f32 = torch.float32
    slots, G = layer_program(cfg)
    S = cache_capacity(cfg, max_len)
    d_in_x, nh_x, dh_x = ssm_lib.xlstm_dims(cfg)
    di, _ = ssm_lib.mamba_dims(cfg)
    nh, dh = cfg.num_heads, cfg.d_model // cfg.num_heads

    def zeros(*shape, dt=cd):
        return torch.zeros((G, batch) + shape, dtype=dt, device=dev)
    entries = {}
    for i, slot in enumerate(slots):
        if slot.kind == ATTN and cfg.use_mla:
            e = {"ckv": zeros(S, cfg.kv_lora_rank),
                 "kpe": zeros(S, cfg.qk_rope_head_dim)}
        elif slot.kind == ATTN:
            kv = (S, cfg.num_kv_heads, cfg.resolved_head_dim)
            e = {"k": zeros(*kv), "v": zeros(*kv)}
        elif slot.kind == MAMBA:
            e = {"h": zeros(di, cfg.mamba_d_state, dt=f32),
                 "conv": zeros(cfg.mamba_d_conv - 1, di)}
        elif slot.kind == MLSTM:
            e = {"C": zeros(nh_x, dh_x, dh_x, dt=f32),
                 "n": zeros(nh_x, dh_x, dt=f32), "conv": zeros(3, d_in_x)}
        else:
            e = {name: zeros(nh, dh, dt=f32) for name in "cnh"}
            e["m"] = zeros(nh, dh, dt=f32) - 30.0
            e["conv"] = zeros(3, cfg.d_model)
        entries[f"slot{i}"] = e
    cache = {"slots": entries, "cache_len": 0}
    if cfg.is_encoder_decoder:
        kv = (cfg.encoder_seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = {f"slot{i}": {"k": zeros(*kv), "v": zeros(*kv)}
                          for i, slot in enumerate(slots)
                          if slot.kind == ATTN}
    return cache


def build_cross_cache(params, cfg: ModelConfig, encoder_embeds,
                      attention=None):
    """The encoder's K / V for every decoder cross-attention slot, the
    ``cross`` entry of the cache: {slot: {"k", "v"}}, each (G, B, E,
    kv_heads, head_dim) in the compute dtype, from :func:`encode` of
    ``encoder_embeds`` (B, E, d_model)."""
    enc = encode(params, cfg, encoder_embeds, attention)
    slots, G = layer_program(cfg)
    out = {}
    for i, slot in enumerate(slots):
        if slot.kind != ATTN:
            continue
        stack = params["layers"][f"slot{i}"]["cross_attn"]
        entry = None
        for g in range(G):
            k, v = _cross_kv(enc, _group(stack, g), cfg)
            if entry is None:
                entry = {name: t.new_empty((G,) + tuple(t.shape))
                         for name, t in (("k", k), ("v", v))}
            entry["k"][g].copy_(k)
            entry["v"][g].copy_(v)
        out[f"slot{i}"] = entry
    return out


def _write(cache, new):
    """Write a recurrent slot's new state into its cache in place."""
    for name, t in new.items():
        cache[name].copy_(t)


def _decode_slot(x, sp, cfg: ModelConfig, slot: Slot, cache, cache_len: int,
                 pos, cross=None):
    """x: (B,1,d); ``cross``: the slot's cross-attention K / V, if any.
    Returns (x, new_cache); the cache is written in place."""
    h = basic.apply_norm(x, sp["ln1"], cfg.norm_type)
    if slot.kind == MLSTM:
        o, (C, n, conv) = ssm_lib.mlstm_step(
            h[:, 0], sp["mlstm"], cfg, (cache["C"], cache["n"], cache["conv"]))
        _write(cache, {"C": C, "n": n, "conv": conv})
        return x + o[:, None, :], cache
    if slot.kind == SLSTM:
        cell = tuple(cache[name] for name in "cnhm")
        o, (cell, conv) = ssm_lib.slstm_step(h[:, 0], sp["slstm"], cfg,
                                             (cell, cache["conv"]))
        _write(cache, dict(zip("cnhm", cell), conv=conv))
        return x + o[:, None, :], cache
    if slot.kind == MAMBA:
        o, (hh, conv) = ssm_lib.mamba_step(h[:, 0], sp["mamba"], cfg,
                                           (cache["h"], cache["conv"]))
        _write(cache, {"h": hh, "conv": conv})
        x = x + o[:, None, :]
    else:
        x = x + _decode_attend(h, sp, cfg, cache, cache_len, pos)
        if cross is not None and "cross_attn" in sp:
            oc = attn_lib.decode_attention(
                _cross_q(x, sp, cfg), cross["k"], cross["v"],
                cross["k"].shape[1], cfg.with_(sliding_window=0))
            x = x + basic.dense(oc.flatten(2),
                                sp["cross_attn"]["wo"], cfg.cdtype)
    h2 = basic.apply_norm(x, sp["ln2"], cfg.norm_type)
    return x + _ffn(h2, sp, cfg, slot)[0], cache


def _decode_attend(h, sp, cfg: ModelConfig, cache, cache_len: int, pos):
    """An attention slot's decode output for the normed x ``h`` (B, 1,
    d), its K / V (or c_kv / k_pe) written into the ring in place."""
    cd = cfg.cdtype
    S = cache["ckv" if cfg.use_mla else "k"].shape[1]
    widx = cache_len % S                       # ring write index
    cl_eff = min(cache_len + 1, S)
    if cfg.use_mla:
        ckv, kpe = attn_lib.mla_compress(h, sp["attn"], cfg, pos[None, :])
        cache["ckv"][:, widx:widx + 1] = ckv.to(cache["ckv"].dtype)
        cache["kpe"][:, widx:widx + 1] = kpe.to(cache["kpe"].dtype)
        return attn_lib.mla_decode(h, sp["attn"], cfg, cache["ckv"],
                                   cache["kpe"], cl_eff)
    q, k, v = attn_lib.qkv_project(h, sp["attn"], cfg)
    if cfg.use_rope:
        cos, sin = attn_lib.rope_freqs(cfg.resolved_head_dim,
                                       cfg.rope_theta, pos[None, :])
        q = attn_lib.apply_rope(q, cos, sin)
        k = attn_lib.apply_rope(k, cos, sin)
    cache["k"][:, widx:widx + 1] = k.to(cache["k"].dtype)
    cache["v"][:, widx:widx + 1] = v.to(cache["v"].dtype)
    o = attn_lib.decode_attention(q, cache["k"], cache["v"], cl_eff,
                                  cfg.with_(sliding_window=0))
    return basic.dense(o.flatten(2), sp["attn"]["wo"], cd)


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1) integer -> (logits (B, 1, V), new cache); an
    encoder-decoder's decoder slots attend to the cache's ``cross`` K / V.

    The reference returns a new cache; this one writes the new token's K/V
    into the ring slots of ``cache``, and the recurrent slots' new states
    over their old ones, in place (saving a copy of every layer's cache
    per token) and returns it with ``cache_len + 1``."""
    cd = cfg.cdtype
    slots, G = layer_program(cfg)
    cache_len = int(cache["cache_len"])
    pos = torch.tensor([cache_len], device=tokens.device)
    x = basic.embed(tokens, params["embed"], cd)
    if not cfg.use_rope:
        x = x + sinusoid_pos(pos[None, :], cfg.d_model, cd)
    cross = cache.get("cross") or {}
    for g in range(G):
        gp = _group(params["layers"], g)
        for si, slot in enumerate(slots):
            key = f"slot{si}"
            gc = _group(cache["slots"][key], g)
            cr = _group(cross[key], g) if key in cross else None
            x, _ = _decode_slot(x, gp[key], cfg, slot, gc, cache_len, pos,
                                cr)
    return _logits(x, params, cfg), {**cache, "cache_len": cache_len + 1}
