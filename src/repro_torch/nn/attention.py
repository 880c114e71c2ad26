"""Attention, port of ``repro/nn/attention.py``: RoPE, the q/k/v
projections, causal (optionally sliding-window) attention for prefill,
single-token decode against a KV cache, and MLA (DeepSeek-V2's
multi-head latent attention).

``flash_attention`` on a CUDA tensor is the hand-written sliding-window
flash-attention kernel (``kernels/ops.swa_attention``, the port of the
TPU's ``kernels/swa_attention.py``), which skips the KV tiles outside the
window instead of masking them, in the mode that rounds ``p`` as the
reference does. On a CPU tensor it is the reference's chunked online
softmax: KV chunks of 512, f32 scores and running (max, sum, acc), ``p``
cast to v's dtype before the PV product.
``decode_attention`` stays plain torch, as the JAX package computes it
outside any Pallas kernel. ``tp_attention`` is a GQA slot's attention
(self- or cross-attention) on one rank's heads under tensor parallelism
(``launch/mesh.tensor_parallel``), ``tp_mla`` an MLA slot's.

MLA compresses K and V into a ``kv_lora_rank`` latent c_kv plus one
shared rope key k_pe. Prefill expands them to 128 heads of 192-wide q / k
and 128-wide v (``mla_qkv``), which ``flash_attention`` takes to the
kernel with its two head dims; decode caches only (c_kv, k_pe), 576
values a token, and scores in the latent space (``mla_decode``, W_UK
folded into q, W_UV applied after the attention). The projections and the
absorbed einsums are plain torch, as the reference leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import basic

NEG_INF = -1e30


def _scale(head_dim: int) -> float:
    """``1 / sqrt(hd)`` as JAX computes it: a float32 sqrt, then a float32
    division."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float, positions):
    """positions: (..., seq) int -> cos/sin (..., seq, head_dim//2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)  # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# GQA projections


def init_attention(seed, path, cfg: ModelConfig, dtype, device=None):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b = cfg.qkv_bias
    return {
        "wq": basic.init_dense(seed, f"{path}/wq", d, h * hd, dtype, bias=b,
                               device=device),
        "wk": basic.init_dense(seed, f"{path}/wk", d, kv * hd, dtype, bias=b,
                               device=device),
        "wv": basic.init_dense(seed, f"{path}/wv", d, kv * hd, dtype, bias=b,
                               device=device),
        "wo": basic.init_dense(seed, f"{path}/wo", h * hd, d, dtype,
                               bias=False, device=device),
    }


def qkv_project(x, p, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cd = cfg.cdtype
    q = basic.dense(x, p["wq"], cd).reshape(b, s, h, hd)
    k = basic.dense(x, p["wk"], cd).reshape(b, s, kv, hd)
    v = basic.dense(x, p["wv"], cd).reshape(b, s, kv, hd)
    return q, k, v


def heads_split(p, cfg: ModelConfig) -> bool:
    """True when ``p``'s q projection holds only this rank's columns
    under the ambient tensor-parallel group (``launch/mesh.tensor_parallel``)."""
    return (mesh_lib.current_tp() is not None and p["wq"]["kernel"].shape[-1]
            != cfg.num_heads * cfg.resolved_head_dim)


def _heads_of(local, c0: int, lo: int, hi: int, hd: int):
    """Heads [lo, hi) of a projection of which this rank holds the
    columns from ``c0`` (``local``, (b, s, width)): the local columns when
    they are exactly those heads, else the ranks' pieces gathered over
    "model" and the heads taken (through ``tp_copy``: the rank uses its
    heads of a whole tensor, so the gradient is summed over the ranks
    before each keeps its piece)."""
    if c0 == lo * hd and local.shape[-1] == (hi - lo) * hd:
        return local
    whole = mesh_lib.tp_copy(mesh_lib.tp_gather(local, -1))
    return whole[..., lo * hd:hi * hd]


def tp_attention(h, p, cfg: ModelConfig, positions, attention, causal=True,
                 prefix_len: int = 0, kv=None):
    """GQA attention on this rank's heads, under the ambient tensor-
    parallel group, with ``wq`` / ``wk`` / ``wv`` (and their biases)
    column-parallel and ``wo`` row-parallel, as ``launch/sharding``'s rules
    place them: returns (the slot's attention output, summed over the
    "model" ranks, (k, v) of the heads this rank ran).

    ``kv``: where k and v come from, when not from ``h`` (the
    encoder-decoder's cross-attention: the encoder's output (b, e, d),
    replicated on "model", against the decoder's normed queries);
    ``positions`` None: no RoPE (cross-attention has none).

    The rules split only on whole columns, so a piece may end inside a
    head (Mixtral's 8 kv heads on a 16-wide axis: half a head a rank;
    Whisper's 20 heads: 1.25 a rank). Then the projection's pieces are
    gathered over "model" and the rank takes the heads it needs: the q
    heads that ``wo``'s rows on this rank read, and the kv heads those q
    heads use. Each replicated input enters the rank-local work through
    ``tp_copy`` once a call, so its gradient is summed over the ranks
    once: ``h``, and ``kv`` where given (one ``tp_copy`` a decoder layer
    for the encoder's output, which every layer reads); a kv projection
    the rules replicate is computed whole from the un-copied input and
    enters through ``tp_copy`` itself."""
    tp = mesh_lib.current_tp()
    b, s, _ = h.shape
    src = h if kv is None else kv
    skv = src.shape[1]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cd = cfg.cdtype
    rep = nh // nkv
    kw = nkv * hd
    q0 = tp.rank * p["wq"]["kernel"].shape[-1]
    q1 = q0 + p["wq"]["kernel"].shape[-1]
    lo, hi = q0 // hd, -(-q1 // hd)          # the q heads wo's rows read
    klo, khi = lo // rep, (hi - 1) // rep + 1
    hc = mesh_lib.tp_copy(h)
    sc = hc if kv is None else mesh_lib.tp_copy(kv)
    q = _heads_of(basic.dense(hc, p["wq"], cd), q0, lo, hi,
                  hd).reshape(b, s, hi - lo, hd)
    kvs = []
    for name in ("wk", "wv"):
        width = p[name]["kernel"].shape[-1]
        if width == kw:     # replicated by the rules' guard
            t = mesh_lib.tp_copy(basic.dense(src, p[name], cd))
            t = t[..., klo * hd:khi * hd]
        else:
            t = _heads_of(basic.dense(sc, p[name], cd), tp.rank * width,
                          klo, khi, hd)
        kvs.append(t.reshape(b, skv, khi - klo, hd))
    k, v = kvs
    nq, nk = hi - lo, khi - klo
    need = [g // rep - klo for g in range(lo, hi)]
    if nq % nk or need != [i // (nq // nk) for i in range(nq)]:
        # the local q heads do not map onto the kv heads in GQA's order:
        # one kv head a q head
        idx = torch.tensor(need, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    if cfg.use_rope and positions is not None:
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = attention(q, k, v, cfg, causal=causal, prefix_len=prefix_len)
    # the width named, not -1: a data rank with no rows has b = 0
    o = o.reshape(b, s, nq * hd)[..., q0 - lo * hd:q1 - lo * hd]
    return basic.row_parallel(o, p["wo"], cd), (k, v)


# ---------------------------------------------------------------------------
# Causal (optionally sliding-window) attention


def chunked_attention(q, k, v, cfg: ModelConfig, q_offset=0, chunk: int = 512,
                      causal: bool = True, prefix_len: int = 0):
    """The reference's ``flash_attention`` in plain torch: a loop over KV
    chunks carrying the online-softmax (max, sum, acc), p cast to v's
    dtype before the PV product (``kernels/ref.chunked_attention_ref`` on
    the (b, h, s, d) views). Same arguments and layout as
    :func:`flash_attention`; the window applies only to causal calls, as
    in the reference."""
    out = ref.chunked_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=cfg.sliding_window if causal else 0, causal=causal,
        chunk=chunk, softcap=cfg.attn_logit_softcap, prefix_len=prefix_len,
        q_offset=q_offset)
    return out.transpose(1, 2)


def flash_attention(q, k, v, cfg: ModelConfig, q_offset=0, chunk: int = 512,
                    causal: bool = True, prefix_len: int = 0):
    """Causal (optionally sliding-window, ``cfg.sliding_window``) attention.

    q: (b, sq, h, hd); k: (b, skv, kv_heads, hd); v: (b, skv, kv_heads,
    dv), whose head dim may differ from q's (MLA). q_offset: position of
    q[0] relative to k[0]; ``prefix_len``: keys visible from every query
    under the causal mask (the VLM's bidirectional prefix); ``causal=False``
    sees every key, with skv free (the encoder, and cross-attention against
    it). Returns (b, sq, h, dv) in q's dtype.

    CUDA tensors: the ``swa_attention`` kernel in its ``round_p`` mode,
    reading each q head's kv head ``h // rep`` in place (no repeat) and
    writing the (b, sq, h, hd) layout directly. It computes the
    reference's function: float32 scores and online softmax, ``p`` cast
    to v's dtype before PV while ``l`` sums the float32 ``p``, over
    64-key tiles (``chunked_attention(..., chunk=64)`` is its plain
    version; the chunk moves only where each ``p`` is rounded). Every call
    of the decoder LM reaches it: causal ones (with the window, and with a
    prefix), non-causal ones (encoder self-attention, and cross-attention
    with sq != skv), head dims up to 256. CPU tensors, and calls with a
    logit softcap (``cfg.attn_logit_softcap > 0``, which no config sets)
    or an offset q (``q_offset != 0``), which the kernel does not compute:
    :func:`chunked_attention`, on any device.
    """
    if (q.device.type == "cpu" or cfg.attn_logit_softcap > 0
            or q_offset != 0):
        return chunked_attention(q, k, v, cfg, q_offset=q_offset, chunk=chunk,
                                 causal=causal, prefix_len=prefix_len)
    b, s, h, _ = q.shape
    out = torch.empty((b, s, h, v.shape[3]), dtype=q.dtype, device=q.device)
    # the window applies only to causal attention, and the prefix only
    # under the causal mask, as on the CPU (the kernel, like the TPU's,
    # would also window a non-causal call)
    ops.swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2),
                      window=cfg.sliding_window if causal else 0,
                      causal=causal, out=out.transpose(1, 2), round_p=True,
                      prefix_len=prefix_len if causal else 0)
    return out


def decode_attention(q, k_cache, v_cache, cache_len, cfg: ModelConfig):
    """One-token decode: q (b, 1, h, hd) against caches (b, S, kvh, hd).

    cache_len: int, 0-d or (b,) tensor: the number of valid cache
    positions. Plain torch on every device."""
    b, _, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    rep = h // kvh
    kh, vh = k_cache, v_cache
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=2)
        vh = vh.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kh.float()) * _scale(hd)
    if cfg.attn_logit_softcap > 0:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    pos = torch.arange(S, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl[:, None, None, None] if cl.ndim else cl
    mask = pos[None, None, None, :] < cl
    if cfg.sliding_window > 0:
        mask = mask & (pos[None, None, None, :] >= cl - cfg.sliding_window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", p.float(), vh.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V2 multi-head latent attention (arXiv:2405.04434)


def init_mla(seed, path, cfg: ModelConfig, dtype, device=None):
    d, h = cfg.d_model, cfg.num_heads
    qn, qr, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, qlr = cfg.kv_lora_rank, cfg.q_lora_rank

    def dense(name, d_in, d_out):
        return basic.init_dense(seed, f"{path}/{name}", d_in, d_out, dtype,
                                device=device)
    p = {
        "wkv_a": dense("wkv_a", d, r + qr),
        "kv_norm": basic.init_norm(seed, f"{path}/kv_norm", r, dtype,
                                   "rmsnorm", device),
        "wk_b": dense("wk_b", r, h * qn),
        "wv_b": dense("wv_b", r, h * vd),
        "wo": dense("wo", h * vd, d),
    }
    if qlr > 0:
        p["wq_a"] = dense("wq_a", d, qlr)
        p["q_norm"] = basic.init_norm(seed, f"{path}/q_norm", qlr, dtype,
                                      "rmsnorm", device)
        p["wq_b"] = dense("wq_b", qlr, h * (qn + qr))
    else:
        p["wq"] = dense("wq", d, h * (qn + qr))
    return p


def _mla_q(x, p, cfg: ModelConfig):
    """q (b, s, heads, qn + qr) before RoPE: through the q_lora_rank
    bottleneck (``wq_a``, ``q_norm``, ``wq_b``) when the config has one;
    ``heads`` from the width of the pieces given (``wq_b`` or ``wq``)."""
    b, s, _ = x.shape
    cd = cfg.cdtype
    width = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if "wq_a" in p:
        x = basic.rmsnorm(basic.dense(x, p["wq_a"], cd), p["q_norm"]["scale"])
        wq = p["wq_b"]
    else:
        wq = p["wq"]
    h = wq["kernel"].shape[-1] // width
    return basic.dense(x, wq, cd).reshape(b, s, h, width)


def mla_compress(x, p, cfg: ModelConfig, positions):
    """The compressed cache entries of x (b, s, d): c_kv (b, s, r), normed,
    and the roped shared key k_pe (b, s, qr)."""
    r, qr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv = basic.dense(x, p["wkv_a"], cfg.cdtype)
    c_kv = basic.rmsnorm(kv[..., :r], p["kv_norm"]["scale"])
    cos, sin = rope_freqs(qr, cfg.rope_theta, positions)
    return c_kv, apply_rope(kv[..., None, r:], cos, sin)[..., 0, :]


def mla_qkv(x, p, cfg: ModelConfig, positions):
    """Full (non-absorbed) MLA for training and prefill: q and k (b, s, h,
    qn + qr), RoPE on their last qr dims (k's one shared rope head
    broadcast to every head), v (b, s, h, v_head_dim), and the (c_kv,
    k_pe) pair the cache holds. ``h`` is the head count of the pieces
    given: ``cfg.num_heads`` for the whole projections."""
    b, s, _ = x.shape
    qn, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    cd = cfg.cdtype
    q = _mla_q(x, p, cfg)
    h = q.shape[2]
    c_kv, k_pe = mla_compress(x, p, cfg, positions)
    k_nope = basic.dense(c_kv, p["wk_b"], cd).reshape(b, s, h, qn)
    v = basic.dense(c_kv, p["wv_b"], cd).reshape(b, s, h, vd)
    cos, sin = rope_freqs(cfg.qk_rope_head_dim, cfg.rope_theta, positions)
    q = torch.cat([q[..., :qn], apply_rope(q[..., qn:], cos, sin)], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, -1)], dim=-1)
    return q, k, v, (c_kv, k_pe)


def mla_heads_split(p, cfg: ModelConfig) -> bool:
    """True when ``p``'s MLA output projection holds only this rank's rows
    under the ambient tensor-parallel group."""
    return (mesh_lib.current_tp() is not None and p["wo"]["kernel"].shape[-2]
            != cfg.num_heads * cfg.v_head_dim)


def _mla_heads(plain, copied, wp, n_heads: int, hd: int, lo: int, hi: int,
               cd):
    """Heads [lo, hi) of an MLA up-projection, (b, s, hi - lo, hd): from
    this rank's columns (``copied``: the replicated input through
    ``tp_copy``; :func:`_heads_of` gathers them over "model" where they
    are not exactly those heads), or, for a projection the rules
    replicate, computed whole from the un-copied input (``plain``) and
    entering through ``tp_copy``."""
    tp = mesh_lib.current_tp()
    b, s, _ = plain.shape
    width = wp["kernel"].shape[-1]
    if width == n_heads * hd:
        t = mesh_lib.tp_copy(basic.dense(plain, wp, cd))
        t = t[..., lo * hd:hi * hd]
    else:
        t = _heads_of(basic.dense(copied, wp, cd), tp.rank * width, lo, hi,
                      hd)
    return t.reshape(b, s, hi - lo, hd)


def tp_mla(h, p, cfg: ModelConfig, positions, attention, causal=True,
           prefix_len: int = 0):
    """MLA on this rank's heads under the ambient tensor-parallel group,
    with ``wq_b`` / ``wk_b`` / ``wv_b`` (or ``wq`` without the q-LoRA)
    column-parallel and ``wo`` row-parallel, as ``launch/sharding``'s
    rules place them: returns (the slot's attention output, summed over
    the "model" ranks, the (c_kv, k_pe) cache entry).

    ``wq_a``, ``q_norm``, ``wkv_a`` and ``kv_norm`` are replicated: the
    q bottleneck, c_kv and the shared rope key k_pe are computed whole
    from the un-copied input on every rank and enter rank-local work
    through ``tp_copy`` once each, so their gradients are summed once over
    the ranks. The rank runs the heads that ``wo``'s rows on it read; where
    the axis ends a piece inside a head (3 heads on a 2-wide axis), it
    gathers the projection's pieces over "model" and takes those heads,
    as :func:`tp_attention` does."""
    tp = mesh_lib.current_tp()
    b, s, _ = h.shape
    nh, qn, qr, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim, cfg.v_head_dim)
    cd = cfg.cdtype
    rows = p["wo"]["kernel"].shape[-2]
    r0, r1 = tp.rank * rows, (tp.rank + 1) * rows
    lo, hi = r0 // vd, -(-r1 // vd)          # the heads wo's rows read
    if "wq_a" in p:
        qin = basic.rmsnorm(basic.dense(h, p["wq_a"], cd),
                            p["q_norm"]["scale"])
        wq = p["wq_b"]
    else:
        qin, wq = h, p["wq"]
    c_kv, k_pe = mla_compress(h, p, cfg, positions)
    ckv_c = mesh_lib.tp_copy(c_kv)
    q = _mla_heads(qin, mesh_lib.tp_copy(qin), wq, nh, qn + qr, lo, hi, cd)
    k_nope = _mla_heads(c_kv, ckv_c, p["wk_b"], nh, qn, lo, hi, cd)
    v = _mla_heads(c_kv, ckv_c, p["wv_b"], nh, vd, lo, hi, cd)
    cos, sin = rope_freqs(qr, cfg.rope_theta, positions)
    q = torch.cat([q[..., :qn], apply_rope(q[..., qn:], cos, sin)], dim=-1)
    k_pe_c = mesh_lib.tp_copy(k_pe)
    k = torch.cat([k_nope, k_pe_c[:, :, None, :].expand(b, s, hi - lo, qr)],
                  dim=-1)
    o = attention(q, k, v, cfg.with_(sliding_window=0), causal=causal,
                  prefix_len=prefix_len)
    del q, k, v
    # the width named, not -1: a data rank with no rows has b = 0
    o = o.reshape(b, s, (hi - lo) * vd)[..., r0 - lo * vd:r1 - lo * vd]
    return basic.row_parallel(o, p["wo"], cd), (c_kv, k_pe)


def mla_decode(x, p, cfg: ModelConfig, ckv_cache, kpe_cache, cache_len):
    """Absorbed-form decode of x (b, 1, d) against the compressed cache:
    ckv_cache (b, S, r), kpe_cache (b, S, qr), the first ``cache_len``
    positions valid (an int or a (b,) tensor). W_UK is folded into q, the
    scores are the latent scores plus the rope scores (float32), and the
    attention over the latents is lifted by W_UV before ``wo``."""
    b = x.shape[0]
    h, qn, qr, vd, r = (cfg.num_heads, cfg.qk_nope_head_dim,
                        cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    cd = cfg.cdtype
    S = ckv_cache.shape[1]
    q = _mla_q(x, p, cfg)
    cl = torch.as_tensor(cache_len, device=x.device)
    pos = (cl - 1).reshape(-1, 1).expand(b, 1)
    cos, sin = rope_freqs(qr, cfg.rope_theta, pos)
    q_pe = apply_rope(q[..., qn:], cos, sin)
    wkb = p["wk_b"]["kernel"].to(cd).reshape(r, h, qn)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q[..., :qn], wkb)
    ckv, kpe = ckv_cache.to(cd), kpe_cache.to(cd)
    # bf16 products are exact in float32: the reference's float32 scores
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv.float())
         + torch.einsum("bqhr,bsr->bhqs", q_pe.float(), kpe.float())) \
        * _scale(qn + qr)
    valid = torch.arange(S, device=x.device) < cl.reshape(-1, 1, 1, 1)
    pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pr.to(cd).float(),
                         ckv.float()).to(cd)
    wvb = p["wv_b"]["kernel"].to(cd).reshape(r, h, vd)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, wvb).reshape(b, 1, h * vd)
    return basic.dense(o, p["wo"], cd)
