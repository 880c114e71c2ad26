"""Plain torch versions of the port's kernels (counterparts of
``repro/kernels/ref.py``). The CPU path runs them; on the card
``chip_smoke.py`` and the CUDA tests hold each kernel against them.

Reductions go through the (rows, block) view of the block-aligned flat
buffer (``core/flat.FlatLayout``): a block never straddles two leaves.
Sums of squares take the reference's log-halving order within a block
(:func:`_sumsq_blocks`) and one shared combine across blocks
(:func:`_row_combine`), so the staged quarantine screen (``row_sumsq``)
and the fused one (``agg_block_stats_ref`` / the stats kernel) reach
the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

_ABS_MASK_I32 = 0x7FFFFFFF


def _chunked(x, chunk: int):
    """(..., N) -> (..., N//chunk, chunk); one chunk when it does not divide."""
    n = x.shape[-1]
    if chunk <= 1 or n == 0 or n % chunk:
        return x.reshape(x.shape[:-1] + (1, n))
    return x.reshape(x.shape[:-1] + (n // chunk, chunk))


def _sumsq_blocks(x3):
    """(..., w) -> (...,) float32 sum of squares over the last axis, in
    ``repro/kernels/ref._sumsq_chunk``'s order: y[i] = x[i]^2 + x[i+w/2]^2,
    then y[i] + y[i+h] while the width halves evenly. Each product and sum
    is its own float32 rounding (no fused multiply-add), which the stats
    kernel repeats bit for bit. Integer codes sum exactly."""
    h = x3.shape[-1] // 2
    if x3.shape[-1] % 2 or h == 0:
        xf = x3.float()
        return (xf * xf).sum(-1)
    a, b = x3[..., :h].float(), x3[..., h:].float()
    y = a * a + b * b
    while y.shape[-1] > 1 and y.shape[-1] % 2 == 0:
        h = y.shape[-1] // 2
        y = y[..., :h] + y[..., h:]
    return y.sum(-1)


def _row_combine(part):
    """(..., NB) per-block sums -> (...,) row totals: the one combine every
    row norm of the port goes through."""
    return part.sum(-1)


def flat_sumsq_ref(x, chunk: int = 1024):
    """Sum of squares of a flat vector via a two-stage reduction (0-d f32)."""
    return _row_combine(_sumsq_blocks(_chunked(x.float().reshape(-1), chunk)))


def row_sumsq_ref(mat, chunk: int = 1024):
    """(C, N) -> (C,) per-row sum of squares."""
    return _row_combine(_sumsq_blocks(_chunked(mat.float(), chunk)))


def _clip_scale(nrm, clip_norm: float):
    """min(1, C / max(norm, 1e-12)), NaN kept (``torch.clamp`` propagates
    it as ``jnp.minimum`` / ``jnp.maximum`` do). The division is tensor by
    tensor (see ``agg_scales_ref``)."""
    return torch.clamp(torch.full_like(nrm, clip_norm)
                       / torch.clamp_min(nrm, 1e-12), max=1.0)


def flat_clip_ref(x, clip_norm: float, chunk: int = 1024):
    """x * min(1, C/||x||) of each row of (..., N) flat rows; returns
    (clipped, pre-clip norms (...,)). A row's norm is
    ``repro/kernels/ref.flat_clip_ref``'s for that row alone."""
    nrm = torch.sqrt(row_sumsq_ref(x, chunk))
    return x.float() * _clip_scale(nrm, clip_norm)[..., None], nrm


def dp_clip_accumulate_ref(acc, x, clip_norm: float):
    """acc + x * min(1, C/||x||) of (N,) vectors; returns (new acc, pre-clip
    norm). The norm is one plain sum, as ``repro/kernels/ref.py``'s."""
    xf = x.float()
    nrm = torch.sqrt((xf * xf).sum())
    return acc + xf * _clip_scale(nrm, clip_norm), nrm


def _leaf_index(block_leaf, device) -> torch.Tensor:
    return torch.as_tensor(block_leaf, dtype=torch.int64, device=device)


def _block_maxabs_bits(x3):
    """(..., NB, block) f32 -> (..., NB) int32: per block, the bit pattern
    of max|x|. Runs on the int32 bitcast with the sign bit cleared: that
    pattern orders like |x| for finite values and every NaN orders above
    +Inf, so the integer max is max|x| with NaN propagated (as
    ``repro/kernels/ref.py:105-131``)."""
    return (x3.contiguous().view(torch.int32) & _ABS_MASK_I32).amax(-1)


def _leaf_max(bits, block_leaf, n_leaves: int):
    """(R, NB) int32 block maxima -> (R, L) float32 per-leaf maxima."""
    idx = _leaf_index(block_leaf, bits.device).expand(bits.shape[0], -1)
    out = torch.zeros((bits.shape[0], n_leaves), dtype=torch.int32,
                      device=bits.device)
    out = out.scatter_reduce(1, idx, bits, "amax", include_self=True)
    return out.view(torch.float32)


def leaf_maxabs_ref(mat, block_leaf, n_leaves: int, block: int = 1024):
    """Per-leaf max|x| of block-aligned flat rows: (..., N) -> (..., L) f32,
    NaN propagated."""
    x = mat.float()
    bits = _block_maxabs_bits(x.reshape(-1, x.shape[-1] // block, block))
    return _leaf_max(bits, block_leaf, n_leaves).reshape(
        x.shape[:-1] + (n_leaves,))


def fake_quantize_flat_ref(mat, block_leaf, bits: int = 8,
                           block: int = 1024, n_leaves: int = 0):
    """Per-leaf symmetric int-k Q->DQ over block-aligned flat rows
    (..., N): the scale is the leaf max-abs / qmax with a 1e-12 floor,
    exactly ``compress.quantize_leaf`` + ``dequantize_leaf``."""
    qmax = 2.0 ** (bits - 1) - 1
    if not n_leaves:
        n_leaves = int(np.max(np.asarray(block_leaf))) + 1
    x = mat.float()
    x3 = x.reshape(-1, x.shape[-1] // block, block)
    bmax = _block_maxabs_bits(x3).view(torch.float32)
    sblock = agg_scales_ref(bmax, block_leaf, bits, n_leaves)[..., None]
    q = torch.clamp(torch.round(x3 / sblock), -qmax, qmax)
    return (q * sblock).reshape(mat.shape)


def qdq_from_leaf_max_ref(mat, lmax, block_leaf, bits: int = 8,
                          block: int = 1024):
    """Q->DQ of block-aligned flat rows (R, N) from given per-(row, leaf)
    max-abs (R, L): ``fake_quantize_flat_ref`` with its own maxima
    replaced, bit for bit that function when they are its own."""
    qmax = 2.0 ** (bits - 1) - 1
    dev = mat.device
    floor = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    scales = (torch.maximum(lmax.float(), floor) / torch.tensor(
        qmax, dtype=torch.float32, device=dev))[
            :, _leaf_index(block_leaf, dev)][..., None]
    x = mat.float()
    x3 = x.reshape(x.shape[0], -1, block)
    q = torch.clamp(torch.round(x3 / scales), -qmax, qmax)
    return (q * scales).reshape(mat.shape)


# ---------------------------------------------------------------------------
# The fused aggregation tail's stages (``kernels/agg_tail.py``'s plain
# versions): stats -> scales -> pack -> apply over the (K, N) buffer.


def agg_block_stats_ref(mat, block: int = 1024, with_sumsq: bool = False):
    """(K, N) -> per-(row, block) max|x| (NaN propagated) and, with
    ``with_sumsq``, per-(row, block) sum of squares (else None).
    ``_row_combine(bsumsq)`` is ``row_sumsq_ref(mat)`` bit for bit."""
    x3 = _chunked(mat.float(), block)
    bmax = _block_maxabs_bits(x3).view(torch.float32)
    return bmax, (_sumsq_blocks(x3) if with_sumsq else None)


def agg_scales_ref(bmax, block_leaf, bits: int, n_leaves: int):
    """(K, NB) block max-abs -> (K, NB) quantization scales: the leaf
    max-abs / qmax with the 1e-12 floor, repeated to the leaf's blocks.
    ``torch.maximum`` keeps a NaN, as ``jnp.maximum`` does. The divisor is
    a tensor on the same device: torch's CUDA division by a Python scalar
    multiplies by its reciprocal, which is not IEEE division."""
    qmax = 2.0 ** (bits - 1) - 1
    dev = bmax.device
    bits_ = bmax.float().contiguous().view(torch.int32) & _ABS_MASK_I32
    lmax = _leaf_max(bits_, block_leaf, n_leaves)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    scales = torch.maximum(lmax, floor) / torch.tensor(
        qmax, dtype=torch.float32, device=dev)
    return scales[:, _leaf_index(block_leaf, dev)]


def agg_pack_ref(mat, sblock, bits: int, block: int = 1024):
    """(K, N), (K, NB) scales -> (K, NB, block) int8 codes
    clip(round(x / s), -qmax, qmax): same division, rounding (half to
    even) and clip as the staged Q->DQ, so ``codes * s`` is its output
    bit for bit. The code of a NaN is unspecified (the fused tail only
    packs rows it has screened, or assumes finite data)."""
    qmax = 2.0 ** (bits - 1) - 1
    x3 = _chunked(mat.float(), block)
    return torch.clamp(torch.round(x3 / sblock[..., None]),
                       -qmax, qmax).to(torch.int8)


def agg_quant_sumsq_ref(q, sblock):
    """(K, NB, block) codes, (K, NB) scales -> (K,) sum_b s_b^2 * sum(q_b^2):
    the row sum of squares of the dequantized buffer (the block sums of
    integer codes are exact), at int8 read cost."""
    s = sblock.float()
    return _row_combine(_sumsq_blocks(q) * (s * s))


def agg_apply_ref(q, coeff, noise=None, block: int = 1024):
    """acc = noise (or 0), then acc = acc + q[k] * coeff[k, block] for
    k = 0..K-1 in order: (K, NB, block) codes or f32 blocks, (K, NB)
    coefficients (dequantize scale x clip scale x weight / denominator),
    optional pre-drawn (N,) noise -> (N,)."""
    K, NB = coeff.shape
    if noise is not None:
        acc = noise.reshape(NB, block).float()
    else:
        acc = torch.zeros((NB, block), dtype=torch.float32,
                          device=coeff.device)
    for k in range(K):
        acc = acc + q[k].float() * coeff[k][:, None]
    return acc.reshape(-1)


def agg_apply_exact_ref(x3, weights, sblock=None, wsum=None, block_den=None,
                        cols: int = 1024):
    """Column-chunked weighted-mean GEMV: x3 (K, NB, block) f32 blocks or
    int8 codes (dequantized chunk by chunk with ``sblock`` (K, NB), equal
    to the staged fake-quantize output); each output element is the
    K-length dot ``torch.matmul(weights, mat)`` computes, then ``/ wsum``,
    or, for trainability tiers, ``/ block_den`` (NB,) repeated to
    elements, each a tensor by a tensor."""
    K, NB, block = x3.shape
    w = weights.float()
    outs = []
    for i in range(0, NB, cols):
        part = x3[:, i:i + cols].float()
        if sblock is not None:
            part = part * sblock[:, i:i + cols, None]
        t = torch.matmul(w, part.reshape(K, part.shape[1] * block))
        if block_den is not None:
            t = t / block_den[i:i + cols].repeat_interleave(block)
        elif wsum is not None:
            t = t / wsum
        outs.append(t)
    return torch.cat(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Sliding-window attention (kernels/swa_attention.py)

NEG_INF = -1e30


def _swa_mask(qpos, kpos, window: int, causal: bool, prefix_len: int = 0):
    """(sq, sk) bool: the keys each query sees. Causal (keys at or before
    the query, plus a bidirectional prefix of ``prefix_len`` keys), and,
    with ``window`` > 0, q - k < window: the swa_attention kernel's mask,
    which also windows a non-causal call."""
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        if prefix_len > 0:  # bidirectional prefix (PaliGemma-style)
            mask = mask | (kpos[None, :] < prefix_len)
    else:
        mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def _repeat_kv(x, heads: int):
    """(B, KVH, S, .) -> float32 (B, heads, S, .): q head h reads kv head
    h // (heads // KVH), as ``jnp.repeat`` lays them out."""
    rep = heads // x.shape[1]
    xf = x.float()
    return xf.repeat_interleave(rep, dim=1) if rep > 1 else xf


def _swa_scores(q, kf, q0: int, q_chunk: int, window: int, causal: bool,
                prefix_len: int = 0):
    """Masked float32 scores (B, H, rows, Skv) of q rows [q0, q0 +
    q_chunk)."""
    D, S = q.shape[3], kf.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    qc = q[:, :, q0:q0 + q_chunk].float()
    s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
    qpos = q0 + torch.arange(qc.shape[2], device=q.device)
    mask = _swa_mask(qpos, torch.arange(S, device=q.device), window, causal,
                     prefix_len)
    return torch.where(mask[None, None], s, NEG_INF)


def swa_attention_ref(q, k, v, window: int, causal: bool = True,
                      q_chunk: int = 512, prefix_len: int = 0):
    """Dense sliding-window attention oracle (``ref.swa_attention_ref`` of
    the JAX package), float32 (B, H, Sq, DV).

    q: (B, H, Sq, D); k, v: (B, KVH, Skv, D | DV) with H a multiple of
    KVH: q head h reads kv head h // (H // KVH), as ``jnp.repeat`` lays
    them out. window: past positions visible (<= 0: full causal);
    ``prefix_len``: the causal mask's bidirectional prefix. Rows are taken
    ``q_chunk`` at a time so that a long sequence's score matrix never
    exists whole; every row's softmax runs over all its keys, so the
    chunking changes no value."""
    kf, vf = _repeat_kv(k, q.shape[1]), _repeat_kv(v, q.shape[1])
    outs = []
    for q0 in range(0, q.shape[2], q_chunk):
        s = _swa_scores(q, kf, q0, q_chunk, window, causal, prefix_len)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vf))
    return torch.cat(outs, dim=2)


def swa_softmax_peak(q, k, window: int, causal: bool = True,
                     q_chunk: int = 512, prefix_len: int = 0):
    """(B, H, Sq) float32: each row's largest softmax weight, max_j p_j / l
    = 1 / l with l = sum_j exp(s_j - max s), for the masks of
    :func:`swa_attention_ref`. It bounds the share of the output that one
    key's p carries."""
    kf = _repeat_kv(k, q.shape[1])
    outs = []
    for q0 in range(0, q.shape[2], q_chunk):
        s = _swa_scores(q, kf, q0, q_chunk, window, causal, prefix_len)
        outs.append(torch.exp(s.amax(-1) - torch.logsumexp(s, -1)))
    return torch.cat(outs, dim=2)


def chunked_attention_ref(q, k, v, window: int = 0, causal: bool = True,
                          chunk: int = 512, softcap: float = 0.0,
                          prefix_len: int = 0, q_offset: int = 0):
    """The reference's ``flash_attention`` (``repro/nn/attention.py``) in
    plain torch, over q (B, H, Sq, D) and k (B, KVH, Skv, D), v (B, KVH,
    Skv, Dv) with H a multiple of KVH: a loop over KV chunks of ``chunk``
    keys carrying the online softmax (max m, sum l, acc) in float32, the
    scores optionally soft-capped, p = exp(s - m_new) cast to v's dtype
    before the p.v product while l sums the unrounded p; returns (B, H,
    Sq, Dv) in q's dtype. ``q_offset`` is the position of q's first row.
    The mask is :func:`_swa_mask`'s; ``nn/attention.chunked_attention``
    passes window 0 to a non-causal call, as the reference ignores the
    window there.

    At ``chunk=64`` the running max moves at the keys where the
    ``swa_attention`` kernel's 64-key tiles do, so each p is rounded at
    the kernel's scale: the oracle of the kernel's ``round_p`` mode."""
    B, H, sq, D = q.shape
    skv, dv = k.shape[2], v.shape[3]
    rep = H // k.shape[1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    kh, vh = k, v
    if rep > 1:  # jnp.repeat: each kv head serves `rep` consecutive q heads
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((B, H, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, sq, dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, max(skv, 1), chunk):
        kc, vc = kh[:, :, c0:c0 + chunk], vh[:, :, c0:c0 + chunk]
        kpos = c0 + torch.arange(kc.shape[2], device=q.device)
        # bf16 x bf16 is exact in f32: the upcast gives JAX's
        # preferred_element_type=float32 scores
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = _swa_mask(qpos, kpos, window, causal, prefix_len)
        s = torch.where(mask[None, None], s, NEG_INF)
        # the reference pads the last chunk with masked zero keys; each
        # adds an exact 0 to the sums, so a shorter chunk is the same
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def split_p(p, dtype):
    """Float32 p as two terms of ``dtype`` (bf16 or fp16): p_hi = dtype(p),
    p_lo = dtype(p - p_hi), both rounded to nearest even; p - p_hi is exact
    in float32. |p - p_hi - p_lo| <= 2**-16 |p| in bf16 and 2**-22 |p| in
    fp16 (plus half of fp16's subnormal spacing, 2**-25): the swa_attention
    kernel's p.v on the tensor cores as p_hi.v + p_lo.v."""
    hi = p.to(dtype)
    return hi, (p - hi.float()).to(dtype)


# ---------------------------------------------------------------------------
# Seed reconstruction (kernels/seed_reconstruct.py): the Pallas body,
# ported. 32-bit words are held in int64 and masked, as nn/threefry.py
# holds them (torch has no full uint32 arithmetic).

M32 = 0xFFFFFFFF
_SQ_C1, _SQ_C2, _SQ_C3 = 0xB5297A4D, 0x68E31DA4, 0x1B56C4E9
TWO_PI = 6.283185307179586


def _mul32(n, c: int):
    """(n * c) mod 2**32 for int64 n in [0, 2**32), by 16-bit halves of
    n so that no int64 product overflows."""
    lo = (n & 0xFFFF) * c
    hi = ((n >> 16) * (c & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _squirrel3(n, seed: int):
    """The reference's squirrel3 avalanche of the uint32 words n."""
    n = _mul32(n, _SQ_C1)
    n = (n + seed) & M32
    n = n ^ (n >> 8)
    n = (n + _SQ_C2) & M32
    n = n ^ ((n << 8) & M32)
    n = _mul32(n, _SQ_C3)
    return n ^ (n >> 8)


def seed_word(seed: int, leaf_id: int) -> int:
    """``uint32(int32 seed) * 0x9E3779B9 + uint32(int32(leaf_id * 40503))``,
    wrapping, as the reference's wrapper and kernel build it."""
    return ((int(seed) & M32) * 0x9E3779B9 + ((int(leaf_id) * 40503) & M32)) & M32


def seed_dims(shape):
    """``shape`` flattened to (rows, cols) on its last dim."""
    if len(shape) == 1:
        return 1, int(shape[0])
    return int(np.prod([int(d) for d in shape[:-1]])), int(shape[-1])


def seed_bits_plain(seed: int, leaf_id: int, rows: int, cols: int,
                    row0: int = 0, device=None):
    """The two squirrel3 words (b1, b2) of the elements of rows
    [row0, row0 + rows) of a (., cols) tensor, int64 in [0, 2**32): the
    counter is the row-major index over the logical cols, in 32 bits."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    idx = (r[:, None] * cols + c[None, :]) & M32
    sw = seed_word(seed, leaf_id)
    return (_squirrel3((idx * 2) & M32, sw),
            _squirrel3((idx * 2 + 1) & M32, sw))


def _uniform(bits):
    """uint32 -> (0, 1): top 24 bits as mantissa, offset by half an ulp
    (exact in float32)."""
    return ((bits >> 8).float() + 0.5) * (1.0 / 16777216.0)


def seed_reconstruct_plain(seed: int, leaf_id: int, shape, stddev: float,
                           dtype=torch.float32, block_rows: int = 256,
                           device=None):
    """The deterministic Gaussian tensor of ``shape`` from (seed, leaf_id):
    Box-Muller over two squirrel3 words per element, times ``stddev``,
    rows taken ``block_rows`` at a time (the result does not depend on
    it). Named ``_plain``, not ``_ref``: it ports the Pallas body bit for
    bit, where the JAX package's ``ref.seed_reconstruct_ref`` is only a
    distributional oracle of another function."""
    rows, cols = seed_dims(shape)
    f32 = dict(dtype=torch.float32, device=device)
    two_pi = torch.tensor(np.float32(TWO_PI), **f32)
    std = torch.tensor(np.float32(stddev), **f32)
    out = torch.empty((rows, cols), dtype=dtype, device=device)
    for r0 in range(0, rows, block_rows):
        n = min(block_rows, rows - r0)
        b1, b2 = seed_bits_plain(seed, leaf_id, n, cols, r0, device)
        z = torch.sqrt(-2.0 * torch.log(_uniform(b1))) * torch.cos(
            two_pi * _uniform(b2))
        out[r0:r0 + n] = (std * z).to(dtype)
    return out.reshape(tuple(shape))
