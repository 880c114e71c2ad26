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


def agg_apply_exact_ref(x3, weights, sblock=None, wsum=None,
                        cols: int = 1024):
    """Column-chunked weighted-mean GEMV: x3 (K, NB, block) f32 blocks or
    int8 codes (dequantized chunk by chunk with ``sblock`` (K, NB), equal
    to the staged fake-quantize output); each output element is the
    K-length dot ``torch.matmul(weights, mat)`` computes, then ``/ wsum``
    elementwise. The JAX oracle's per-block denominator and noise
    arguments serve trainability tiers and are not ported yet."""
    K, NB, block = x3.shape
    w = weights.float()
    outs = []
    for i in range(0, NB, cols):
        part = x3[:, i:i + cols].float()
        if sblock is not None:
            part = part * sblock[:, i:i + cols, None]
        t = torch.matmul(w, part.reshape(K, -1))
        outs.append(t / wsum if wsum is not None else t)
    return torch.cat(outs) if len(outs) > 1 else outs[0]
