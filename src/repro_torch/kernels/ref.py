"""Plain torch versions of the port's kernels (counterparts of
``repro/kernels/ref.py``). The CPU path runs them; on the card
``chip_smoke.py`` and the CUDA tests hold each kernel against them.

Reductions go through the (rows, block) view of the block-aligned flat
buffer (``core/flat.FlatLayout``): a block never straddles two leaves.
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


def flat_sumsq_ref(x, chunk: int = 1024):
    """Sum of squares of a flat vector via a two-stage reduction (0-d f32)."""
    xc = _chunked(x.float().reshape(-1), chunk)
    return (xc * xc).sum(-1).sum()


def row_sumsq_ref(mat, chunk: int = 1024):
    """(C, N) -> (C,) per-row sum of squares."""
    xc = _chunked(mat.float(), chunk)
    return (xc * xc).sum(-1).sum(-1)


def _leaf_index(block_leaf, device) -> torch.Tensor:
    return torch.as_tensor(block_leaf, dtype=torch.int64, device=device)


def leaf_maxabs_ref(mat, block_leaf, n_leaves: int, block: int = 1024):
    """Per-leaf max|x| of block-aligned flat rows: (..., N) -> (..., L) f32.

    Runs on the int32 bitcast with the sign bit cleared: that pattern
    orders like |x| for finite values and every NaN orders above +Inf,
    so the integer max is max|x| with NaN propagated (as
    ``repro/kernels/ref.py:105-131``)."""
    x = mat.float().contiguous()
    lead = x.shape[:-1]
    bits = (x.view(torch.int32) & _ABS_MASK_I32).reshape(
        -1, x.shape[-1] // block, block).amax(-1)            # (R, NB)
    idx = _leaf_index(block_leaf, x.device).expand(bits.shape[0], -1)
    out = torch.zeros((bits.shape[0], n_leaves), dtype=torch.int32,
                      device=x.device)
    out = out.scatter_reduce(1, idx, bits, "amax", include_self=True)
    return out.view(torch.float32).reshape(lead + (n_leaves,))


def fake_quantize_flat_ref(mat, block_leaf, bits: int = 8,
                           block: int = 1024, n_leaves: int = 0):
    """Per-leaf symmetric int-k Q->DQ over block-aligned flat rows
    (..., N): the scale is the leaf max-abs / qmax with a 1e-12 floor,
    exactly ``compress.quantize_leaf`` + ``dequantize_leaf``."""
    qmax = 2.0 ** (bits - 1) - 1
    if not n_leaves:
        n_leaves = int(np.max(np.asarray(block_leaf))) + 1
    x = mat.float()
    floor = torch.tensor(1e-12, dtype=torch.float32, device=x.device)
    # divide by a tensor on x's device: torch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    scales = torch.maximum(leaf_maxabs_ref(x, block_leaf, n_leaves, block),
                           floor) / torch.tensor(qmax, device=x.device)
    sblock = scales[..., _leaf_index(block_leaf, x.device)]  # (..., NB)
    xc = _chunked(x, block)
    q = torch.clamp(torch.round(xc / sblock[..., None]), -qmax, qmax)
    return (q * sblock[..., None]).reshape(mat.shape)
