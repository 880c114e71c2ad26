"""The server aggregation tail behind its dispatcher, port of
``repro/kernels/ops.agg_tail`` with the staged route
(``repro/kernels/ops._staged_tail``) only.

The staged route is an op-by-op pipeline over the (K, size) flat delta
buffer: per-leaf int-k fake-quantize (the CUDA kernels of
``kernels/quantize.py``), optional per-row L2 clip folded into the
weights (plain ``row_sumsq``, as in JAX), and the weighted mean
(``torch.matmul``, as JAX leaves it to XLA). What the JAX
dispatcher would send elsewhere raises ``NotImplementedError`` rather
than quietly taking the staged route.
"""
from __future__ import annotations

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.kernels import quantize as _q

# the JAX dispatcher's size threshold for the fused route (tuned on
# XLA:CPU; to be measured again on the card when the fused tail lands)
AGG_FUSE_THRESHOLD = 4 << 20

_LATER = "comes with the fused-tail/DP slice of the port"


def _staged_tail(mat, weights, block_leaf, *, n_leaves, align, bits,
                 clip_norm, uniform, wsum_fixed):
    info = {}
    w = (weights > 0).to(weights.dtype) if uniform else weights
    if wsum_fixed is not None:
        wsum = torch.tensor(float(wsum_fixed), dtype=torch.float32,
                            device=mat.device)
    else:
        wsum = torch.clamp_min(w.sum(), 1e-12)
    if bits > 0:
        mat = _q.fake_quantize_flat(mat, block_leaf, n_leaves, bits=bits,
                                    block=align)
    if clip_norm > 0:
        norms = torch.sqrt(flat_lib.row_sumsq(mat, align))
        # tensor / tensor: `scalar / tensor` is a reciprocal multiply
        w = w * torch.clamp(torch.full_like(norms, clip_norm)
                            / torch.clamp_min(norms, 1e-12), max=1.0)
        info["update_norms"] = norms
    return flat_lib.weighted_mean(mat, w, wsum), info


def agg_tail(mat, weights, *, block_leaf, n_leaves: int, align: int = 1024,
             bits: int = 0, clip_norm: float = 0.0, uniform: bool = False,
             wsum_fixed=None, sigma: float = 0.0, remask_rows: bool = False,
             block_denom: bool = False, screen=None, threshold=None):
    """Server aggregation tail over the (K, size) flat delta buffer:
    returns ``(update (size,), info)``, ``info["route"] == "staged"`` and
    ``info["update_norms"]`` when clipping.

    Ported: the staged route — int-``bits`` fake-quantize, clip folded
    into the weights, weighted / fixed-denominator mean. Raises
    ``NotImplementedError`` for what a later slice ports: the fused
    route (JAX takes it for ``bits > 0`` at ``K * size >=
    AGG_FUSE_THRESHOLD``, or whenever an explicit ``threshold`` is
    reached), DP noise (``sigma > 0``), the quarantine ``screen`` and
    the row re-mask and per-block denominator of trainability tiers
    (``remask_rows``, ``block_denom``)."""
    K, size = mat.shape
    if threshold is None:
        fuse = bits > 0 and K * size >= AGG_FUSE_THRESHOLD
    else:
        fuse = K * size >= threshold
    if fuse:
        raise NotImplementedError(f"the fused aggregation tail {_LATER}")
    if sigma > 0:
        raise NotImplementedError(f"DP noise in the tail {_LATER}")
    if screen is not None:
        raise NotImplementedError("the quarantine screen (core/sanitize.py) "
                                  "is not ported yet")
    if remask_rows or block_denom:
        raise NotImplementedError("trainability tiers (core/plan.py) are "
                                  "not ported yet")
    out, info = _staged_tail(mat, weights, block_leaf, n_leaves=n_leaves,
                             align=align, bits=bits, clip_norm=clip_norm,
                             uniform=uniform, wsum_fixed=wsum_fixed)
    info["route"] = "staged"
    return out, info
