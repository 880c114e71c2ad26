"""Uplink delta compression, port of ``repro/core/compress.py``:
symmetric per-leaf int-k quantization with one float32 scale per leaf,
applied per client before aggregation (the lossy uplink FedPT composes
with). Deterministic round-half-to-even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.nn import basic

# every quantized leaf ships one float32 scale on the wire
SCALE_BYTES = 4


def quantize_leaf(x, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = 2.0 ** (bits - 1) - 1
    xf = x.float()
    floor = torch.tensor(1e-12, dtype=torch.float32, device=x.device)
    # torch.maximum keeps a NaN max-abs, as jnp.maximum does; the divisor
    # is a tensor on x's device, since torch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not IEEE division
    scale = torch.maximum(xf.abs().max(), floor) / torch.tensor(
        qmax, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8 if bits == 8 else torch.int32), scale


def dequantize_leaf(q, scale):
    return q.float() * scale


def quantize_tree(tree, bits: int = 8):
    """(codes tree, scales tree): each leaf's int-k codes (int8 at 8 bits,
    else int32) and its float32 scale."""
    flat = list(basic.flatten_params(tree))
    pairs = [quantize_leaf(leaf, bits) for _, leaf in flat]
    return (basic.unflatten_params({p: q for (p, _), (q, _) in
                                    zip(flat, pairs)}),
            basic.unflatten_params({p: s for (p, _), (_, s) in
                                    zip(flat, pairs)}))


def dequantize_tree(qtree, scales):
    return basic.tree_map(dequantize_leaf, qtree, scales)


def fake_quantize_tree(tree, bits: int = 8):
    """Q->DQ of every leaf (the in-graph uplink model)."""
    def one(x):
        q, s = quantize_leaf(x, bits)
        return dequantize_leaf(q, s).to(x.dtype)
    return basic.tree_map(one, tree)


def quantized_uplink_bytes(tree, bits: int = 8) -> int:
    """int-k payload + one f32 scale per leaf."""
    n = basic.tree_size(tree)
    return n * bits // 8 + SCALE_BYTES * len(basic.tree_leaves(tree))
