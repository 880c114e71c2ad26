"""Per-leaf int-k fake-quantize of flat client deltas: the CUDA kernels of
``csrc/quantize.cu`` (port of ``repro/kernels/quantize.py``'s
``_maxabs_kernel`` / ``leaf_maxabs`` and ``_qdq_kernel`` /
``fake_quantize_flat``).

Both take the whole (K, N) buffer of K client rows in one launch, where
the JAX package maps the TPU kernels over the rows. ``N`` is
``len(block_leaf) * block``: each ``block``-element block of a row
belongs to one leaf (``core/flat.FlatLayout`` pads every leaf to whole
blocks), so the zero padding never raises a leaf's max.

``fake_quantize_flat`` takes one of two routes, by shape alone
(:func:`qdq_route`): the cluster route, one launch in which a cluster of
CTAs holds a row in registers (x read once), for rows of at most
``CLUSTER * CLUSTER_MAX_BLOCKS`` 1024-element blocks over at most
``CLUSTER_MAX_LEAVES`` leaves; else the two-pass route, ``leaf_maxabs``
then a Q->DQ launch that reads x again. Both give the same bits.

``leaf_maxabs`` is a memset of the output and one launch of a fold kernel
(a warp a 1024-element piece at a time, :func:`maxabs_plan`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import _build, ref

BLOCK = 1024  # must equal the layout's `align`
# the cluster route: CTAs a row (16, a non-portable cluster size: on the
# H100 it beat 8 at 10 and 6 rows, chip_smoke.py --sweep), thread groups
# a CTA (256 threads, one float4 each of a block, per group), the float4s a
# thread holds in registers (the kernel's instances), the blocks a CTA
# holds at most, and the leaves its shared table holds
CLUSTER = 16
CLUSTER_GROUPS = 2
CLUSTER_PER_THREAD = (1, 2, 4, 8)
CLUSTER_MAX_BLOCKS = CLUSTER_GROUPS * CLUSTER_PER_THREAD[-1]
CLUSTER_MAX_LEAVES = 256

# leaf_maxabs: warps a CTA (one piece each at a time), and CTAs at most
# (two an SM of the H100: two register sets of eight float4 a lane)
MAXABS_WARPS = 8
MAXABS_MAX_CTAS = 264

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "leaf_maxabs_f32": [_P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _P, _P],
    "fake_quantize_flat_f32": [_P, _P, _P, _I64, _I64, _INT, _INT,
                               ctypes.c_float, _P, _P],
    "fake_quantize_cluster_f32": [_P, _P, _I64, _I64, _INT, _INT, _INT,
                                  _INT, ctypes.c_float, _P, _P],
}


def qdq_route(n: int, block: int, n_leaves: int) -> str:
    """``"cluster"`` or ``"two_pass"``: the route ``fake_quantize_flat``
    takes for rows of n elements in ``block``-element blocks over
    ``n_leaves`` leaves. The cluster route needs 1024-element blocks (256
    threads x one float4), at most CLUSTER * CLUSTER_MAX_BLOCKS of them and
    at most CLUSTER_MAX_LEAVES leaves."""
    n_blocks = n // block
    if (block == 1024 and 1 <= n_blocks <= CLUSTER * CLUSTER_MAX_BLOCKS
            and n_leaves <= CLUSTER_MAX_LEAVES):
        return "cluster"
    return "two_pass"


def cluster_split(n_blocks: int):
    """(ctas, groups, per_thread) of the cluster route for a row of
    ``n_blocks`` blocks: the kernel gives CTA r of the row's cluster the
    blocks [r * n_blocks // ctas, (r + 1) * n_blocks // ctas), and its
    thread group g (of ``groups``) the CTA's blocks g, g + groups, ...,
    at most ``per_thread`` of them."""
    ctas = min(CLUSTER, n_blocks)
    share = -(-n_blocks // ctas)
    groups = min(CLUSTER_GROUPS, share)
    per_thread = next(p for p in CLUSTER_PER_THREAD if groups * p >= share)
    return ctas, groups, per_thread


def maxabs_piece(block: int) -> int:
    """Elements a warp of the max-abs kernel reduces at a time: the block
    when it has at most 1024, else 1024 (a slice of it). Raises for a
    block the kernel does not take (a multiple of 128, at most 1024 or a
    multiple of 1024)."""
    piece = min(block, BLOCK)
    if block < 128 or block % 128 or block % piece:
        raise ValueError(f"leaf_maxabs on the card takes blocks that are a "
                         f"multiple of 128, at most 1024 or a multiple of "
                         f"1024; got {block}")
    return piece


def maxabs_plan(rows: int, n: int, block: int = BLOCK) -> Tuple[int, int]:
    """(grid, per_warp) of the max-abs kernel for ``rows`` rows of n
    elements: warp w takes the pieces [w * per_warp, (w + 1) * per_warp)
    of the rows x (n / piece) pieces in row-major order. One piece a warp
    while that needs at most MAXABS_MAX_CTAS CTAs (109 at (10, 89,088)),
    then the fewest pieces a warp that keep to them (8 a warp, 259 CTAs at
    (10, 1,695,744)). From the shape alone."""
    pieces = rows * (n // maxabs_piece(block))
    per_warp = max(1, -(-pieces // (MAXABS_MAX_CTAS * MAXABS_WARPS)))
    return max(1, -(-pieces // (per_warp * MAXABS_WARPS))), per_warp


def _block_leaf_on(block_leaf, n_blocks: int, n_leaves: int, device):
    """The block->leaf map as an int32 tensor on ``device``, checked
    against the buffer's block count and the leaf count."""
    if isinstance(block_leaf, torch.Tensor):
        bl = block_leaf.to(device=device, dtype=torch.int32).contiguous()
    else:
        host = np.asarray(block_leaf)
        if host.size and (host.min() < 0 or host.max() >= n_leaves):
            raise ValueError(f"block_leaf values must lie in [0, {n_leaves})")
        bl = torch.as_tensor(host, dtype=torch.int32, device=device)
    if bl.shape != (n_blocks,):
        raise ValueError(f"block_leaf has shape {tuple(bl.shape)}, the "
                         f"buffer has {n_blocks} blocks")
    return bl


def _as_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    rows = x.reshape(1, -1) if x.ndim == 1 else x
    _build.check_cuda("fake_quantize", rows, torch.float32, 2)
    if rows.shape[1] % block:
        raise ValueError(f"row length {rows.shape[1]} is not a multiple of "
                         f"block {block}")
    if rows.shape[0] > 65535:
        raise ValueError("at most 65535 rows per launch")
    return rows


def leaf_maxabs(x: torch.Tensor, block_leaf, n_leaves: int,
                block: int = BLOCK) -> torch.Tensor:
    """Per-leaf max|x| of block-aligned flat rows: (..., N) -> (..., L)
    float32, NaN propagated. On CUDA a memset of the output and one launch
    of the fold kernel for all rows; ``block_leaf`` as an int32 tensor on
    the card is taken as it is, not checked (the kernel skips a leaf
    outside [0, L)). ``ref.leaf_maxabs_ref`` on the CPU."""
    if x.device.type == "cpu":
        return ref.leaf_maxabs_ref(x, block_leaf, n_leaves, block)
    rows = _as_rows(x, block)
    R, n = rows.shape
    bl = _block_leaf_on(block_leaf, n // block, n_leaves, x.device)
    out = torch.empty((R, n_leaves), dtype=torch.int32, device=x.device)
    if rows.numel():
        if n_leaves < 1:
            raise ValueError("leaf_maxabs: n_leaves must be at least 1")
        grid, per_warp = maxabs_plan(R, n, block)
        lib = _build.load("quantize.cu", _SIGNATURES)
        err = lib.leaf_maxabs_f32(rows.data_ptr(), bl.data_ptr(), R, n, block,
                                  n_leaves, grid, per_warp, out.data_ptr(),
                                  _build.stream_ptr(x))
        _build.raise_on_error("leaf_maxabs", err)
        kernels.LAUNCHES["leaf_maxabs"] += 1
    return out.view(torch.float32).reshape(x.shape[:-1] + (n_leaves,))


def fake_quantize_flat(x: torch.Tensor, block_leaf, n_leaves: int,
                       bits: int = 8, block: int = BLOCK,
                       reduce_maxabs=None) -> torch.Tensor:
    """Q->DQ of block-aligned flat rows (..., N) with per-(row, leaf)
    scales max(max|x|, 1e-12) / qmax, bit for bit
    ``compress.quantize_leaf`` + ``dequantize_leaf``. On CUDA, one launch
    for all rows on the cluster route, or the max-abs launch and then the
    Q->DQ launch on the two-pass route (:func:`qdq_route`); on the CPU:
    ``ref.fake_quantize_flat_ref``. ``block_leaf`` is checked when it is
    a numpy array; pass it as an int32 tensor on the card
    (``FlatLayout.block_leaf_on``) to save the host-to-device copy.

    ``reduce_maxabs`` (the flat plane's ``max_model`` on a mesh whose
    "model" axis splits the rows' blocks) takes the (R, L) per-leaf
    max-abs of this rank's blocks and returns that of the whole rows: the
    two-pass route then runs with the reduced maxima between its passes
    (on the CPU, the plain max-abs and Q->DQ around it)."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must lie in [2, 8], got {bits}")
    if x.device.type == "cpu":
        if reduce_maxabs is not None:
            lmax = reduce_maxabs(ref.leaf_maxabs_ref(x, block_leaf, n_leaves,
                                                     block))
            return ref.qdq_from_leaf_max_ref(x, lmax, block_leaf, bits, block)
        return ref.fake_quantize_flat_ref(x, block_leaf, bits=bits,
                                          block=block, n_leaves=n_leaves)
    rows = _as_rows(x, block)
    R, n = rows.shape
    bl = _block_leaf_on(block_leaf, n // block, n_leaves, x.device)
    out = torch.empty_like(rows)
    if not rows.numel():
        return out.reshape(x.shape)
    qmax = 2.0 ** (bits - 1) - 1
    lib = _build.load("quantize.cu", _SIGNATURES)
    route = "two_pass" if reduce_maxabs is not None else qdq_route(
        n, block, n_leaves)
    if route == "cluster":
        ctas, groups, per_thread = cluster_split(n // block)
        err = lib.fake_quantize_cluster_f32(
            rows.data_ptr(), bl.data_ptr(), R, n, ctas, groups, per_thread,
            n_leaves, qmax, out.data_ptr(), _build.stream_ptr(x))
    else:
        maxabs = leaf_maxabs(rows, bl, n_leaves, block)
        if reduce_maxabs is not None:
            maxabs = reduce_maxabs(maxabs).contiguous()
        err = lib.fake_quantize_flat_f32(
            rows.data_ptr(), bl.data_ptr(), maxabs.data_ptr(), R, n, block,
            n_leaves, qmax, out.data_ptr(), _build.stream_ptr(x))
    _build.raise_on_error("fake_quantize_flat", err)
    kernels.LAUNCHES["fake_quantize_flat"] += 1
    kernels.ROUTES[f"fake_quantize_flat/{route}"] += 1
    return out.reshape(x.shape)
