"""The DP clip kernels: sum of squares (``csrc/sumsq.cu``), the per-row L2
clip and the clip-and-accumulate (``csrc/dp_clip.cu``); port of
``repro/kernels/dp_clip.py``'s ``_sumsq_kernel`` / ``sumsq``,
``_scale_kernel`` / ``clip_flat`` and ``_scale_add_kernel`` /
``clip_accumulate``.

The round engine reads ``sumsq`` for the ``delta_norm`` metric through
``core/flat.sumsq``; the async client step clips through
``core/flat.clip``, which takes the (lane, size) buffer of a whole lane in
one ``clip_flat`` call where the JAX package clips each client inside its
``vmap``. ``clip_accumulate`` is reached through ``kernels/ops`` only.

``clip_flat`` takes one of two routes, by shape alone (:func:`clip_route`):
the cluster route, one launch in which a cluster of CTAs holds a row in
registers (x read once), for rows of n % 4 == 0 and at most
``CLUSTER_MAX_BLOCKS`` 1024-element blocks; else the three-launch route
(block sums, row combine, scale). Both give the same bits.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import _build, ref

# sumsq: CTAs at most (one per SM of the H100; partials the last CTA
# combines), threads a CTA, and the fewest elements a CTA sums (one float4
# a thread); the grid comes from n alone
MAX_PARTIALS = 132
SUMSQ_THREADS = 256
SUMSQ_MIN_CHUNK = 1024
BLOCK = 1024  # the clip's norm stage sums align-blocks, as the plain version
# the clip's cluster route: CTAs a row (at most; 16, a non-portable cluster
# size: on the H100, 11, 12 and 16 CTAs of 8 warps tied at the async
# lane's (6, 89,088) and 16 led at 40 rows, chip_smoke.py --sweep) and the
# warps a CTA may have (the kernel's instances), one block a warp
CLUSTER = 16
CLUSTER_WARPS = (4, 8, 16, 32)
CLUSTER_MAX_BLOCKS = CLUSTER * CLUSTER_WARPS[-1]

_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_SIGNATURES = {"sumsq_f32": [_P, _I64, _INT, _I64, _P, _P, _P, _P]}
_CLIP_SIGNATURES = {
    "dp_clip_rows_f32": [_P, _I64, _I64, _INT, _F, _P, _P, _P, _P, _P],
    "dp_clip_accumulate_f32": [_P, _P, _I64, _INT, _F, _P, _P, _P, _P, _P],
    "dp_clip_cluster_f32": [_P, _I64, _I64, _INT, _INT, _F, _P, _P, _P],
}


# partials + arrival counter of the sumsq kernel, one per (device, stream)
_SUMSQ_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def sumsq_plan(n: int) -> Tuple[int, int]:
    """(grid, chunk) of the sumsq kernel for an n-element vector: CTA b
    sums the float4 quads [b * chunk, (b + 1) * chunk), the last CTA also
    the n % 4 tail. At least SUMSQ_MIN_CHUNK elements a CTA (87 CTAs at
    the round's 89,088), at most MAX_PARTIALS CTAs (from 135,168 on)."""
    grid = max(1, min(MAX_PARTIALS, -(-n // SUMSQ_MIN_CHUNK)))
    return grid, -(-(n // 4) // grid)


def sumsq_rtol(n: int) -> float:
    """A-priori relative bound between the sumsq kernel's result and the
    exact sum of squares of an n-element vector (u = 2**-24).

    A float32 sum of non-negative terms in which every term passes
    through at most d roundings is within (1 + u)**d - 1 of the exact sum,
    whatever the tree. Here a term is squared and added in its thread's
    fmaf chain (one rounding per step: 4 * ceil(chunk / 256) steps, plus
    the <= 3 tail elements of the last CTA's thread 0), then passes the
    CTA's 8 tree levels, the combine's ceil(grid / 256)-step chain and its
    8 tree levels."""
    grid, chunk = sumsq_plan(n)
    d = (4 * -(-chunk // SUMSQ_THREADS) + 3 + 8
         + -(-grid // SUMSQ_THREADS) + 8)
    return math.expm1(d * math.log1p(2.0 ** -24))


def _sumsq_scratch(x: torch.Tensor):
    """(scratch, stream) for ``x``'s current stream: MAX_PARTIALS floats of
    partials, then the int32 arrival counter, zeroed once when made. The
    kernel's last CTA sets the counter back to 0, so calls on one stream
    (which run in order) share it; two streams never do."""
    stream = _build.stream_ptr(x)
    key = (x.get_device(), stream)
    buf = _SUMSQ_SCRATCH.get(key)
    if buf is None:
        buf = _SUMSQ_SCRATCH[key] = torch.zeros(
            (MAX_PARTIALS + 1,), dtype=torch.int32, device=x.device)
    return buf, stream


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """sum(x**2) of a 1-D float32 vector, as a 0-d float32 tensor.

    CUDA tensor: one launch of the fixed-order kernel (grid from
    :func:`sumsq_plan`, the last CTA combines; the same bits on every
    run, within :func:`sumsq_rtol` of the exact sum). CPU tensor:
    ``ref.flat_sumsq_ref``."""
    if x.device.type == "cpu":
        return ref.flat_sumsq_ref(x)
    _build.check_cuda("sumsq", x, torch.float32, 1)
    lib = _build.load("sumsq.cu", _SIGNATURES)
    scratch, stream = _sumsq_scratch(x)
    grid, chunk = sumsq_plan(x.numel())
    out = x.new_empty(())
    base = scratch.data_ptr()
    err = lib.sumsq_f32(x.data_ptr(), x.numel(), grid, chunk, base,
                        base + 4 * MAX_PARTIALS, out.data_ptr(), stream)
    _build.raise_on_error("sumsq", err)
    kernels.LAUNCHES["sumsq"] += 1
    return out


def norm_rtol(n: int, block: int = BLOCK) -> float:
    """A-priori relative bound between the clip kernel's norm of an
    n-element row and the plain version's (first order, u = 2**-24; a
    float32 sum of m non-negative terms is within (m - 1) u of the exact
    one in any order, and a pairwise level adds u).

    Both square each element (u) and reduce each ``block`` in the same
    log2(block) halving levels. The kernel then combines the nb blocks per
    thread (ceil(nb / 256) terms) and in an 8-level tree; the plain
    version sums the nb blocks with torch.sum. A row that is not a
    multiple of ``block`` is one chunk for the plain version: halving
    levels while the width is even, then a sum of the m terms left. The
    sums of squares differ by at most the two bounds together; the norm,
    a square root, by half that plus one rounding."""
    levels = block.bit_length() - 1
    nb = -(-n // block)
    kernel = 1 + levels + -(-nb // 256) + 8
    if n % block == 0:
        plain = 1 + levels + nb
    else:
        m, k = n, 0
        while m % 2 == 0 and m > 1:
            m, k = m // 2, k + 1
        plain = 1 + k + m
    return ((kernel + plain) / 2 + 1) * 2.0 ** -24


def clip_route(n: int) -> str:
    """``"cluster"`` or ``"three_launch"``: the route ``clip_flat`` takes
    for rows of n > 0 elements. The cluster route loads 16 bytes a lane, so
    it needs n % 4 == 0 (every row then starts on the 16-byte grid), and
    holds at most CLUSTER_MAX_BLOCKS blocks of BLOCK (the last may be
    ragged) in its CTAs' registers."""
    if n % 4 == 0 and 1 <= -(-n // BLOCK) <= CLUSTER_MAX_BLOCKS:
        return "cluster"
    return "three_launch"


def clip_split(n_blocks: int) -> Tuple[int, int]:
    """(ctas, warps) of the cluster route for a row of ``n_blocks``
    blocks: the kernel gives CTA r of the row's cluster the blocks
    [r * n_blocks // ctas, (r + 1) * n_blocks // ctas), and warp w of the
    CTA its w-th block."""
    ctas = min(CLUSTER, n_blocks)
    share = -(-n_blocks // ctas)
    return ctas, next(w for w in CLUSTER_WARPS if w >= share)


def _scratch(rows: int, n: int, device):
    nb = -(-n // BLOCK)
    return (torch.empty((rows, nb), dtype=torch.float32, device=device),
            torch.empty((rows,), dtype=torch.float32, device=device))


def clip_flat(x: torch.Tensor, clip_norm: float):
    """x * min(1, C/||x||) of each row of a float32 (R, N) buffer, or of a
    (N,) vector; returns (clipped, pre-clip norms (R,) or ()).

    CUDA tensor: one launch of ``dp_clip_cluster_f32`` on the cluster
    route, or ``dp_clip_rows_f32`` (block sums, a fixed-order row combine,
    the scale) on the three-launch route (:func:`clip_route`); the same
    bits on either, and on every run. CPU tensor: ``ref.flat_clip_ref``."""
    if x.device.type == "cpu":
        return ref.flat_clip_ref(x, clip_norm, chunk=BLOCK)
    rows = x.reshape(1, -1) if x.ndim == 1 else x
    _build.check_cuda("clip_flat", rows, torch.float32, 2)
    R, n = rows.shape
    if R > 65535:
        raise ValueError("clip_flat: at most 65535 rows per launch")
    out = torch.empty_like(rows)
    if n == 0:
        norms = torch.zeros((R,), dtype=torch.float32, device=x.device)
        return out.reshape(x.shape), norms.reshape(x.shape[:-1])
    norms = torch.empty((R,), dtype=torch.float32, device=x.device)
    lib = _build.load("dp_clip.cu", _CLIP_SIGNATURES)
    route = clip_route(n)
    if route == "cluster":
        ctas, warps = clip_split(-(-n // BLOCK))
        err = lib.dp_clip_cluster_f32(rows.data_ptr(), R, n, ctas, warps,
                                      float(clip_norm), norms.data_ptr(),
                                      out.data_ptr(), _build.stream_ptr(x))
    else:
        bss, scales = _scratch(R, n, x.device)
        err = lib.dp_clip_rows_f32(rows.data_ptr(), R, n, BLOCK,
                                   float(clip_norm), bss.data_ptr(),
                                   norms.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), _build.stream_ptr(x))
    _build.raise_on_error("clip_flat", err)
    kernels.LAUNCHES["clip_flat"] += 1
    kernels.ROUTES[f"clip_flat/{route}"] += 1
    return out.reshape(x.shape), norms.reshape(x.shape[:-1])


def clip_accumulate(acc: torch.Tensor, x: torch.Tensor, clip_norm: float):
    """acc + x * min(1, C/||x||) of float32 (N,) vectors; returns (new acc,
    pre-clip norm ()).

    CUDA tensors: ``dp_clip_accumulate_f32`` (the clip's norm stage, then
    one fused scale-and-add). CPU tensors:
    ``ref.dp_clip_accumulate_ref``."""
    if x.device.type == "cpu" and acc.device.type == "cpu":
        return ref.dp_clip_accumulate_ref(acc, x, clip_norm)
    _build.check_cuda("clip_accumulate", x, torch.float32, 1)
    _build.check_cuda("clip_accumulate", acc, torch.float32, 1)
    if acc.shape != x.shape:
        raise ValueError(f"clip_accumulate: acc {tuple(acc.shape)} and x "
                         f"{tuple(x.shape)} differ")
    n = x.numel()
    if n == 0:
        return acc.clone(), torch.zeros((), dtype=torch.float32,
                                        device=x.device)
    out = torch.empty_like(x)
    norm = torch.empty((1,), dtype=torch.float32, device=x.device)
    bss, scale = _scratch(1, n, x.device)
    lib = _build.load("dp_clip.cu", _CLIP_SIGNATURES)
    err = lib.dp_clip_accumulate_f32(acc.data_ptr(), x.data_ptr(), n, BLOCK,
                                     float(clip_norm), bss.data_ptr(),
                                     norm.data_ptr(), scale.data_ptr(),
                                     out.data_ptr(), _build.stream_ptr(x))
    _build.raise_on_error("clip_accumulate", err)
    kernels.LAUNCHES["clip_accumulate"] += 1
    return out, norm.reshape(())
