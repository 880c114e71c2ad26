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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build, ref

# stage-1 partial sums at most; the kernel picks its grid from n alone
MAX_PARTIALS = 1024
BLOCK = 1024  # the clip's norm stage sums align-blocks, as the plain version

_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_SIGNATURES = {"sumsq_f32": [_P, _I64, _P, _INT, _P, _P]}
_CLIP_SIGNATURES = {
    "dp_clip_rows_f32": [_P, _I64, _I64, _INT, _F, _P, _P, _P, _P, _P],
    "dp_clip_accumulate_f32": [_P, _P, _I64, _INT, _F, _P, _P, _P, _P, _P],
}


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """sum(x**2) of a 1-D float32 vector, as a 0-d float32 tensor.

    CUDA tensor: the two-stage fixed-order kernel (same bits on every
    run). CPU tensor: ``ref.flat_sumsq_ref``."""
    if x.device.type == "cpu":
        return ref.flat_sumsq_ref(x)
    _build.check_cuda("sumsq", x, torch.float32, 1)
    lib = _build.load("sumsq.cu", _SIGNATURES)
    partials = torch.empty((MAX_PARTIALS,), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.sumsq_f32(x.data_ptr(), x.numel(), partials.data_ptr(),
                        MAX_PARTIALS, out.data_ptr(), _build.stream_ptr(x))
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


def _scratch(rows: int, n: int, device):
    nb = -(-n // BLOCK)
    return (torch.empty((rows, nb), dtype=torch.float32, device=device),
            torch.empty((rows,), dtype=torch.float32, device=device))


def clip_flat(x: torch.Tensor, clip_norm: float):
    """x * min(1, C/||x||) of each row of a float32 (R, N) buffer, or of a
    (N,) vector; returns (clipped, pre-clip norms (R,) or ()).

    CUDA tensor: ``dp_clip_rows_f32`` (block sums, a fixed-order row
    combine, the scale; same bits on every run). CPU tensor:
    ``ref.flat_clip_ref``."""
    if x.device.type == "cpu":
        return ref.flat_clip_ref(x, clip_norm, chunk=BLOCK)
    rows = x.reshape(1, -1) if x.ndim == 1 else x
    _build.check_cuda("clip_flat", rows, torch.float32, 2)
    R, n = rows.shape
    if R > 65535:
        raise ValueError("clip_flat: at most 65535 rows per launch")
    out = torch.empty_like(rows)
    norms = torch.zeros((R,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.reshape(x.shape), norms.reshape(x.shape[:-1])
    bss, scales = _scratch(R, n, x.device)
    lib = _build.load("dp_clip.cu", _CLIP_SIGNATURES)
    err = lib.dp_clip_rows_f32(rows.data_ptr(), R, n, BLOCK, float(clip_norm),
                               bss.data_ptr(), norms.data_ptr(),
                               scales.data_ptr(), out.data_ptr(),
                               _build.stream_ptr(x))
    _build.raise_on_error("clip_flat", err)
    kernels.LAUNCHES["clip_flat"] += 1
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
