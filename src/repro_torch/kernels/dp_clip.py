"""Sum of squares of a flat vector: the CUDA kernel of ``csrc/sumsq.cu``
(port of ``repro/kernels/dp_clip.py``'s ``_sumsq_kernel`` / ``sumsq``).

The round engine reads it for the ``delta_norm`` metric through
``core/flat.sumsq``. The clip kernels of the JAX module (``clip_flat``,
``clip_accumulate``) are not on this slice's path and are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build, ref

# stage-1 partial sums at most; the kernel picks its grid from n alone
MAX_PARTIALS = 1024

_SIGNATURES = {"sumsq_f32": [ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p]}


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
