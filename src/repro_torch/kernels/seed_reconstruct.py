"""Deterministic Gaussian tensors from (seed, leaf): the CUDA kernel of
``csrc/seed_reconstruct.cu`` (port of ``repro/kernels/seed_reconstruct.py``'s
``_seed_kernel`` / ``seed_reconstruct``).

A counter-based squirrel3 hash of (seed, leaf, element index) and a
Box-Muller transform: every element is a pure function of its index, so
the tensor is the same however it is tiled or which device makes it. No
engine of either package calls it; ``kernels/ops.seed_reconstruct`` does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.kernels import _build, ref

LANES = 128  # the output's cols are padded to this, as the TPU's lanes
THREADS = 256  # a CUDA block: that many runs of 16 bytes along one row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 2 ** 31 - 1

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"seed_reconstruct_fwd": [_P, _INT, _I64, _I64, _I64, _I64,
                                        ctypes.c_uint32, ctypes.c_float, _P,
                                        _P]}


def seed_plan(rows: int, cols: int, itemsize: int):
    """(run, cpad, tiles) of the kernel for a (rows, cols) leaf of
    ``itemsize``-byte elements: a thread writes ``run`` consecutive
    elements (16 bytes), the cols are padded to ``cpad`` (a multiple of
    128) and each row takes ``tiles`` CUDA blocks of THREADS runs; the 1-D
    grid has rows * tiles blocks."""
    run = 16 // itemsize
    cpad = -(-cols // LANES) * LANES
    return run, cpad, -(-cpad // (THREADS * run))


def seed_threads(block, thread, rows: int, cols: int, itemsize: int):
    """The kernel's thread -> run map, elementwise over numpy arrays of
    block and thread indices: (row, first col, live, 32-bit counter of the
    first element), computed as the kernel computes them (uint32, one
    division a thread). A thread is live when its run starts inside the
    padded row; the run's k-th element has counter + k (mod 2**32)."""
    run, cpad, tiles = seed_plan(rows, cols, itemsize)
    block = np.asarray(block, np.uint32)
    thread = np.asarray(thread, np.uint32)
    r = block // np.uint32(tiles)
    c0 = ((block - r * np.uint32(tiles)) * np.uint32(THREADS) + thread) \
        * np.uint32(run)
    return r, c0, c0 < np.uint32(cpad), r * np.uint32(cols) + c0


def _launch(seed: int, leaf_id: int, shape, stddev: float, dtype, dev,
            with_bits: bool):
    if dtype not in _DTYPES:
        raise TypeError(f"seed_reconstruct: {dtype} is not supported")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"seed_reconstruct: {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    rows, cols = ref.seed_dims(shape)
    run, cpad, tiles = seed_plan(rows, cols, dtype.itemsize)
    if rows * tiles > _MAX_GRID or cpad > _MAX_GRID:
        raise ValueError(f"seed_reconstruct: {tuple(shape)} is past the "
                         f"kernel's 2**31 - 1 blocks or columns")
    out = torch.empty((rows, cpad), dtype=dtype, device=dev)
    bits = (torch.empty((2, rows, cols), dtype=torch.int32, device=dev)
            if with_bits else None)
    if rows * cols:
        lib = _build.load("seed_reconstruct.cu", _SIGNATURES)
        err = lib.seed_reconstruct_fwd(
            out.data_ptr(), _DTYPES[dtype], rows, cols, cpad, tiles,
            ref.seed_word(seed, leaf_id), float(np.float32(stddev)),
            bits.data_ptr() if with_bits else None, _build.stream_ptr(out))
        _build.raise_on_error("seed_reconstruct", err)
        kernels.LAUNCHES["seed_reconstruct"] += 1
    return out[:, :cols].reshape(tuple(shape)), bits


def seed_reconstruct(seed: int, leaf_id: int, shape, stddev: float,
                     dtype=torch.float32, device=None):
    """The deterministic Gaussian tensor of ``shape`` (std ``stddev``) of
    leaf ``leaf_id`` under the integer ``seed``.

    On the card (the default): the kernel. ``device="cpu"``:
    ``ref.seed_reconstruct_plain``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ref.seed_reconstruct_plain(seed, leaf_id, shape, stddev, dtype)
    return _launch(seed, leaf_id, shape, stddev, dtype, dev, False)[0]


def seed_bits(seed: int, leaf_id: int, shape, device=None):
    """The kernel's two squirrel3 words of every element, (b1, b2) each
    int64 in [0, 2**32) of shape (rows, cols): what a check compares bit
    for bit. ``device="cpu"``: ``ref.seed_bits_plain``."""
    dev = resolve_device(device)
    rows, cols = ref.seed_dims(shape)
    if dev.type == "cpu":
        return ref.seed_bits_plain(seed, leaf_id, rows, cols)
    bits = _launch(seed, leaf_id, shape, 1.0, torch.float32, dev, True)[1]
    words = bits.to(torch.int64) & ref.M32
    return words[0], words[1]
