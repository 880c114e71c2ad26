"""Threefry-2x32 in torch: the counter-based PRNG behind ``jax.random``,
in its partitionable form (``repro/__init__.py`` sets
``jax_threefry_partitionable``).

FedPT regenerates every frozen leaf on the client from one scalar seed
(Algorithm 1, line 5), so the port has to draw the very bits JAX draws.
The reference is jax 0.9.0's ``jax/_src/prng.py`` (``threefry_seed``,
``iota_2x32_shape``, ``_threefry2x32_lowering``, ``_threefry_fold_in``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``)
and ``jax/_src/random.py`` (``_randint``, ``_uniform``, ``_normal_real``,
``_gumbel`` in its default "low" mode, ``categorical`` with replacement).

torch has no full uint32 arithmetic, so a 32-bit word is held in int64
and masked to 32 bits after every add and shift. The same functions take
Python ints (key derivation on the host) and int64 tensors (bulk bits on
the device). A key is a pair of Python ints.

Bulk draws (:func:`random_bits`, :func:`uniform`, :func:`normal`) fill
their output ``PIECE`` elements at a time: element i's counter is its
row-major index whatever the piece, so the result is the whole draw's
bits, while the int64 temporaries of the hash stay a piece long (a 1.26 G
-value expert leaf would otherwise need several 10 GB temporaries).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import _mul32

Key = Tuple[int, int]

M32 = 0xFFFFFFFF
# 0-d constants on a device, by (value, dtype, device): made once, so a
# draw on the card makes no blocking host-to-device copy of a scalar
_CONSTS: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements a bulk draw hashes at once
PIECE = 1 << 26
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); inputs and outputs are uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a 32-bit integer seed: (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed <= M32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return (0, seed & M32)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the counter pair (0, data) under k."""
    return threefry2x32(k[0], k[1], 0, int(data) & M32)


def split(k: Key, num: int = 2):
    """``jax.random.split(k, num)`` in partitionable form: key i is the
    hash pair (both words kept) of the counter (0, i) under k. Returns a
    list of ``num`` keys."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(int(num))]


def constant(value: float, dtype, device=None) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, made once per
    (value, dtype, device) and reused: read-only. The key holds the
    value's repr, so that -0.0 and 0.0 stay apart."""
    device = torch.device("cpu" if device is None else device)
    key = (repr(float(value)), dtype, device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def _bits(k: Key, start: int, stop: int, device) -> torch.Tensor:
    """The bits of the elements [start, stop) of a draw: the counter of
    each is its row-major index, split into (hi, lo) words; the two hash
    words are xor-ed."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & M32)
    return b1 ^ b2


def _in_pieces(shape, dtype, device, piece_fn) -> torch.Tensor:
    """A tensor of ``shape`` whose elements [a, b) in row-major order are
    ``piece_fn(a, b)``, filled PIECE elements at a time (a draw of one
    piece is returned as it is made). On the meta device (shapes only) the
    pieces hold no values, so one empty tensor stands for them."""
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    if n <= PIECE:
        return piece_fn(0, n).reshape(tuple(shape))
    out = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, PIECE):
        b = min(a + PIECE, n)
        out[a:b] = piece_fn(a, b)
    return out.reshape(tuple(shape))


def random_bits(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64 values in
    [0, 2**32)."""
    return _in_pieces(shape, torch.int64, device,
                      lambda a, b: _bits(k, a, b, device))


def uniform(k: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in float32, bfloat16 or float16: random
    mantissa bits under the exponent of 1.0 give [1, 2), shifted and
    scaled to the range in ``dtype``'s arithmetic. float32 takes the top
    23 of 32 bits; a 16-bit type takes the low 8 (bfloat16, 7 mantissa
    bits) or 16 (float16) bits of the 32-bit word, as JAX draws them, and
    keeps the top ``nmant`` of those."""
    return _in_pieces(shape, dtype, device, lambda a, b: _uniform(
        _bits(k, a, b, device), minval, maxval, dtype))


def _uniform(bits, minval: float, maxval: float, dtype) -> torch.Tensor:
    """:func:`uniform` of the given bits."""
    if dtype == torch.float32:
        mant = (bits >> 9) | 0x3F800000
        floats = mant.to(torch.int32).view(torch.float32) - 1.0
    else:
        nmant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
        width = 8 if nmant < 8 else 16
        one = torch.tensor(1.0, dtype=dtype).view(torch.int16).item()
        mant = ((bits & ((1 << width) - 1)) >> (width - nmant)) | one
        floats = mant.to(torch.int16).view(dtype) - 1.0
    lo = constant(minval, dtype, floats.device)
    hi = constant(maxval, dtype, floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: Key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode:
    ``-log(-log(u))`` with u uniform on [tiny, 1), every op in ``dtype``.
    The uniform's bits are JAX's exactly; the logs round as the library's
    do (:func:`gumbel_tolerance`)."""
    u = uniform(k, shape, torch.finfo(dtype).tiny, 1.0, device, dtype)
    return -torch.log(-torch.log(u))


def gumbel_tolerance(g: torch.Tensor) -> torch.Tensor:
    """How far two libraries' Gumbel draws from the same uniform may lie
    apart: each log is within one ulp (eps relative, eps the dtype's
    ``finfo.eps``), the inner log's relative error passes to the outer
    one as an absolute error eps, and both libraries err, so
    |g - g'| <= 2 eps (1 + |g|). In a 16-bit type the inner log rounds to
    that type, so the two agree unless their float32 logs straddle a
    rounding boundary, which moves g by about one ulp, within the bound."""
    eps = torch.finfo(g.dtype).eps
    return 2 * eps * (1 + g.float().abs())


def categorical(k: Key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis)`` with replacement: the
    argmax (first on ties, as ``jnp.argmax``) of ``gumbel + logits`` in
    the logits' dtype, one draw per distribution. Returns int32."""
    g = gumbel(k, tuple(logits.shape), logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=axis).to(torch.int32)


def randint(k: Key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` at its default
    int32: two draws of 32 bits (under the two keys of ``split(k)``),
    combined modulo the span as ``_randint`` does in uint32 arithmetic,
    whose products wrap at 2**32 as XLA's do: the multiplier
    (2**16 % span)**2 is 0 for a span above 2**16, so the high draw then
    drops out. Returns int32 values in [minval, maxval); bounds outside
    int32 raise, as JAX's do."""
    lo, hi = int(minval), int(maxval)
    if not (-(1 << 31) <= lo < (1 << 31) and -(1 << 31) <= hi < (1 << 31)):
        raise ValueError(f"randint bounds ({lo}, {hi}) do not fit int32")
    span = (hi - lo) if hi > lo else 1
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape, device), random_bits(k2, shape,
                                                                device)
    mult = ((1 << 16) % span) ** 2 % (1 << 32) % span   # 0 once span > 2**16
    offset = (_mul32(higher % span, mult) + lower % span) % (1 << 32) % span
    return (lo + offset).to(torch.int32)   # in [lo, hi): no int32 wrap


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))

# XLA's float32 erfinv: Giles' single-precision polynomial in
# w = -log1p(-x^2), one branch below w = 5 and one above
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` polynomial. ``torch.erfinv`` differs
    from it by up to ~60 ulps; this stays within 2 ulps (``log1p`` and
    fused multiply-adds round differently across libraries)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, constant(_ERFINV_W_LT_5[i], x.dtype, x.device),
                           constant(_ERFINV_W_GE_5[i], x.dtype, x.device))

    p = coeff(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = torch.addcmul(coeff(i), p, w)
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def _normal_piece(k: Key, a: int, b: int, device) -> torch.Tensor:
    u = _uniform(_bits(k, a, b, device), _NORMAL_LO, 1.0, torch.float32)
    return _SQRT2 * erfinv(u)


def normal(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u) with u
    uniform on (-1, 1). The bits and u are JAX's exactly; the values
    agree to a few ulps (see :func:`erfinv`)."""
    return _in_pieces(shape, torch.float32, device,
                      lambda a, b: _normal_piece(k, a, b, device))


def normal_range(k: Key, start: int, stop: int, device=None) -> torch.Tensor:
    """The elements [start, stop) of a flat ``normal(k, (n,))`` draw for
    any n >= stop, bit for bit (each element is a function of its counter
    alone), drawn PIECE elements at a time: a rank's columns of a draw
    over a mesh."""
    return _in_pieces((stop - start,), torch.float32, device,
                      lambda a, b: _normal_piece(k, start + a, start + b,
                                                 device))
