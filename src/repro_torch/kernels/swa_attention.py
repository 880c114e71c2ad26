"""Causal (optionally with a bidirectional prefix, optionally
sliding-window) or non-causal flash attention: the CUDA kernel of
``csrc/swa_attention.cu`` (port of ``repro/kernels/swa_attention.py``'s
``_swa_kernel`` / ``swa_attention``).

``nn/attention.flash_attention`` calls it, through ``kernels/ops``, in
every attention layer of the decoder LM's prefill on the card. It takes
q's heads and k/v's (fewer, under GQA) heads as they are, and strided
views: the model's (B, S, H, D) tensors go in transposed, with no copy.
bf16 and fp16 run on the tensor cores (wgmma, TMA-fed K/V ring), float32
on the CUDA cores; :func:`tile_plan` is the CPU twin of the tiles the
tensor-core kernel reads and masks. v's head dim may differ from q's and
k's (MLA: 192-wide q / k heads, 128-wide v heads); the kernels are built
for (q/k, v) head dims (64, 64), (128, 128), (192, 128) and (256, 128),
and a v head dim above 128 runs as 128-wide column slices, one a
``blockIdx.z`` (PaliGemma's 256 / 256). The causal mask may carry a
bidirectional prefix of ``prefix_len`` keys (PaliGemma's image
positions); a non-causal call may take other rows in q than in k and v
(Whisper's cross-attention).

Two modes for bf16 / fp16. The default keeps p at float32 accuracy, the
TPU kernel's function (``ops.swa_attention`` keeps its parity with the
Pallas ``_swa_kernel``). ``round_p=True`` rounds p to v's dtype once
before p.v, the function of the reference's ``nn/attention
.flash_attention``, which the card's ``flash_attention`` runs; its plain
version is ``ref.chunked_attention_ref(..., chunk=BK)`` and
:func:`round_p_tolerance` its a-priori bound.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import _build, ref

# the largest q / k head dim and v head dim the kernel's instances hold
# (v above 128 through 128-wide slices)
MAX_QK_DIM, MAX_V_DIM = 256, 256
# the tensor-core kernel's q rows per block (two warpgroups of 64) and keys
# per KV tile
BQ, BK = 128, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"swa_attention_fwd": [_P, _P, _P, _P, _INT, _INT, _INT, _INT,
                                     _INT, _INT, _INT, _INT] + [_I64] * 12
               + [_INT, _INT, _INT, ctypes.c_float, _INT, _P]}
# half an ulp of each output type, relative: one rounding to nearest
HALF_ULP = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}


def _check(q, k, v, out, window: int, causal: bool, prefix_len: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device.type != "cuda":
            raise ValueError(f"swa_attention: {name} is not a CUDA tensor "
                             f"({t.device})")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"swa_attention: {name} on {t.device}, current "
                             f"device is cuda:{torch.cuda.current_device()}")
        if t.dtype != q.dtype:
            raise TypeError(f"swa_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.ndim != 4 or (t.shape[-1] > 1 and t.stride(-1) != 1):
            raise ValueError(f"swa_attention: {name} must be 4-d with a "
                             f"contiguous head dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"swa_attention: {q.dtype} is not supported")
    B, H, S, D = q.shape
    skv, DV = k.shape[2], v.shape[-1]
    if k.shape != (B, k.shape[1], skv, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"swa_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if skv != S and (causal or window > 0):
        raise ValueError(f"swa_attention: {S} q rows against {skv} keys: "
                         f"only a non-causal call without a window takes "
                         f"other rows in q than in k")
    if skv == 0:
        raise ValueError("swa_attention: no keys")
    if not 0 <= prefix_len <= skv:
        raise ValueError(f"swa_attention: prefix_len {prefix_len} outside "
                         f"[0, {skv}]")
    if out.shape != (B, H, S, DV):
        raise ValueError(f"swa_attention: out {tuple(out.shape)} is not "
                         f"{(B, H, S, DV)}")
    if H % k.shape[1]:
        raise ValueError(f"swa_attention: {H} q heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if not 0 < D <= MAX_QK_DIM:
        raise ValueError(f"swa_attention: q / k head dim {D} outside (0, "
                         f"{MAX_QK_DIM}]")
    if not 0 < DV <= MAX_V_DIM:
        raise ValueError(f"swa_attention: v head dim {DV} outside (0, "
                         f"{MAX_V_DIM}]")
    if B * H > 65535:
        raise ValueError("swa_attention: batch * heads above 65535")


def swa_attention(q, k, v, window: int = 0, causal: bool = True, out=None,
                  round_p: bool = False, prefix_len: int = 0):
    """softmax(mask(q k^T / sqrt(D))) v: q (B, H, Sq, D), k (B, KVH, Skv,
    D) and v (B, KVH, Skv, DV) with H a multiple of KVH (q head h reads kv
    head h // (H // KVH)), D <= 256 and DV <= 256. The mask keeps the keys
    k <= q, or k < ``prefix_len`` (a bidirectional prefix), under
    ``causal``, every key otherwise; ``window`` > 0 then keeps only those
    with ``q - k < window``. Sq may differ from Skv only in a non-causal
    call without a window. Returns (B, H, Sq, DV) in q's dtype, written
    into ``out`` when given.

    CUDA tensors: the ``swa_attention`` kernel, which reads only the KV
    tiles inside the window (float32 scores and online softmax over
    64-key tiles). By default p keeps float32 accuracy (bf16 / fp16 p as
    two terms on the tensor cores, ``ref.split_p``); ``round_p`` rounds p
    to v's dtype once, as the reference's ``flash_attention`` does (one
    product on the tensor cores; float32 is unchanged). CPU tensors:
    ``ref.swa_attention_ref``, or with ``round_p``
    ``ref.chunked_attention_ref`` at the kernel's 64-key tiles."""
    if q.device.type == "cpu":
        if round_p:
            res = ref.chunked_attention_ref(q, k, v, window, causal, chunk=BK,
                                            prefix_len=prefix_len)
        else:
            res = ref.swa_attention_ref(q, k, v, window, causal,
                                        prefix_len=prefix_len).to(q.dtype)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                          device=q.device)
    _check(q, k, v, out, window, causal, prefix_len)
    B, H, S, D = q.shape
    if S == 0:
        return out
    lib = _build.load("swa_attention.cu", _SIGNATURES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    err = lib.swa_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), _DTYPES[q.dtype], B, H,
                                k.shape[1], S, k.shape[2], D, v.shape[-1],
                                *strides, int(window), int(causal),
                                int(prefix_len), scale, int(round_p),
                                _build.stream_ptr(q))
    _build.raise_on_error("swa_attention", err)
    kernels.LAUNCHES["swa_attention"] += 1
    return out


def round_p_tolerance(q, k, v, window: int, causal: bool, got, want,
                      prefix_len: int = 0):
    """The per-element bound on |got - want| between the ``round_p``
    kernel's output ``got`` and its plain version's ``want``
    (``ref.chunked_attention_ref(..., chunk=BK)``), both in q's dtype:

        u (|got| + |want|) + 2 u max|v| / l + 1e-5,   u = HALF_ULP[dtype].

    Both compute the same roundings of the same float32 quantities: the
    running max moves at the same keys, so each p is rounded at the same
    scale. What remains: (a) float32 summation order in q.k^T and p.v and
    ``expf`` against torch's ``exp``, ~1e-6 at O(1) outputs, inside the
    absolute 1e-5; (b) the output's own rounding, half an ulp on each
    side, u (|got| + |want|) (a float32 difference straddling a midpoint
    moves the rounded value by one ulp); (c) a bf16 / fp16 rounding of p
    that flips where the float32 p of the two sides falls on either side
    of a midpoint: one ulp, at most 2 u p_j, so 2 u p_j |v_j| / l of the
    output; p_j <= 1 at the row's max, so one flip of the row's largest
    term is 2 u max|v| / l, with 1 / l = ``ref.swa_softmax_peak``. A p
    flips with a probability of about its float32 error over its
    rounding's spacing (~2**-12 in bf16), so a row sees a few flips of
    typical terms, far below one of its largest."""
    u = HALF_ULP[q.dtype]
    peak = ref.swa_softmax_peak(q, k, window, causal, prefix_len=prefix_len)
    vmax = float(v.float().abs().max())
    return (u * (got.float().abs() + want.float().abs())
            + 2 * u * vmax * peak[..., None] + 1e-5)


def _key_lo(r: int, window: int) -> int:
    return max(r - window + 1, 0) if window > 0 else 0


def _key_hi(r: int, skv: int, causal: bool, prefix_len: int) -> int:
    return max(r, prefix_len - 1) if causal else skv - 1


def visible_pairs(S: int, window: int, causal: bool = True,
                  prefix_len: int = 0, skv=None) -> int:
    """The (q, k) pairs the mask lets through, per (batch, head), for
    ``S`` q rows against ``skv`` keys (default ``S``): the operations'
    count behind the kernel's bound."""
    skv = S if skv is None else skv
    return sum(max(min(_key_hi(r, skv, causal, prefix_len), skv - 1)
                   - _key_lo(r, window) + 1, 0) for r in range(S))


def tile_plan(S: int, window: int, causal: bool = True, bq: int = BQ,
              bk: int = BK, prefix_len: int = 0, skv=None):
    """The KV tiles the tensor-core kernel reads for each ``bq``-row q tile
    of ``S`` rows against ``skv`` keys (default ``S``), as
    ``csrc/swa_attention.cu`` computes them: a list of (first, last,
    masked), one per q tile. Row r sees keys [lo(r), hi(r)] (lo = r -
    window + 1 clipped at 0, or 0 without a window; hi = max(r,
    prefix_len - 1) under the causal mask, else skv - 1), both
    nondecreasing in r, so tile t is read when it lies in [lo(q0) // bk,
    hi(q_last) // bk], and needs the per-element mask unless it is whole
    (inside skv) and visible from every row: t * bk >= lo(q_last) and (t +
    1) * bk - 1 <= hi(q0). A block of the kernel reads and computes the
    tiles of ``tile_plan(bq=128)``; each of its two warpgroups masks a
    tile of that range unless it is one of ``tile_plan(bq=64)``'s unmasked
    tiles for its 64 rows."""
    skv = S if skv is None else skv
    plan = []
    for q0 in range(0, S, bq):
        q_last = min(q0 + bq, S) - 1
        first = _key_lo(q0, window) // bk
        last = _key_hi(q_last, skv, causal, prefix_len) // bk
        full_lo = _key_lo(q_last, window)
        full_hi = _key_hi(q0, skv, causal, prefix_len)
        masked = tuple(t for t in range(first, last + 1)
                       if not (t * bk >= full_lo and (t + 1) * bk - 1 <= full_hi
                               and (t + 1) * bk <= skv))
        plan.append((first, last, masked))
    return plan
