"""The fused server aggregation tail, stats -> pack -> apply: the CUDA
kernels of ``csrc/agg_tail.cu`` (port of ``repro/kernels/agg_tail.py``'s
``_stats_kernel`` / ``block_stats``, ``_pack_kernel`` / ``pack`` and
``_apply_kernel`` / ``apply_coeff``) and :func:`compose`, which runs the
whole tail (quarantine screen, int-k quantize, clip fold, weighted or
fixed-denominator mean, DP noise) in at most three reads of the (K, N)
delta buffer plus one (N,) write:

1. **stats**: per-(row, block) max|x| and sum of squares in one read. The
   max-abs gives the per-leaf quantization scales and the row-finite
   flag; the sums give the raw row norms the screen needs, bit for bit
   those of ``core/sanitize.screen_rows``' own sweep.
2. **pack**: int8 codes (a quarter of the bytes for the apply read) and
   the quantized row sum of squares the clip folds into the weights.
3. **apply**: one read of the codes into the weighted mean, starting
   from the pre-drawn noise, and one write of the update.

Each wrapper launches its kernel for a CUDA tensor (counting it in
``kernels.LAUNCHES``) and runs the plain version of ``kernels/ref.py``
for a CPU one. ``compose`` picks its engine from the buffer's device:
``"torch"`` (the plain versions) for a CPU buffer, ``"cuda"`` (always
the kernels, which raise for a tensor that is not on the card) for any
other. The scales and the exact apply (a column-chunked GEMV,
``torch.matmul``) are plain torch on both, as the JAX package leaves
them to XLA.

Contract with the staged route (``kernels/ops._staged_tail``), held by
the tests: quantize-only is bitwise equal (the codes dequantize to the
staged Q->DQ output and the exact apply is the same GEMV); quantize with
clip and/or noise is fp round-off close (the clip reads the quantized
sum of squares, and the apply folds scale x clip x weight / denominator
into one coefficient per (row, block)). Screen decisions are equal on
both routes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.core import flat as flat_lib
from repro_torch.core import sanitize as sanitize_lib
from repro_torch.kernels import _build, ref

BLOCK = 1024  # must equal the layout's `align`

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "agg_block_stats_f32": [_P, _I64, _I64, _INT, _P, _P, _P],
    "agg_pack_f32": [_P, _P, _I64, _I64, _INT, ctypes.c_float, _P, _P, _P,
                     _P],
    "agg_apply_coeff_f32": [_P, _P, _P, _I64, _I64, _INT, _P, _P],
    "agg_row_combine_f32": [_P, _I64, _I64, _P, _P],
}


def _lib():
    return _build.load("agg_tail.cu", _SIGNATURES)


def _check_block(block: int, n: int) -> int:
    """The block count of an (., n) buffer; the kernels take a power-of-two
    block in [64, 2048] that divides n."""
    if block < 64 or block > 2048 or block & (block - 1):
        raise ValueError(f"block must be a power of two in [64, 2048], "
                         f"got {block}")
    if n % block:
        raise ValueError(f"row length {n} is not a multiple of block {block}")
    return n // block


def _check_rows(name: str, rows: int) -> None:
    if rows > 65535:
        raise ValueError(f"{name}: at most 65535 rows per launch")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The stats and pack kernels read 16 bytes a load."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the buffer must be 16-byte aligned")


def _stats_cuda(mat: torch.Tensor, block: int):
    _build.check_cuda("block_stats", mat, torch.float32, 2)
    K, N = mat.shape
    _check_aligned("block_stats", mat)
    nb = _check_block(block, N)
    bmax = torch.empty((K, nb), dtype=torch.float32, device=mat.device)
    bsumsq = torch.empty_like(bmax)
    if mat.numel():
        err = _lib().agg_block_stats_f32(mat.data_ptr(), K, N, block,
                                         bmax.data_ptr(), bsumsq.data_ptr(),
                                         _build.stream_ptr(mat))
        _build.raise_on_error("block_stats", err)
        kernels.LAUNCHES["block_stats"] += 1
    return bmax, bsumsq


def _pack_cuda(mat: torch.Tensor, sblock: torch.Tensor, bits: int,
               block: int):
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must lie in [2, 8], got {bits}")
    _build.check_cuda("pack", mat, torch.float32, 2)
    _build.check_cuda("pack (scales)", sblock, torch.float32, 2)
    K, N = mat.shape
    _check_aligned("pack", mat)
    nb = _check_block(block, N)
    if sblock.shape != (K, nb):
        raise ValueError(f"pack: scales of shape {tuple(sblock.shape)}, "
                         f"expected {(K, nb)}")
    q = torch.empty((K, nb, block), dtype=torch.int8, device=mat.device)
    bqss = torch.empty((K, nb), dtype=torch.float32, device=mat.device)
    # the combine writes every row; a row of no blocks sums to 0
    qss = (torch.empty if mat.numel() else torch.zeros)(
        (K,), dtype=torch.float32, device=mat.device)
    if mat.numel():
        err = _lib().agg_pack_f32(mat.data_ptr(), sblock.data_ptr(), K, N,
                                  block, 2.0 ** (bits - 1) - 1, q.data_ptr(),
                                  bqss.data_ptr(), qss.data_ptr(),
                                  _build.stream_ptr(mat))
        _build.raise_on_error("pack", err)
        kernels.LAUNCHES["pack"] += 1
    return q, qss, bqss


def _row_combine_cuda(bqss: torch.Tensor) -> torch.Tensor:
    """(K, nb) per-block quantized sums of squares -> (K,) in the order
    pack's own combine takes: on a mesh, the blocks gathered whole give
    the unmeshed qss bit for bit. Counted as a route of pack."""
    _build.check_cuda("pack (row combine)", bqss, torch.float32, 2)
    K, nb = bqss.shape
    _check_rows("pack (row combine)", K)
    qss = torch.zeros((K,), dtype=torch.float32, device=bqss.device)
    if K and nb:
        bqss = bqss.contiguous()
        err = _lib().agg_row_combine_f32(bqss.data_ptr(), K, nb,
                                         qss.data_ptr(),
                                         _build.stream_ptr(bqss))
        _build.raise_on_error("pack (row combine)", err)
        kernels.ROUTES["pack/row_combine"] += 1
    return qss


def _apply_cuda(q: torch.Tensor, coeff: torch.Tensor,
                noise: Optional[torch.Tensor], block: int):
    _build.check_cuda("apply_coeff (codes)", q, torch.int8, 3)
    _build.check_cuda("apply_coeff (coeff)", coeff, torch.float32, 2)
    K, nb, blk = q.shape
    if blk != block or coeff.shape != (K, nb):
        raise ValueError(f"apply_coeff: codes {tuple(q.shape)} and coeff "
                         f"{tuple(coeff.shape)} do not match block {block}")
    _check_rows("apply_coeff", K)
    N = nb * block
    _check_block(block, N)
    if noise is not None:
        _build.check_cuda("apply_coeff (noise)", noise, torch.float32, 1)
        if noise.numel() != N or noise.data_ptr() % 16:
            raise ValueError(f"apply_coeff: noise must be a 16-byte "
                             f"aligned ({N},) vector")
    out = torch.empty((N,), dtype=torch.float32, device=q.device)
    if N:
        err = _lib().agg_apply_coeff_f32(
            q.data_ptr(), coeff.data_ptr(),
            None if noise is None else noise.data_ptr(), K, N, block,
            out.data_ptr(), _build.stream_ptr(q))
        _build.raise_on_error("apply_coeff", err)
        kernels.LAUNCHES["apply_coeff"] += 1
    return out


def block_stats(mat: torch.Tensor, block: int = BLOCK):
    """(K, N) float32 -> per-(row, block) (max|x|, sum of squares), each
    (K, N // block) float32, in one read. CUDA: the stats kernel; CPU:
    ``ref.agg_block_stats_ref``."""
    if mat.device.type == "cpu":
        return ref.agg_block_stats_ref(mat, block, with_sumsq=True)
    return _stats_cuda(mat, block)


def pack(mat: torch.Tensor, sblock: torch.Tensor, bits: int = 8,
         block: int = BLOCK):
    """(K, N), (K, NB) scales -> ((K, NB, block) int8 codes, (K,) quantized
    row sum of squares). CUDA: the pack kernel and its row combine; CPU:
    ``ref.agg_pack_ref`` and ``ref.agg_quant_sumsq_ref``."""
    if mat.device.type == "cpu":
        q = ref.agg_pack_ref(mat, sblock, bits, block)
        return q, ref.agg_quant_sumsq_ref(q, sblock)
    return _pack_cuda(mat, sblock, bits, block)[:2]


def apply_coeff(q: torch.Tensor, coeff: torch.Tensor,
                noise: Optional[torch.Tensor] = None, block: int = BLOCK):
    """(K, NB, block) codes x (K, NB) coefficients -> (N,), the accumulator
    starting from ``noise`` (or 0). CUDA: the apply kernel; CPU:
    ``ref.agg_apply_ref``."""
    if q.device.type == "cpu":
        return ref.agg_apply_ref(q, coeff, noise=noise, block=block)
    return _apply_cuda(q, coeff, noise, block)


class _Stages:
    """The stages of one engine: ``"torch"`` runs the plain versions (CPU
    tensors), ``"cuda"`` launches the kernels (CUDA tensors only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type != "cpu"
        self.engine = "cuda" if self.cuda else "torch"

    def stats(self, mat, block, with_sumsq):
        if self.cuda:
            bmax, bsumsq = _stats_cuda(mat, block)   # one read gives both
            return bmax, (bsumsq if with_sumsq else None)
        return ref.agg_block_stats_ref(mat, block, with_sumsq=with_sumsq)

    def pack(self, mat, sblock, bits, block, need_qss):
        """(codes, quantized row sums of squares, and their per-block
        terms); the sums are None unless ``need_qss`` (the kernel writes
        them either way)."""
        if self.cuda:
            return _pack_cuda(mat, sblock, bits, block)
        q = ref.agg_pack_ref(mat, sblock, bits, block)
        if not need_qss:
            return q, None, None
        bqss = ref._sumsq_blocks(q) * (sblock.float() * sblock.float())
        return q, ref._row_combine(bqss), bqss

    def row_combine(self, bqss):
        """Pack's combine of per-block sums into row sums."""
        if self.cuda:
            return _row_combine_cuda(bqss)
        return ref._row_combine(bqss)

    def apply_coeff(self, q, coeff, noise, block):
        if self.cuda:
            return _apply_cuda(q, coeff, noise, block)
        return ref.agg_apply_ref(q, coeff, noise=noise, block=block)


def compose(mat, weights, *, block_leaf, n_leaves: int, align: int = BLOCK,
            bits: int = 0, clip_norm: float = 0.0, uniform: bool = False,
            wsum_fixed: Optional[float] = None, sigma: float = 0.0,
            rng=None, bmask=None, remask_rows: bool = False,
            block_denom: bool = False,
            screen: Optional[sanitize_lib.SanitizeConfig] = None,
            constrain_fn=None):
    """The fused tail over the (K, size) buffer; returns ``(update, info)``.

    Stage order is the staged route's: screen -> uniform weights ->
    denominator -> row re-mask -> quantize -> clip fold -> mean (per-block
    denominator for tiers) -> noise. ``info`` holds the quarantine masks
    and norms (screen on), the per-row post-quantize norms (clip on) and
    the ``route``. ``rng`` is a threefry key (``nn/threefry.key``), drawn
    from directly. ``bmask`` (K, NB) holds each row's tier block mask.
    As in the reference, ``remask_rows`` re-masks the rows on the exact
    route's unquantized branch alone (the quantized branches take the
    rows as they come; the tiered client steps send exact zeros there),
    and ``block_denom`` divides the exact route's GEMV per block.

    On a mesh (``constrain_fn``: the flat plane,
    ``launch/sharding.FlatPlane``) ``mat`` is this rank's block and the
    result this rank's columns (``kernels/ops.agg_tail``): the stats
    kernel reads the block, its per-(row, block) tables are gathered
    whole, so the scales, norms and screen are the unmeshed ones bit for
    bit; the pack and apply kernels run on the block, the clip's
    quantized sums of squares combine per-block terms gathered over
    "model", and the apply's partial sums are added over the data ranks
    in rank order, the noise folded in on data rank 0 alone."""
    plane = flat_lib.as_plane(constrain_fn)
    K = weights.shape[0]
    nb = len(block_leaf)
    size = nb * align
    r0, r1 = plane.rows(K)
    b0, b1 = plane.blocks(nb)
    R = mat.shape[0]
    stages = _Stages(mat.device)
    info = {}

    # ---- stats: what the screen and the quantizer need, one read --------
    need_max = bits > 0 or screen is not None
    need_raw = screen is not None or (clip_norm > 0 and bits == 0)
    bmax = raw_norms = None
    if need_max:
        bmax, bsumsq = stages.stats(mat, align, with_sumsq=need_raw)
        bmax = plane.gather_table(bmax, K, nb)
        if need_raw:
            raw_norms = torch.sqrt(ref._row_combine(
                plane.gather_table(bsumsq, K, nb)))
    elif need_raw:
        raw_norms = flat_lib.row_norms(mat, align, plane, K, nb)

    # ---- quarantine screen off the stats --------------------------------
    q_mask = None
    if screen is not None:
        row_finite = torch.isfinite(bmax).all(dim=-1)
        weights, q_mask, sinfo = sanitize_lib.screen_from_stats(
            raw_norms, row_finite, weights, screen)
        info.update(sinfo)

    # ---- weights and denominator ----------------------------------------
    w = (weights > 0).to(weights.dtype) if uniform else weights
    if wsum_fixed is not None:
        wsum = torch.tensor(float(wsum_fixed), dtype=torch.float32,
                            device=mat.device)
    else:
        wsum = torch.clamp_min(w.sum(), 1e-12)

    # ---- quantize: scales from the stats, then the pack read -------------
    sblock = q8 = qss = None
    if bits > 0:
        sblock = ref.agg_scales_ref(bmax, block_leaf, bits, n_leaves)
        if q_mask is not None:
            # a quarantined NaN/Inf row has NaN/Inf scales; its weight is
            # zero, but 0 * NaN would still poison its coefficients, so its
            # scales become 1 (its codes are garbage either way and meet a
            # zero coefficient)
            sblock = torch.where(q_mask[:, None], torch.ones_like(sblock),
                                 sblock)
        q8, qss, bqss = stages.pack(
            mat, sblock[r0:r1, b0:b1].contiguous(), bits, align,
            need_qss=clip_norm > 0)
        if clip_norm > 0 and plane.M > 1:
            qss = stages.row_combine(plane.gather_blocks(bqss, nb))
        if clip_norm > 0:
            qss = plane.gather_rows(qss, K)

    # ---- clip fold: one scale per row, into the weights ------------------
    if clip_norm > 0:
        norms = torch.sqrt(qss) if bits > 0 else raw_norms
        if q_mask is not None:
            norms = torch.where(q_mask, torch.zeros_like(norms), norms)
        # tensor / tensor: `scalar / tensor` is a reciprocal multiply
        w = w * torch.clamp(torch.full_like(norms, clip_norm)
                            / torch.clamp_min(norms, 1e-12), max=1.0)
        info["update_norms"] = norms

    noise = (flat_lib.draw_noise(rng, size, sigma, mat.device,
                                 cols=(b0 * align, b1 * align))
             if sigma > 0 else None)

    # ---- apply: coefficients where scales and clip fold together, else
    # the exact GEMV (bitwise the staged mean) ------------------------------
    if bits > 0 and (clip_norm > 0 or sigma > 0):
        coeff = ((w / wsum)[:, None] * sblock)[r0:r1, b0:b1].contiguous()
        out = plane.sum_rows(stages.apply_coeff(
            q8, coeff, noise if plane.d == 0 else None, align))
        info["route"] = f"fused/{stages.engine}/coeff"
    else:
        nbl = b1 - b0
        if bits > 0:
            x3 = q8            # dequantized chunk by chunk by the GEMV
        else:
            x = mat
            if q_mask is not None:
                # raw f32 rows: a quarantined NaN row must be zeroed, since
                # NaN * 0 is NaN in the GEMV
                x = torch.where(q_mask[r0:r1, None], torch.zeros_like(x), x)
            if remask_rows:
                x = (x.reshape(R, nbl, align)
                     * bmask[r0:r1, b0:b1, None]).reshape(R, nbl * align)
            x3 = x.reshape(R, nbl, align)
        num = plane.sum_rows(ref.agg_apply_exact_ref(
            x3, w[r0:r1],
            sblock=None if sblock is None else sblock[r0:r1, b0:b1]))
        if block_denom:
            block_den = torch.clamp_min(torch.matmul(w.float(), bmask), 1e-12)
            out = num / block_den[b0:b1].repeat_interleave(align)
        else:
            out = num / wsum
        if noise is not None:
            out = out + noise
        info["route"] = f"fused/{stages.engine}/exact"
    return out, info
