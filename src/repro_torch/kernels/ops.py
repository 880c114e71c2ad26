"""The kernels' entry points, port of ``repro/kernels/ops.py``: the
server aggregation tail behind its dispatcher, the DP clips, the
sliding-window attention and the seed reconstruction.

The tail takes two routes over the (K, size) flat delta buffer, chosen
as the JAX dispatcher chooses them:

* **staged** (``_staged_tail``): op by op. Quarantine screen
  (``core/sanitize.screen_rows``), per-leaf int-k fake-quantize (the CUDA
  kernels of ``kernels/quantize.py``), optional per-row L2 clip folded
  into the weights, the weighted / fixed-denominator mean
  (``torch.matmul``, as JAX leaves it to XLA), DP noise last.
* **fused** (``kernels/agg_tail.compose``): the stats / pack / apply
  kernels for a buffer on the card, their plain versions for one on the
  CPU.

Both take trainability tiers: ``bmask`` (K, NB) holds each row's tier
block mask, ``remask_rows`` zeroes each row outside its tier, and
``block_denom`` divides each block by its mask-weighted weight sum.
"""
from __future__ import annotations

import torch

from repro_torch.core import flat as flat_lib
from repro_torch.core import sanitize as sanitize_lib
from repro_torch.kernels import agg_tail as _agg
from repro_torch.kernels import dp_clip as _dp
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import seed_reconstruct as _sr
from repro_torch.kernels import swa_attention as _swa

# the JAX dispatcher's size threshold for the fused route, kept so that
# both packages take the same route (the card's crossover is in PERF.md)
AGG_FUSE_THRESHOLD = 4 << 20


def clip_accumulate(acc, x, clip_norm: float):
    """DP clip-and-accumulate over flat f32 vectors: (acc + x * min(1,
    C/||x||), pre-clip norm)."""
    return _dp.clip_accumulate(acc, x, clip_norm)


def flat_clip(x, clip_norm: float):
    """Per-row L2 clip of flat f32 deltas, (R, N) or (N,): (clipped,
    pre-clip norms)."""
    return _dp.clip_flat(x, clip_norm)


def fake_quantize_flat(x, block_leaf, n_leaves: int = 0, bits: int = 8,
                       block: int = _q.BLOCK):
    """Per-leaf int-k Q->DQ of block-aligned flat deltas, (N,) or (R, N):
    the kernel for a CUDA tensor, the plain version for a CPU one.
    ``n_leaves=0`` reads the leaf count off ``block_leaf`` (a host copy
    when it lies on the card)."""
    if not n_leaves:
        n_leaves = int(torch.as_tensor(block_leaf).max()) + 1
    return _q.fake_quantize_flat(x, block_leaf, n_leaves, bits=bits,
                                 block=block)


def seed_reconstruct(seed: int, leaf_id: int, shape, stddev: float,
                     dtype=torch.float32, device=None):
    """Deterministic Gaussian tensor from (seed, leaf_id), on the card
    unless ``device="cpu"``."""
    return _sr.seed_reconstruct(seed, leaf_id, shape, stddev, dtype=dtype,
                                device=device)


def swa_attention(q, k, v, window: int = 0, causal: bool = True, out=None,
                  round_p: bool = False, prefix_len: int = 0):
    """Causal (optionally with a bidirectional prefix of ``prefix_len``
    keys, optionally sliding-window) or non-causal attention over (B, H,
    Sq, D) q and (B, KVH, Skv, D) k, v: the kernel for CUDA tensors, the
    plain version for CPU ones; p at float32 accuracy (the TPU kernel's
    function) or, with ``round_p``, rounded to v's dtype once (the
    reference's ``flash_attention``)."""
    return _swa.swa_attention(q, k, v, window=window, causal=causal, out=out,
                              round_p=round_p, prefix_len=prefix_len)


def _staged_tail(mat, weights, block_leaf, bmask, rng, *, n_leaves, align,
                 bits, clip_norm, uniform, wsum_fixed, sigma, block_denom,
                 remask_rows, screen, plane):
    """The op-by-op tail, in the reference's order: screen -> uniform
    weights -> denominator -> tier re-mask -> quantize -> clip fold ->
    mean (per-block denominator for tiers) -> noise, over this rank's
    block of the buffer (``plane``, :func:`agg_tail`)."""
    info = {}
    K = weights.shape[0]
    nb = len(block_leaf)
    b0, b1 = plane.blocks(nb)
    if screen is not None:
        mat, weights, sinfo = sanitize_lib.screen_rows(
            mat, weights, screen, align, plane, nb)
        info.update(sinfo)
    w = (weights > 0).to(weights.dtype) if uniform else weights
    if wsum_fixed is not None:
        wsum = torch.tensor(float(wsum_fixed), dtype=torch.float32,
                            device=mat.device)
    else:
        wsum = torch.clamp_min(w.sum(), 1e-12)
    if remask_rows:
        r0, r1 = plane.rows(K)
        R = mat.shape[0]
        mat = (mat.reshape(R, b1 - b0, align)
               * bmask[r0:r1, b0:b1, None]).reshape(R, (b1 - b0) * align)
    if bits > 0:
        mat = _q.fake_quantize_flat(
            mat, block_leaf[b0:b1], n_leaves, bits=bits, block=align,
            reduce_maxabs=plane.max_model if plane.M > 1 else None)
    if clip_norm > 0:
        norms = flat_lib.row_norms(mat, align, plane, K, nb)
        # tensor / tensor: `scalar / tensor` is a reciprocal multiply
        w = w * torch.clamp(torch.full_like(norms, clip_norm)
                            / torch.clamp_min(norms, 1e-12), max=1.0)
        info["update_norms"] = norms
    if block_denom:
        out = flat_lib.block_masked_mean(mat, w, bmask, align, plane)
    else:
        out = flat_lib.weighted_mean(mat, w, wsum, plane)
    if sigma > 0:
        out = flat_lib.add_noise(out, sigma, rng, plane, nb * align)
    return out, info


def agg_tail(mat, weights, *, block_leaf, n_leaves: int, align: int = 1024,
             bits: int = 0, clip_norm: float = 0.0, uniform: bool = False,
             wsum_fixed=None, sigma: float = 0.0, rng=None, bmask=None,
             remask_rows: bool = False, block_denom: bool = False,
             screen=None, constrain_fn=None, threshold=None):
    """Server aggregation tail over the (K, size) flat delta buffer:
    quarantine ``screen``, tier re-mask (``remask_rows``), int-``bits``
    fake-quantize, clip folded into the weights, weighted /
    fixed-denominator mean (per block for tiers, ``block_denom``), DP
    noise of std ``sigma`` drawn from the threefry key ``rng``. ``bmask``
    (K, size // align) holds each row's tier block mask, needed by
    ``remask_rows`` and ``block_denom``. Returns ``(update (size,),
    info)``: ``info["route"]`` (``"staged"``, ``"fused/cuda/coeff"``,
    ``"fused/torch/exact"``, ...), the quarantine ``nonfinite`` /
    ``outlier`` / ``norms`` with the screen on, and ``update_norms`` when
    clipping.

    Dispatch as in the JAX package: the fused route for quantized
    pipelines (``bits > 0``) on buffers of at least
    :data:`AGG_FUSE_THRESHOLD` elements, the staged route otherwise; an
    explicit ``threshold`` routes by size alone (0 forces fused, a value
    above ``K * size`` staged). ``K * size`` is the whole buffer's.

    ``constrain_fn``, the flat plane of a mesh
    (``launch/sharding.flat_constrainer``), runs the tail on a mesh:
    ``mat`` is then this rank's block of the (K, size) buffer (its rows
    along the data axes, its whole ``align`` blocks along "model"), the
    result this rank's columns of the update, and each cross-rank step an
    explicit collective of the plane: the screen's and the clip's row
    norms from per-block sums gathered over "model", the per-leaf max-abs
    reduced over "model", the mean's partial sums added over the data
    ranks in rank order, the noise drawn for this rank's columns alone.
    ``weights``, ``block_leaf`` and ``bmask`` stay whole."""
    if sigma > 0 and rng is None:
        raise ValueError("DP noise (sigma > 0) needs a threefry key rng")
    if (remask_rows or block_denom) and bmask is None:
        raise ValueError("remask_rows / block_denom need the rows' tier "
                         "block masks (bmask)")
    plane = flat_lib.as_plane(constrain_fn)
    K, size = weights.shape[0], len(block_leaf) * align
    if threshold is None:
        fuse = bits > 0 and K * size >= AGG_FUSE_THRESHOLD
    else:
        fuse = K * size >= threshold
    kw = dict(n_leaves=n_leaves, align=align, bits=bits, clip_norm=clip_norm,
              uniform=uniform, wsum_fixed=wsum_fixed, sigma=sigma,
              block_denom=block_denom, remask_rows=remask_rows,
              screen=screen)
    if not fuse:
        out, info = _staged_tail(mat, weights, block_leaf, bmask, rng,
                                 plane=plane, **kw)
        info["route"] = "staged"
        return out, info
    return _agg.compose(mat, weights, block_leaf=block_leaf, rng=rng,
                        bmask=bmask, constrain_fn=plane, **kw)
