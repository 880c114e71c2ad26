"""Flat-buffer aggregation layout, port of ``repro/core/flat.py``.

:class:`FlatLayout` maps the trainable tree ``y`` onto one contiguous
float32 vector with a static layout: leaves in jax's sorted-key order,
each padded with zeros to whole ``align``-element blocks, so a block
never straddles two leaves and the server tail runs as a few single-pass
ops over the (clients, size) buffer. Padding is inert: zeros add nothing
to norms or max-abs scales, stay zero through quantization, and are
dropped by ``unflatten``.

The kernel-backed ops dispatch by device: a CUDA tensor goes to the
CUDA kernel, a CPU tensor to its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import dp_clip, quantize, ref
from repro_torch.nn import basic, threefry

ALIGN = 1024
# block->leaf maps on a device, by (padded leaf sizes, align, device)
_BLOCK_LEAF_ON: Dict[Tuple[Any, ...], torch.Tensor] = {}


def _ceil_to(n: int, align: int) -> int:
    return (n + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static mapping tree <-> one contiguous float32 vector."""
    paths: Tuple[str, ...]          # leaf paths, sorted-key order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    sizes: Tuple[int, ...]          # true leaf sizes
    padded: Tuple[int, ...]         # leaf sizes rounded up to `align`
    offsets: Tuple[int, ...]        # leaf start offsets in the flat vector
    size: int                       # total flat length (multiple of align)
    align: int

    @classmethod
    def of(cls, tree, align: int = ALIGN) -> "FlatLayout":
        items = list(basic.flatten_params(tree))
        shapes = tuple(tuple(leaf.shape) for _, leaf in items)
        sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
        padded = tuple(_ceil_to(max(n, 1), align) for n in sizes)
        offsets = tuple(int(o) for o in np.cumsum((0,) + padded[:-1]))
        return cls(paths=tuple(p for p, _ in items), shapes=shapes,
                   dtypes=tuple(leaf.dtype for _, leaf in items),
                   sizes=sizes, padded=padded, offsets=offsets,
                   size=int(sum(padded)) if items else 0, align=align)

    @property
    def num_blocks(self) -> int:
        return self.size // self.align

    def block_leaf(self) -> np.ndarray:
        """(num_blocks,) int32: which leaf each align-block belongs to."""
        return np.repeat(np.arange(len(self.sizes), dtype=np.int32),
                         [p // self.align for p in self.padded])

    def block_leaf_on(self, device) -> torch.Tensor:
        """:meth:`block_leaf` as an int32 tensor on ``device``, copied there
        once for every layout with these leaf sizes (the round engine
        builds a layout each round) and reused, so a round makes no
        host-to-device copy of it."""
        key = (self.padded, self.align, torch.device(device))
        bl = _BLOCK_LEAF_ON.get(key)
        if bl is None:
            bl = _BLOCK_LEAF_ON[key] = torch.as_tensor(
                self.block_leaf(), dtype=torch.int32, device=key[2])
        return bl

    def flatten(self, tree) -> torch.Tensor:
        """Tree -> (size,) float32."""
        leaves = basic.tree_leaves(tree)
        if not leaves:
            return torch.zeros((0,), dtype=torch.float32)
        parts = [F.pad(leaf.reshape(-1).float(), (0, pad - n))
                 for leaf, n, pad in zip(leaves, self.sizes, self.padded)]
        return torch.cat(parts)

    def unflatten(self, vec: torch.Tensor, dtype: Optional[Any] = None):
        """(size,) vector -> tree. ``dtype=None`` restores each leaf's
        dtype; the round engine passes float32."""
        flat = {path: vec[off:off + n].reshape(shape).to(dtype or dt)
                for path, shape, dt, n, off in zip(
                    self.paths, self.shapes, self.dtypes, self.sizes,
                    self.offsets)}
        return basic.unflatten_params(flat)

    # -- block sub-layouts (core/plan.py trainability tiers) -------------

    def leaf_blocks(self, leaf_on) -> np.ndarray:
        """(k,) int32 global block ids owned by the leaves ``leaf_on``
        selects (one bool per leaf, layout order). Every leaf owns whole
        ``align`` blocks, so a subset of leaves is a subset of blocks: the
        static index map that makes a tier's payload a contiguous slice."""
        if len(leaf_on) != len(self.sizes):
            raise ValueError(f"leaf_on has {len(leaf_on)} entries for "
                             f"{len(self.sizes)} leaves")
        keep = np.asarray(leaf_on, bool)[self.block_leaf()]
        return np.nonzero(keep)[0].astype(np.int32)

    def block_mask(self, leaf_on) -> np.ndarray:
        """(num_blocks,) float32 0/1 mask over align-blocks for the leaves
        ``leaf_on`` selects."""
        mask = np.zeros((self.num_blocks,), np.float32)
        mask[self.leaf_blocks(leaf_on)] = 1.0
        return mask


def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.long, device=device)


def gather_blocks(vec: torch.Tensor, block_ids, align: int = ALIGN
                  ) -> torch.Tensor:
    """(size,) or (k, size) -> the selected blocks as one contiguous
    (n*align,) vector or (k, n*align) matrix. ``block_ids``: numpy ids, or
    an integer tensor already on ``vec``'s device (no copy then)."""
    ids = _ids(block_ids, vec.device)
    if vec.ndim == 1:
        return vec.reshape(-1, align)[ids].reshape(-1)
    k = vec.shape[0]
    return vec.reshape(k, vec.shape[1] // align, align)[:, ids].reshape(
        k, ids.numel() * align)


def scatter_blocks(sub: torch.Tensor, block_ids, num_blocks: int,
                   align: int = ALIGN) -> torch.Tensor:
    """Inverse of :func:`gather_blocks`: the contiguous block slice placed
    back into a zero-filled full-width (size,) or (k, size) float32
    buffer. Unselected blocks are exactly zero."""
    ids = _ids(block_ids, sub.device)
    if sub.ndim == 1:
        out = torch.zeros((num_blocks, align), dtype=torch.float32,
                          device=sub.device)
        out[ids] = sub.reshape(-1, align).float()
        return out.reshape(-1)
    k = sub.shape[0]
    out = torch.zeros((k, num_blocks, align), dtype=torch.float32,
                      device=sub.device)
    out[:, ids] = sub.reshape(k, sub.shape[1] // align, align).float()
    return out.reshape(k, num_blocks * align)


def expand_block_mask(mask, align: int = ALIGN) -> torch.Tensor:
    """(num_blocks,) 0/1 -> (size,) elementwise float32 mask."""
    return torch.as_tensor(mask, dtype=torch.float32).repeat_interleave(align)


# ---------------------------------------------------------------------------
# Flat ops used by the round engine.


def sumsq(vec: torch.Tensor, align: int = ALIGN) -> torch.Tensor:
    """Sum of squares of a flat vector (0-d float32): the CUDA kernel for
    a CUDA tensor, the chunked plain version for a CPU one."""
    if vec.device.type == "cpu":
        return ref.flat_sumsq_ref(vec, chunk=align)
    return dp_clip.sumsq(vec.reshape(-1).float().contiguous())


def row_sumsq(mat: torch.Tensor, align: int = ALIGN) -> torch.Tensor:
    """(C, size) -> (C,) per-row sum of squares (plain on every device,
    as in the JAX package)."""
    return ref.row_sumsq_ref(mat, chunk=align)


def row_norms(mat: torch.Tensor, align: int = ALIGN, plane=None,
              k: Optional[int] = None, nb: Optional[int] = None
              ) -> torch.Tensor:
    """(C, size) -> (C,) per-row L2 norms, :func:`row_sumsq`'s bits. On a
    mesh (``plane``, ``launch/sharding.FlatPlane``) ``mat`` is this rank's
    block of the (``k``, ``nb * align``) buffer: the per-block sums are
    gathered over "model" and the norms over the data ranks, so every rank
    gets the whole rows' norms, the same bits."""
    plane = WHOLE if plane is None else plane
    part = plane.gather_blocks(block_sumsq(mat, align), nb)
    return plane.gather_rows(torch.sqrt(ref._row_combine(part)), k)


def clip(vec: torch.Tensor, clip_norm: float,
         layout: Optional[FlatLayout] = None):
    """Per-row L2 clip, vec * min(1, C/||vec||), of a (size,) vector or of
    each row of a (rows, size) buffer. Returns (clipped, pre-clip norms):
    the clip kernel for a CUDA tensor, the plain version for a CPU one."""
    if vec.device.type == "cpu":
        align = layout.align if layout is not None else ALIGN
        return ref.flat_clip_ref(vec, clip_norm, chunk=align)
    return dp_clip.clip_flat(vec.float().contiguous(), clip_norm)


def fake_quantize(mat: torch.Tensor, layout: FlatLayout, bits: int = 8):
    """Per-leaf symmetric int-k fake-quantization of flat client deltas,
    (C, size) or (size,), scales per (client, leaf): the CUDA kernels for
    a CUDA tensor, the plain version for a CPU one. The block->leaf map is
    the layout's device copy (:meth:`FlatLayout.block_leaf_on`)."""
    if layout.size == 0:
        return mat
    return quantize.fake_quantize_flat(mat, layout.block_leaf_on(mat.device),
                                       len(layout.sizes), bits=bits,
                                       block=layout.align)


def weighted_mean(mat: torch.Tensor, weights: torch.Tensor,
                  wsum: torch.Tensor, plane=None) -> torch.Tensor:
    """(C, size), (C,) -> (size,): sum_c w_c * mat_c / wsum as one matmul.
    On a mesh (``plane``) ``mat`` is this rank's block and the result its
    columns: each data rank's matmul over its rows, the partials added in
    rank order."""
    plane = WHOLE if plane is None else plane
    r0, r1 = plane.rows(weights.shape[0])
    return plane.sum_rows(torch.matmul(weights[r0:r1].float(),
                                       mat.float())) / wsum


def block_masked_mean(mat: torch.Tensor, weights: torch.Tensor,
                      block_masks: torch.Tensor,
                      align: int = ALIGN, plane=None) -> torch.Tensor:
    """(C, size), (C,), (C, num_blocks) -> (size,): the trainability-tier
    mean, shared by the sync round engine and the async buffered apply.
    Per block j: sum_c w_c mat_c[j] / max(sum_c w_c m_c[j], 1e-12), the
    denominator repeated to elements: a client adds zero weight on the
    blocks its tier froze, and blocks nobody trained keep delta 0. A
    tensor divided by a tensor (IEEE), as the reference divides. On a mesh
    (``plane``) as :func:`weighted_mean`, ``block_masks`` whole."""
    plane = WHOLE if plane is None else plane
    w = weights.float()
    r0, r1 = plane.rows(w.shape[0])
    b0, b1 = plane.blocks(block_masks.shape[1])
    num = plane.sum_rows(torch.matmul(w[r0:r1], mat.float()))
    den = torch.clamp_min(torch.matmul(w, block_masks.float()), 1e-12)
    return num / den[b0:b1].repeat_interleave(align)


def pad_rows(mat: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad a (k, size) stack to (rows, size) with zero rows (k <= rows).

    The async grid's drained final flush uses this to keep the buffered
    apply at its fixed ``goal_count`` shape: padding rows carry zero
    weight, so they fall out of the weighted mean, and under per-flush DP
    the fixed-denominator mean and noise sigma are unchanged by them."""
    if mat.shape[0] > rows:
        raise ValueError(f"cannot pad {mat.shape[0]} rows down to {rows}")
    if mat.shape[0] == rows:
        return mat
    pad = torch.zeros((rows - mat.shape[0],) + tuple(mat.shape[1:]),
                      dtype=mat.dtype, device=mat.device)
    return torch.cat([mat, pad])


def draw_noise(rng: threefry.Key, size: int, sigma: float,
               device=None, cols=None) -> torch.Tensor:
    """Pre-draw the (size,) Gaussian :func:`add_noise` would add:
    ``add_noise(v, sigma, rng) == v + draw_noise(rng, v.numel(), sigma)``
    bit for bit (one threefry call from the key itself, no split; the
    same float32 scaling). The fused tail starts its accumulator from it.
    ``cols=(start, stop)`` draws only those elements of the (size,) draw,
    bit for bit its slice (a "model" rank's columns on a mesh)."""
    sig = threefry.constant(sigma, torch.float32, device)
    if cols is not None:
        return sig * threefry.normal_range(rng, cols[0], cols[1], device)
    return sig * threefry.normal(rng, (size,), device)


def add_noise(vec: torch.Tensor, sigma: float, rng: threefry.Key,
              plane=None, size: Optional[int] = None) -> torch.Tensor:
    """Add N(0, sigma^2) to the flat vector in one PRNG call. Pad slots
    receive noise too: ``unflatten`` drops them, so only flat-vector norms
    see the extra energy (the round engine reports the noised update's
    norm from the unflattened tree). On a mesh whose "model" axis splits
    the (``size``,) vector (``plane``), ``vec`` is this rank's columns and
    gets their slice of the whole draw."""
    plane = WHOLE if plane is None else plane
    size = vec.numel() if size is None else size
    cols = None if plane.M == 1 else plane.cols(size)
    return vec + draw_noise(rng, size, sigma, vec.device,
                            cols=cols).reshape(vec.shape)


# ---------------------------------------------------------------------------
# The plane of the aggregation tail


class WholePlane:
    """The flat plane of one rank that holds the whole (K, size) buffer:
    every piece is the whole, every cross-rank step is none. The tail runs
    the same code with it as with ``launch/sharding.FlatPlane`` on a mesh,
    whose 1-rank form computes the same bits."""
    D = M = 1
    d = m = 0

    def rows(self, k: int):
        return 0, k

    def blocks(self, nb: int):
        return 0, nb

    def gather_rows(self, x, k: int):
        return x

    def gather_blocks(self, x, nb: int):
        return x

    def gather_table(self, x, k: int, nb: int):
        return x

    def sum_rows(self, partial):
        return partial

    def max_model(self, t):
        return t

    def all_model(self, b):
        return b


WHOLE = WholePlane()


def as_plane(constrain_fn):
    """The tail's plane: :data:`WHOLE` for None, a flat plane as it is."""
    if constrain_fn is None:
        return WHOLE
    if not all(hasattr(constrain_fn, a) for a in ("rows", "blocks",
                                                     "sum_rows")):
        raise TypeError("constrain_fn must be a flat plane "
                        "(launch/sharding.flat_constrainer(mesh)), got "
                        f"{type(constrain_fn).__name__}")
    return constrain_fn


def block_sumsq(mat: torch.Tensor, align: int = ALIGN) -> torch.Tensor:
    """(R, n) -> (R, n // align) per-block sums of squares in the order
    every row norm of the port takes (``ref._sumsq_blocks``; one block
    when ``align`` does not divide n): their ``ref._row_combine`` is
    :func:`row_sumsq` bit for bit."""
    return ref._sumsq_blocks(ref._chunked(mat.float(), align))
