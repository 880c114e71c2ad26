"""Device meshes on ``torch.distributed``, port of ``repro/launch/mesh.py``.

The reference's presets keep their names, shapes and axis names: client
cohorts shard over ``("pod", "data")``, tensor and expert parallelism
lives on ``"model"``. Each preset is a
``torch.distributed.device_mesh.DeviceMesh`` over a world of exactly its
size (one rank a card, or one process a CPU rank under ``gloo``). A
process group is never made at import time: ``single`` makes a 1-rank
group when there is none (NCCL on the card, ``gloo`` on the CPU, over an
in-memory store, no port); every other preset needs the caller's world
(``torch.distributed.init_process_group``) and raises on another size,
naming the preset and both sizes.

:class:`AbstractMesh` carries a shape and axis names and no ranks: the
sharding rules (``launch/sharding.py``) read only those, so placements at
the production shapes need no world. ``use_mesh`` sets the ambient mesh
that ``nn/basic.maybe_constrain`` reads, the twin of
``jax.sharding.get_abstract_mesh``.

Tensor parallelism on "model" (Megatron's): :func:`tensor_parallel` sets
the ambient group the decoder LM's layers read, and :func:`tp_copy`,
:func:`tp_reduce`, :func:`tp_gather` and :func:`tp_max` are its
collectives with a gradient and a ``torch.func.vmap`` rule, every sum in
rank order.

A serving step whose batch rows are split over the data axes sets the
ambient :class:`DataSplit` (:func:`data_split`): an MoE layer then counts
its capacity and slot ranks over the global batch, as the reference's
one GSPMD program does, through :func:`data_gather`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# One NVIDIA H100 SXM (data sheet: dense bf16, HBM3, NVLink 4 both ways
# together), as the card's rows of PERF.md are stated; the card the
# numbers were taken on reads "NVIDIA H100 80GB HBM3, 700.00 W".
HW = {
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,   # FLOP/s
    "hbm_bw": 3.35e12,           # B/s
    "nvlink_bw": 900e9,          # B/s a card, both directions together
    "hbm_bytes": 80 * 10 ** 9,
}

PRESETS: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "single": ((1, 1), ("data", "model")),
    "debug": ((2, 2), ("data", "model")),
    "debug-pod": ((2, 2, 2), ("pod", "data", "model")),
    "production": ((16, 16), ("data", "model")),
    "production-multipod": ((2, 16, 16), ("pod", "data", "model")),
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, without ranks."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Tuple[int, ...]:
    return tuple(int(s) for s in mesh.shape)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), mesh_shape(mesh)))


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_world(n: int, device_type: str, what: str) -> None:
    """A world of exactly ``n`` ranks: a 1-rank group is made when there is
    no process group and ``n == 1``; otherwise the caller's world must
    have ``n`` ranks."""
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"{what} needs a world of {n} ranks; this process has no "
                f"process group (a world of 1): call "
                f"torch.distributed.init_process_group with world_size={n}")
        dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)
        return
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"{what} needs a world of {n} ranks, the process "
                           f"group has {world}")


_MESHES: Dict[Tuple[str, str], object] = {}


def make_mesh(name: str, device=None):
    """The preset ``name`` as a DeviceMesh on ``device``'s type (CUDA
    unless ``device="cpu"``), made once a process."""
    if name not in PRESETS:
        raise ValueError(f"unknown mesh preset {name!r}; options: "
                         f"{sorted(PRESETS)}")
    device_type = resolve_device(device).type
    key = (name, device_type)
    mesh = _MESHES.get(key)
    if mesh is None:
        shape, axes = PRESETS[name]
        ensure_world(math.prod(shape), device_type,
                     f"mesh preset {name!r} {shape}")
        from torch.distributed.device_mesh import init_device_mesh
        mesh = _MESHES[key] = init_device_mesh(device_type, shape,
                                               mesh_dim_names=axes)
    return mesh


def resolve_mesh(spec, device=None):
    """``None`` | preset name | mesh object -> mesh object (or ``None``).

    The one place a grid or spec configuration turns a description of a
    mesh into process groups, so configurations stay picklable."""
    if spec is None:
        return None
    if isinstance(spec, str):
        return make_mesh(spec, device)
    return spec


# ---------------------------------------------------------------------------
# The ambient mesh (``jax.sharding.get_abstract_mesh``'s twin)

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def get_abstract_mesh() -> Optional[object]:
    return _AMBIENT[-1] if _AMBIENT else None


# ---------------------------------------------------------------------------
# Collectives of the flat plane: functional collectives (one traced op
# each), none for a group of one rank


def _waited(t):
    from torch.distributed import _functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on each rank -> (ranks * n, ...), pieces in group-rank
    order."""
    from torch.distributed import _functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return _waited(gather(t.contiguous(), 0, group))


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """(ranks * c,) on each rank -> (ranks * c,): piece j of every rank
    goes to rank j, received in rank order."""
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_to_all_single(t.contiguous(), None, None,
                                            group))


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_reduce(t.contiguous(), op, group))


# ---------------------------------------------------------------------------
# Tensor parallelism on "model": Megatron's collectives with a gradient
#
# A rank computes on its pieces of the parameters, placed by
# ``launch/sharding.param_shardings``. A tensor every rank holds the same
# (replicated) enters rank-local work through :func:`tp_copy` (identity
# forward, all-reduce backward: the column-parallel input), and the
# partial results leave it through :func:`tp_reduce` (all-reduce forward,
# identity backward: the row-parallel output). :func:`tp_gather` joins
# pieces along a dim (its backward keeps this rank's piece).
#
# A sum over the ranks is a reduce-scatter made of an all-to-all (rank j
# receives every rank's j-th piece, in rank order, and adds them in that
# order in float32) and an all-gather of the summed pieces, cast back: no
# float atomics and no backend reduction order, so the sums repeat bit for
# bit from run to run and are the same bits on every rank. Both moves are
# in float32: the bytes of a float32 ring all-reduce, twice a bf16 one's.
# Each op has its own
# ``torch.func.vmap`` rule (the collective of a vmapped tensor is the
# collective of the batched tensor), since the round engine vmaps a
# rank's clients; under ``torch.func.grad`` each backward is again one of
# these ops. The active group is ambient (:func:`tensor_parallel`, one a
# thread); with none, or a "model" axis of one rank, every op is the
# identity and no collective runs.


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The "model" axis of a mesh: its process group, size and this
    rank's index on it."""
    group: object
    size: int
    rank: int


def model_parallel(mesh) -> TensorParallel:
    """The ``TensorParallel`` of ``mesh``'s "model" axis."""
    size = axis_size(mesh, "model")
    if size == 1:
        return TensorParallel(None, 1, 0)
    rank = dict(zip(axis_names(mesh), mesh.get_coordinate()))["model"]
    return TensorParallel(mesh.get_group("model"), size, rank)


_TP = threading.local()


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Make ``tp`` the ambient tensor-parallel group inside the block (of
    this thread): the decoder LM's layers then compute on the pieces of
    the parameters they are given."""
    stack = _TP.__dict__.setdefault("stack", [])
    stack.append(tp)
    try:
        yield tp
    finally:
        stack.pop()


def current_tp() -> Optional[TensorParallel]:
    """The ambient ``TensorParallel``, or None when there is none or its
    axis has one rank."""
    stack = getattr(_TP, "stack", None)
    tp = stack[-1] if stack else None
    return tp if tp is not None and tp.size > 1 else None


class _Stack(torch.autograd.Function):
    """(...) on each rank -> (size, ...), the ranks' tensors in rank
    order; backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(x, tp):
        return all_gather(x[None], tp.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g[ctx.tp.rank], None

    @staticmethod
    def vmap(info, in_dims, x, tp):
        if in_dims[0] is None:
            return _Stack.apply(x, tp), None
        return _Stack.apply(x.movedim(in_dims[0], 0), tp), 1


def _sum_over(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The ranks' ``x`` summed in rank order in float32, in ``x``'s dtype:
    an all-to-all of equal pieces of the flat vector (padded to a multiple
    of the ranks), each rank adding its piece's M parts, and an
    all-gather of the sums."""
    n, m = x.numel(), tp.size
    c = -(-n // m)
    flat = x.reshape(-1).float()
    if c * m != n:
        flat = torch.nn.functional.pad(flat, (0, c * m - n))
    parts = all_to_all(flat, tp.group).view(m, c)
    acc = parts[0]
    for i in range(1, m):
        acc = acc + parts[i]
    return all_gather(acc, tp.group)[:n].view(x.shape).to(x.dtype)


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(x, tp):
        return _sum_over(x, tp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, tp):
        return _Reduce.apply(x, tp), in_dims[0]


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(x, tp):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.tp), None

    @staticmethod
    def vmap(info, in_dims, x, tp):
        return _Copy.apply(x, tp), in_dims[0]


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering rank-local work (Megatron's ``f``)."""
    tp = current_tp()
    return x if tp is None else _Copy.apply(x, tp)


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the "model" ranks of their partials (Megatron's
    ``g``): added in rank order in float32, cast back to ``x``'s dtype."""
    tp = current_tp()
    return x if tp is None else _Reduce.apply(x, tp)


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the "model" ranks (exact in any order);
    no gradient flows through it."""
    tp = current_tp()
    if tp is None:
        return x
    return _Stack.apply(x.detach(), tp).amax(0)


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' equal pieces joined along ``dim`` in rank order (a
    vocab- or column-parallel all-gather); backward: this rank's piece.
    Where the whole tensor then feeds rank-local work, wrap it in
    :func:`tp_copy` (the backward becomes a reduce-scatter)."""
    tp = current_tp()
    if tp is None:
        return x
    dim = dim % x.ndim
    parts = _Stack.apply(x, tp)                       # (size, ...)
    parts = parts.movedim(0, dim)                     # (..., size, n, ...)
    return parts.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 1:])


# ---------------------------------------------------------------------------
# A batch split over the data axes
#
# The reference's prefill and decode are one program over the global
# batch: an MoE layer's capacity and each entry's slot rank are counted
# over all of its rows. A meshed step that gives each data rank its own
# rows keeps that rule through the ambient ``DataSplit`` (one a thread):
# ``nn/moe`` gathers every data rank's per-expert counts (one small
# integer all-gather over the flattened data axes, in global row order)
# and ranks its entries after the earlier data ranks'. A data rank with
# no rows still joins the gather. With no split, or a data axis of one
# rank, nothing is gathered. The train step sets none: in both packages
# each client's tokens form their own MoE call.


@dataclasses.dataclass(frozen=True)
class DataSplit:
    """The data ranks a batch's rows are split over: their process group
    (the flattened ``("pod", "data")`` axes), their number, this rank's
    pod-major index, and the global batch's row count."""
    group: object
    size: int
    rank: int
    rows: int


_DS = threading.local()


@contextlib.contextmanager
def data_split(ds: Optional[DataSplit]):
    """Make ``ds`` the ambient data split inside the block (of this
    thread)."""
    stack = _DS.__dict__.setdefault("stack", [])
    stack.append(ds)
    try:
        yield ds
    finally:
        stack.pop()


def current_data_split() -> Optional[DataSplit]:
    """The ambient ``DataSplit``, or None when there is none or it spans
    one rank."""
    stack = getattr(_DS, "stack", None)
    ds = stack[-1] if stack else None
    return ds if ds is not None and ds.size > 1 else None


def data_gather(t: torch.Tensor) -> torch.Tensor:
    """(...) on each data rank of the ambient split -> (size, ...), the
    ranks' tensors in data-rank order (no gradient)."""
    ds = current_data_split()
    if ds is None:
        return t[None]
    return all_gather(t.detach()[None], ds.group)
