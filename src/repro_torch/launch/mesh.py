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
rank order; :func:`tp_channels` moves a column-parallel output of two
parts side by side (Mamba's ``in_proj``: [xs | z]) from the rank's
column block to its channels of each part (an all-to-all, whose
backward is the inverse).

A serving step whose batch rows are split over the data axes sets the
ambient :class:`DataSplit` (:func:`data_split`): an MoE layer then counts
its capacity and slot ranks over the global batch, as the reference's
one GSPMD program does, through :func:`data_gather`.

Expert parallelism on "data" (DeepSeek-V2's 2-D expert layout):
:func:`expert_parallel` sets the ambient group of the rank's "data" axis
over which the expert stacks' expert dim is split, and
:func:`expert_exchange` / :func:`expert_return` move an MoE layer's
dispatch buffer to the ranks that hold its experts and the outputs back
(an all-to-all each way, autograd and ``vmap`` rules included);
:func:`expert_share` / :func:`expert_reduce` are the exchange of a batch
whose rows are split over the data ranks: each expert rank fills only
its experts' slots and each data rank gets back only its own tokens'
outputs.
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
    """A mesh axis ("model" for tensor parallelism, "data" for the
    experts' exchange): its process group, size and this rank's index on
    it."""
    group: object
    size: int
    rank: int


def axis_group(mesh, name: str) -> TensorParallel:
    """The ``TensorParallel`` of ``mesh``'s axis ``name``."""
    size = axis_size(mesh, name)
    if size == 1:
        return TensorParallel(None, 1, 0)
    rank = dict(zip(axis_names(mesh), mesh.get_coordinate()))[name]
    return TensorParallel(mesh.get_group(name), size, rank)


def model_parallel(mesh) -> TensorParallel:
    """The ``TensorParallel`` of ``mesh``'s "model" axis."""
    return axis_group(mesh, "model")


@contextlib.contextmanager
def _ambient(local, value):
    """Push ``value`` on ``local``'s stack (one a thread) inside the
    block."""
    stack = local.__dict__.setdefault("stack", [])
    stack.append(value)
    try:
        yield value
    finally:
        stack.pop()


def _current(local):
    """The top of ``local``'s stack, or None when it is empty or spans one
    rank."""
    stack = getattr(local, "stack", None)
    value = stack[-1] if stack else None
    return value if value is not None and value.size > 1 else None


_TP = threading.local()


def tensor_parallel(tp: Optional[TensorParallel]):
    """Make ``tp`` the ambient tensor-parallel group inside the block (of
    this thread): the decoder LM's layers then compute on the pieces of
    the parameters they are given."""
    return _ambient(_TP, tp)


def current_tp() -> Optional[TensorParallel]:
    """The ambient ``TensorParallel``, or None when there is none or its
    axis has one rank."""
    return _current(_TP)


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
    # the width named, not -1: a data rank with no rows has no elements
    return parts.reshape(x.shape[:dim] + (tp.size * x.shape[dim],)
                         + x.shape[dim + 1:])


# ---------------------------------------------------------------------------
# A column-parallel output of two parts, moved to the rank's channels
#
# A projection whose output is two tensors side by side (Mamba's
# ``in_proj``: [xs | z], each d_inner wide) is split on "model" in
# contiguous column blocks, so rank r holds columns [r W / M, (r + 1) W /
# M) of the whole width W: at M = 2 rank 0 holds all of xs and rank 1 all
# of z. Channel-parallel work wants channels [r c / M, (r + 1) c / M) of
# both parts (c = W / 2). :func:`tp_channels` moves each rank's block to
# those slices with one all-to-all over "model" (each rank sends a
# destination the columns of its block that the destination needs, and
# nothing to the others); its backward is the inverse all-to-all.


def _channel_plan(width: int, size: int):
    """For each (source, destination) rank pair, the global column ranges
    the source's block holds of the destination's channels, part by
    part: ``plan[s][j]`` a list of (start, stop)."""
    block, c = width // size, width // 2
    plan = []
    for s in range(size):
        a, b = s * block, (s + 1) * block
        row = []
        for j in range(size):
            row.append([(max(a, lo), min(b, hi)) for lo, hi in
                        ((p * c + j * c // size, p * c + (j + 1) * c // size)
                         for p in range(2)) if max(a, lo) < min(b, hi)])
        plan.append(row)
    return plan


def _move_columns(x, tp, inverse: bool):
    """(..., W / M) on each rank, its column block (``inverse`` False) or
    its channels of both parts side by side (True) -> the other layout,
    by one all-to-all of the columns (dim -1 moved to the front)."""
    width = x.shape[-1] * tp.size
    c, c_loc = width // 2, width // 2 // tp.size
    plan = _channel_plan(width, tp.size)
    me = tp.rank
    if not inverse:
        a = me * x.shape[-1]            # my block's first global column
        send = [[(lo - a, hi - a) for lo, hi in plan[me][j]]
                for j in range(tp.size)]
        recv = [plan[s][me] for s in range(tp.size)]
    else:
        def local(lo, hi):              # a global column in my channels
            at = lo // c * c_loc + lo % c - me * c_loc
            return at, at + hi - lo
        send = [[local(lo, hi) for lo, hi in plan[j][me]]
                for j in range(tp.size)]
        recv = [plan[me][s] for s in range(tp.size)]
    cols = x.movedim(-1, 0)
    pieces = [cols[lo:hi] for row in send for lo, hi in row]
    buf = torch.cat(pieces) if pieces else cols[:0]
    from torch.distributed import _functional_collectives as funcol
    got = _waited(funcol.all_to_all_single(
        buf.contiguous(), [sum(hi - lo for lo, hi in row) for row in recv],
        [sum(hi - lo for lo, hi in row) for row in send], tp.group))
    # the received pieces, source-major, each source's part by part, put
    # in global column order: my channels of xs then of z, or my block
    spans, at = [], 0
    for row in recv:
        for lo, hi in row:
            spans.append((lo, got[at:at + hi - lo]))
            at += hi - lo
    spans.sort(key=lambda sp: sp[0])
    return torch.cat([t for _, t in spans]).movedim(0, -1)


class _Channels(torch.autograd.Function):
    """A column block -> the rank's channels of both parts; backward:
    :class:`_Columns`."""

    @staticmethod
    def forward(x, tp):
        return _move_columns(x, tp, inverse=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Columns.apply(g, ctx.tp), None

    @staticmethod
    def vmap(info, in_dims, x, tp):
        if in_dims[0] is None:
            return _Channels.apply(x, tp), None
        return _Channels.apply(x.movedim(in_dims[0], 0), tp), 0


class _Columns(torch.autograd.Function):
    """The rank's channels of both parts -> its column block; backward:
    :class:`_Channels`."""

    @staticmethod
    def forward(x, tp):
        return _move_columns(x, tp, inverse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Channels.apply(g, ctx.tp), None

    @staticmethod
    def vmap(info, in_dims, x, tp):
        if in_dims[0] is None:
            return _Columns.apply(x, tp), None
        return _Columns.apply(x.movedim(in_dims[0], 0), tp), 0


def tp_channels(x: torch.Tensor) -> torch.Tensor:
    """This rank's column block (..., W / M) of a column-parallel output
    of two parts side by side -> (..., W / M): this rank's channels of
    the first part, then of the second (an all-to-all over "model";
    backward: the inverse all-to-all)."""
    tp = current_tp()
    return x if tp is None else _Channels.apply(x, tp)


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


def data_split(ds: Optional[DataSplit]):
    """Make ``ds`` the ambient data split inside the block (of this
    thread)."""
    return _ambient(_DS, ds)


def current_data_split() -> Optional[DataSplit]:
    """The ambient ``DataSplit``, or None when there is none or it spans
    one rank."""
    return _current(_DS)


def data_gather(t: torch.Tensor) -> torch.Tensor:
    """(...) on each data rank of the ambient split -> (size, ...), the
    ranks' tensors in data-rank order (no gradient)."""
    ds = current_data_split()
    if ds is None:
        return t[None]
    return all_gather(t.detach()[None], ds.group)


# ---------------------------------------------------------------------------
# Expert parallelism on "data"
#
# The 2-D expert layout (``launch/sharding``'s ``2d`` mode, DeepSeek-V2's)
# splits the expert stacks' expert dim over the "data" axis and their FFN
# dim over "model": a rank (data d, model m) holds E / D experts, each on
# its ff / M columns. The reference keeps the dispatch buffer's expert dim
# on "data" (its MoE's buffer constraint: the expert-parallel all-to-all
# under GSPMD); here that exchange is explicit, over the rank's "data"
# axis alone (on ``debug-pod`` the experts replicate over "pod", so a
# token's experts live within its pod).
#
# A client's (E, cap, d) buffer is the rank's own: :func:`expert_exchange`
# sends its rows of experts E_j to data rank j and receives every data
# rank's rows for this rank's experts, (D, E / D, cap, d) in source order;
# the rank runs its experts on them, and :func:`expert_return` sends each
# source its rows back, (E, cap, d) again. Each is the other's backward,
# and each carries the round engine's client dim through ``vmap``, so
# every data rank must run the same number of clients (the tensor-
# parallel step pads a short rank's rows: ``sharding.ModelShards``).
#
# A batch whose rows are split over the data ranks (the prefill, no
# gradient) has one global slot layout, each expert's slots filled from
# every data rank's tokens. No rank builds the whole (E, cap, d) buffer:
# :func:`expert_share` hands every data rank each one's tokens (padded to
# the largest piece) and its entries' slots and weights, the rank fills
# its E / D experts' (E / D, cap, d) slots from them and runs its experts
# once, and combines each source's entries of its experts;
# :func:`expert_reduce` returns each source its tokens' partial outputs
# and adds them there in rank order, in float32 (an all-gather and an
# all-to-all, plain functions: the no-grad prefill needs neither an
# autograd nor a ``vmap`` rule). A data rank with no rows or clients of
# its own still joins every exchange. With no group, or a "data" axis of
# one rank, the experts are whole and nothing is exchanged.


_EP = threading.local()


def expert_parallel(ep: Optional[TensorParallel]):
    """Make ``ep`` (the "data" axis' ``axis_group``) the ambient
    expert-parallel group inside the block (of this thread): an MoE layer
    whose expert stacks hold E / ``ep.size`` experts then exchanges its
    buffer over it."""
    return _ambient(_EP, ep)


def current_ep() -> Optional[TensorParallel]:
    """The ambient expert-parallel group, or None when there is none or
    its axis has one rank."""
    return _current(_EP)


def _by_rank(x: torch.Tensor, ep: TensorParallel) -> torch.Tensor:
    """(..., E, cap, d) -> (D, ..., E / D, cap, d): the expert dim's D
    pieces leading, contiguous."""
    lead = x.shape[:-3]
    x = x.reshape(lead + (ep.size, x.shape[-3] // ep.size) + x.shape[-2:])
    return x.movedim(len(lead), 0).contiguous()


def _swap(x: torch.Tensor, ep: TensorParallel) -> torch.Tensor:
    """(D, ...) -> (D, ...): piece j goes to data rank j; the pieces
    received, in source order."""
    return all_to_all(x.reshape(-1), ep.group).view(x.shape)


class _Exchange(torch.autograd.Function):
    """(..., E, cap, d) -> (D, ..., E / D, cap, d); backward:
    :class:`_Return`."""

    @staticmethod
    def forward(x, ep):
        return _swap(_by_rank(x, ep), ep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ep = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Return.apply(g, ctx.ep), None

    @staticmethod
    def vmap(info, in_dims, x, ep):
        if in_dims[0] is None:
            return _Exchange.apply(x, ep), None
        return _Exchange.apply(x.movedim(in_dims[0], 0), ep), 1


class _Return(torch.autograd.Function):
    """(D, ..., E / D, cap, d), piece j for data rank j -> (..., E, cap,
    d), each data rank's experts' rows in expert order; backward:
    :class:`_Exchange`."""

    @staticmethod
    def forward(y, ep):
        back = _swap(y.contiguous(), ep)             # (D, ..., E/D, cap, d)
        back = back.movedim(0, -4)
        return back.reshape(back.shape[:-4] + (-1,) + back.shape[-2:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ep = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Exchange.apply(g, ctx.ep), None

    @staticmethod
    def vmap(info, in_dims, y, ep):
        if in_dims[0] is None:
            return _Return.apply(y, ep), None
        return _Return.apply(y.movedim(in_dims[0], 1), ep), 0


def expert_exchange(buf: torch.Tensor) -> torch.Tensor:
    """A dispatch buffer (..., E, cap, d) -> the rows of this rank's E / D
    experts from every data rank, (D, ..., E / D, cap, d) in source
    order (an all-to-all over the ambient expert-parallel group)."""
    return _Exchange.apply(buf, current_ep())


def expert_return(y: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`expert_exchange`: this rank's experts'
    outputs for each source (D, ..., E / D, cap, d) -> every expert's
    outputs for this rank's rows, (..., E, cap, d)."""
    return _Return.apply(y, current_ep())


def expert_share(t: torch.Tensor) -> torch.Tensor:
    """(...) on each data rank -> (D, ...), every data rank's in rank
    order (an all-gather over the ambient expert-parallel group; no
    gradient)."""
    return all_gather(t.detach()[None], current_ep().group)


def expert_reduce(parts: torch.Tensor) -> torch.Tensor:
    """(D, ...) on each data rank, piece j for data rank j -> (...) in
    float32: the D ranks' pieces for this rank, added in rank order (an
    all-to-all in ``parts``' dtype; no gradient)."""
    ep = current_ep()
    got = _swap(parts.detach().contiguous(), ep)
    acc = got[0].float()
    for i in range(1, ep.size):
        acc = acc + got[i]
    return acc
