"""Sharding rules on ``torch.distributed``, port of
``repro/launch/sharding.py``: parameter-path regex -> placements.

Conventions (Megatron-style tensor parallelism on the "model" axis;
clients / batch on ("pod", "data")), as in the reference:

* column-parallel: qkv / FFN-in / up projections shard their *output*
  dim on "model"; row-parallel: wo / FFN-out shard their *input* dim.
* MoE expert stacks shard the expert dim on "model" when divisible (and,
  for very large expert counts, DeepSeek's 160, the FFN dim too: 2-D
  expert sharding).
* embeddings / unembeddings shard the vocab dim.
* norms, biases, gates, routers and small SSM tensors replicate.
* frozen leaves follow the same rules.

Every rule is divisibility-guarded: a dim that does not divide the axis
falls back to replication on that axis.

The reference writes a ``PartitionSpec`` (one entry a tensor dim); torch
places a tensor with one ``Placement`` a *mesh* dim (``Shard(d)`` or
``Replicate()``). :func:`_spec_for` keeps the reference's rule and guard
and returns the placements; :func:`spec_of` turns placements back into
the reference's spec tuple. A mesh here is a ``DeviceMesh`` or a
``launch/mesh.AbstractMesh``: the rules read its shape and axis names
only.

:func:`tensor_parallel_ok` names the configs whose steps run tensor-
parallel (``launch/specs``); :func:`local_pieces` takes a rank's pieces
of a tree without making any leaf whole, and :class:`ModelShards` is the
round engine's hook for the trainable tree's pieces.

The flat aggregation plane (:func:`flat_constrainer`) is where the mesh
meets the kernels. The kernels take raw pointers, so each rank runs them
on its local block of the ``(K, size)`` delta buffer, and every
cross-rank step is an explicit collective (:class:`FlatPlane`).
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import basic


# (regex over path, spec template): first match wins. Templates use
# NEGATIVE dim indices (relative to the trailing dims), so the same rule
# covers a bare leaf and its stacked (leading group dim) form. The four
# tables are the reference's, held to it by tests/test_torch_isolation.py.
_RULES = [
    # attention: column-parallel in, row-parallel out
    (r"/attn/w[qkv]/kernel$", {-1: "model"}),
    (r"/attn/w[qkv]/bias$", {-1: "model"}),
    (r"/attn/wo/kernel$", {-2: "model"}),
    (r"/cross_attn/w[qkv]/kernel$", {-1: "model"}),
    (r"/cross_attn/wo/kernel$", {-2: "model"}),
    # MLA
    (r"/attn/wq_b/kernel$", {-1: "model"}),
    (r"/attn/wk_b/kernel$", {-1: "model"}),
    (r"/attn/wv_b/kernel$", {-1: "model"}),
    # dense FFN
    (r"/ffn/wi(_gate|_up)?/kernel$", {-1: "model"}),
    (r"/ffn/wo/kernel$", {-2: "model"}),
    # MoE experts: stacked (E, d, ff) / (E, ff, d); expert dim on model
    (r"/moe/wi_(gate|up)$", {-3: "model"}),
    (r"/moe/wo$", {-3: "model"}),
    (r"/moe/shared/wi(_gate|_up)?/kernel$", {-1: "model"}),
    (r"/moe/shared/wo/kernel$", {-2: "model"}),
    # Mamba: in column-parallel, out row-parallel; channel tensors sharded
    (r"/mamba/in_proj/kernel$", {-1: "model"}),
    (r"/mamba/out_proj/kernel$", {-2: "model"}),
    (r"/mamba/x_proj/kernel$", {-2: "model"}),
    (r"/mamba/dt_proj/kernel$", {-1: "model"}),
    (r"/mamba/conv_w$", {-1: "model"}),
    (r"/mamba/conv_b$", {-1: "model"}),
    (r"/mamba/A_log$", {-2: "model"}),
    (r"/mamba/D$", {-1: "model"}),
    # xLSTM
    (r"/mlstm/up_proj/kernel$", {-1: "model"}),
    (r"/mlstm/down_proj/kernel$", {-2: "model"}),
    # embeddings: parallel-vocab
    (r"embed/embedding$", {-2: "model"}),
    (r"unembed/kernel$", {-1: "model"}),
]

# 2-D expert sharding for very large expert banks (DeepSeek-V2): expert
# dim on "data", FFN dim on "model".
_RULES_2D_EXPERTS = [
    (r"/moe/wi_(gate|up)$", {-3: "data", -1: "model"}),
    (r"/moe/wo$", {-3: "data", -2: "model"}),
]

# When the expert count does not divide the model axis (Mixtral's 8 on a
# 16-wide axis), shard the expert FFN dim instead (intra-expert TP).
_RULES_FFN_EXPERTS = [
    (r"/moe/wi_(gate|up)$", {-1: "model"}),
    (r"/moe/wo$", {-2: "model"}),
]

# 2-D expert sharding with the axes swapped (expert dim on "model", FFN
# dim on "data").
_RULES_2D_EXPERTS_SWAPPED = [
    (r"/moe/wi_(gate|up)$", {-3: "model", -1: "data"}),
    (r"/moe/wo$", {-3: "model", -2: "data"}),
]

Placements = Tuple[object, ...]


def placements_of(spec, mesh) -> Placements:
    """A reference spec (one entry a tensor dim: an axis name, a tuple of
    names, or None) -> one placement a mesh dim."""
    out = []
    for name in mesh_lib.axis_names(mesh):
        dims = [d for d, ax in enumerate(spec) if ax is not None and (
            ax == name or (isinstance(ax, tuple) and name in ax))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def spec_of(placements: Placements, mesh, ndim: int) -> tuple:
    """Placements -> the reference's spec tuple of ``ndim`` entries (an
    axis name, a tuple of names in mesh order, or None)."""
    spec = [[] for _ in range(ndim)]
    for name, p in zip(mesh_lib.axis_names(mesh), placements):
        if isinstance(p, Shard):
            spec[p.dim].append(name)
    return tuple(None if not s else (s[0] if len(s) == 1 else tuple(s))
                 for s in spec)


def _spec_for(path: str, shape, mesh, rules) -> Placements:
    sizes = mesh_lib.axis_sizes(mesh)
    spec = [None] * len(shape)
    for pat, dims in rules:
        if re.search(pat, path):
            for d, ax in dims.items():
                di = d + len(shape) if d < 0 else d
                if 0 <= di < len(shape) and shape[di] % sizes.get(ax, 1) == 0 \
                        and shape[di] >= sizes.get(ax, 1):
                    spec[di] = ax
            break
    return placements_of(spec, mesh)


def expert_mode(cfg: ModelConfig, mesh) -> str:
    """The expert stacks' layout on ``mesh``: ``cfg.expert_shard``, or
    for "auto" the reference's choice ("2d" for 64 experts or more, "ffn"
    when the expert count does not divide "model", else "model")."""
    mode = cfg.expert_shard
    if mode == "auto":
        msize = mesh_lib.axis_size(mesh, "model")
        mode = ("2d" if cfg.num_experts >= 64 else
                ("ffn" if cfg.num_experts and cfg.num_experts % msize else
                 "model"))
    return mode


def tensor_parallel_ok(cfg: ModelConfig, mesh) -> bool:
    """True for the families whose steps run tensor-parallel on "model"
    (``launch/specs``): slots of dense GQA attention and a dense or MoE
    FFN, with the experts in the ``model`` or ``ffn`` mode, so that every
    rule places its leaf on "model" alone. MLA, 2-D experts, the SSM
    slots, the VLM prefix and the encoder-decoder keep the gathered
    layout."""
    return (cfg.family in ("dense", "moe") and not cfg.use_mla
            and not cfg.is_encoder_decoder
            and (not cfg.num_experts
                 or expert_mode(cfg, mesh) in ("model", "ffn")))


def param_shardings(params_struct, cfg: ModelConfig, mesh):
    """Tree of placements matching the (possibly stacked) param tree."""
    rules = list(_RULES)
    mode = expert_mode(cfg, mesh)
    if mode == "2d":
        rules = _RULES_2D_EXPERTS + rules
    elif mode == "2d_swapped":
        rules = _RULES_2D_EXPERTS_SWAPPED + rules
    elif mode == "ffn":
        rules = _RULES_FFN_EXPERTS + rules
    return basic.unflatten_params({
        path: _spec_for(path, tuple(leaf.shape), mesh, rules)
        for path, leaf in basic.flatten_params(params_struct)})


def replicated(tree, mesh):
    n = len(mesh_lib.axis_names(mesh))
    return basic.tree_map(lambda _: (Replicate(),) * n, tree)


def batch_sharding(tree_struct, mesh, batch_axes=("pod", "data"),
                   batch_dim: int = 0):
    """Shard the leading (client / batch) dim over the data axes."""
    axes = tuple(a for a in batch_axes if a in mesh_lib.axis_names(mesh))
    sizes = mesh_lib.axis_sizes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]

    def one(leaf):
        spec = [None] * len(leaf.shape)
        if leaf.shape[batch_dim] % total == 0:
            spec[batch_dim] = axes if len(axes) > 1 else axes[0]
        return placements_of(spec, mesh)

    return basic.tree_map(one, tree_struct)


def batch_split(mesh, tokens) -> mesh_lib.DataSplit:
    """The data split of a step's batch rows ``tokens``: a DTensor's rows
    (dim 0) split over every data axis of more than one rank, in
    ``torch.chunk``'s pieces (the last short or empty), or over none (a
    whole tensor, or rows replicated). Uses the flat plane's data group
    (:class:`FlatPlane`)."""
    from torch.distributed.tensor import DTensor
    rows = int(tokens.shape[0])
    if not isinstance(tokens, DTensor):
        return mesh_lib.DataSplit(None, 1, 0, rows)
    names = mesh_lib.axis_names(mesh)
    sizes = mesh_lib.axis_sizes(mesh)
    axes = [a for a in mesh_lib.data_axes(mesh) if sizes[a] > 1]
    on = [a for a in axes if tokens.placements[names.index(a)] == Shard(0)]
    if not on:
        return mesh_lib.DataSplit(None, 1, 0, rows)
    if on != axes:
        raise NotImplementedError(f"batch rows split over {on} but not over "
                                  f"every data axis {axes}")
    plane = flat_constrainer(mesh)
    return mesh_lib.DataSplit(plane.data_group, plane.D, plane.d, rows)


def cache_shardings(cache_struct, cfg: ModelConfig, mesh, long_context: bool):
    """KV-cache / SSM-state placements for serving.

    decode_32k: batch over ("pod", "data"), cache seq over "model".
    long_500k (batch 1): cache seq over ("data", "model"); SSM states shard
    their channel dim. A leaf that is not a tensor (the cache length)
    replicates."""
    sizes = mesh_lib.axis_sizes(mesh)
    dax = mesh_lib.data_axes(mesh)
    total = 1
    for a in dax:
        total *= sizes[a]

    def one_path(path, leaf):
        if path.endswith("cache_len") or not hasattr(leaf, "shape"):
            return placements_of((), mesh)
        shp = tuple(leaf.shape)
        spec = [None] * len(shp)
        if any(path.endswith(s) for s in ("/k", "/v", "/ckv", "/kpe")):
            # (G, B, S, ...)
            if long_context:
                want = sizes.get("data", 1) * sizes.get("model", 1)
                if shp[2] % want == 0:
                    spec[2] = ("data", "model")
                elif shp[2] % sizes.get("model", 1) == 0:
                    spec[2] = "model"
            else:
                if shp[1] % total == 0:
                    spec[1] = dax if len(dax) > 1 else dax[0]
                if shp[2] % sizes.get("model", 1) == 0:
                    spec[2] = "model"
            return placements_of(spec, mesh)
        # SSM states: (G, B, channels, ...): shard the channel dim
        for d in range(2, len(shp)):
            if shp[d] % sizes.get("model", 1) == 0 \
                    and shp[d] >= sizes.get("model", 1):
                spec[d] = "model"
                break
        if not long_context and shp[1] % total == 0:
            spec[1] = dax if len(dax) > 1 else dax[0]
        return placements_of(spec, mesh)

    return basic.unflatten_params({
        p: one_path(p, leaf) for p, leaf in basic.flatten_params(cache_struct)})


# ---------------------------------------------------------------------------
# Local pieces and DTensors


def chunk_range(n: int, parts: int, i: int) -> Tuple[int, int]:
    """[start, stop) of piece ``i`` of ``n`` split as ``torch.chunk``
    splits it (pieces of ceil(n / parts), the last ones short or empty),
    the way a ``Shard`` placement splits a dim."""
    c = -(-n // parts) if parts else n
    return min(n, i * c), min(n, (i + 1) * c)


def local_range(n: int, mesh, placements: Placements, dim: int,
                coord=None) -> Tuple[int, int]:
    """This rank's [start, stop) of a tensor dim of size ``n`` under the
    placements: each mesh dim sharding ``dim``, in mesh order, splits the
    range left by the ones before it."""
    coord = mesh.get_coordinate() if coord is None else coord
    a, b = 0, n
    for i, (size, p) in enumerate(zip(mesh_lib.mesh_shape(mesh),
                                       placements)):
        if isinstance(p, Shard) and p.dim == dim:
            s, e = chunk_range(b - a, size, coord[i])
            a, b = a + s, a + e
    return a, b


def local_piece(full: torch.Tensor, mesh, placements: Placements):
    """This rank's piece of a tensor every rank holds whole."""
    out = full
    for d in range(full.ndim):
        a, b = local_range(full.shape[d], mesh, placements, d)
        if (a, b) != (0, full.shape[d]):
            out = out.narrow(d, a, b - a)
    return out


def distribute(full: torch.Tensor, mesh, placements: Placements):
    """A DTensor over ``mesh`` from a tensor every rank holds whole: each
    rank keeps its piece, with no communication."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_piece(full, mesh, placements).contiguous(),
                              mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def local_pieces(tree, placements, mesh):
    """This rank's piece of each leaf under ``placements``: a DTensor's
    local tensor (redistributed first if it is placed otherwise), a whole
    tensor's slice (a view: nothing is copied); no leaf is made whole."""
    from torch.distributed.tensor import DTensor

    def one(x, pl):
        if isinstance(x, DTensor):
            if tuple(x.placements) != tuple(pl):
                x = x.redistribute(x.device_mesh, pl)
            return x.to_local()
        return local_piece(x, mesh, pl)
    return basic.tree_map(one, tree, placements)


def from_local(t: torch.Tensor, mesh, placements: Placements, shape):
    """A DTensor of global ``shape`` over ``mesh`` from this rank's piece
    ``t``, with no communication."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(n) for n in shape)
    stride, step = [], 1
    for n in reversed(shape):            # the whole tensor's, contiguous
        stride.append(step)
        step *= max(n, 1)
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


class ModelShards:
    """The trainable tree's pieces on "model" in a tensor-parallel step
    (``launch/specs.make_train_step``): the round engine's
    ``model_shards`` hook. Each client trains this rank's pieces;
    :meth:`whole` gathers a client's delta over "model" (an exact
    concatenation, under ``torch.func.vmap``) for the flat plane, and
    :meth:`local` takes the aggregated update's pieces for the server's
    step on them. ``struct`` has the whole leaves' shapes (tensors on the
    meta device), for the flat layout."""

    def __init__(self, mesh, struct, placements):
        self.mesh = mesh
        self.placements = placements
        self.struct = basic.tree_map(
            lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                  device="meta"), struct)
        names = mesh_lib.axis_names(mesh)
        self.model_dim = (names.index("model") if "model" in names
                          else None)
        self.tp = mesh_lib.model_parallel(mesh)

    def _dim(self, pl):
        if self.model_dim is None:
            return None
        p = pl[self.model_dim]
        return p.dim if isinstance(p, Shard) else None

    def local(self, tree):
        return local_pieces(tree, self.placements, self.mesh)

    def whole(self, tree):
        def one(x, pl):
            d = self._dim(pl)
            return x if d is None else mesh_lib.tp_gather(x, d)
        with mesh_lib.tensor_parallel(self.tp):
            return basic.tree_map(one, tree, self.placements)

    def dtensors(self, tree):
        """This rank's pieces as DTensors of the whole shapes."""
        return basic.tree_map(
            lambda x, pl, st: from_local(x, self.mesh, pl, st.shape), tree,
            self.placements, self.struct)


def gathered(tree):
    """Every DTensor leaf of ``tree`` made whole on each rank (an explicit
    redistribute to replicated and its local tensor); other leaves as
    they are."""
    from torch.distributed.tensor import DTensor

    def one(x):
        return x.full_tensor() if isinstance(x, DTensor) else x
    return basic.tree_map(one, tree)


# ---------------------------------------------------------------------------
# The flat aggregation plane


class FlatPlane:
    """The flat aggregation plane of a mesh: the ``(K, size)`` client-delta
    buffer keeps its client / lane axis on the data axes (``("pod",
    "data")`` when both exist) and its size axis on ``"model"`` in whole
    ``align`` blocks (uneven splits pad as ``torch.chunk`` / GSPMD do:
    the last pieces short or empty); the aggregated ``(size,)`` vector
    stays on ``"model"``.

    Calling it as the reference's ``constrain_flat_fn(arr, clients)``
    returns this rank's block of a buffer every rank holds whole. The
    round engines and the tail call the explicit steps: :meth:`rows`,
    :meth:`blocks`, the gathers (pieces in rank order, trimmed of their
    padding), :meth:`sum_rows` (the partials all-gathered and added in
    rank order: a fixed order, no float atomics) and :meth:`max_model`.
    A step over an axis of one rank is no collective at all, so on a
    1-rank mesh the plane computes exactly what the unmeshed code does.
    """

    def __init__(self, mesh, align: int = 1024):
        self.mesh = mesh
        self.align = align
        names = mesh_lib.axis_names(mesh)
        sizes = mesh_lib.axis_sizes(mesh)
        coord = dict(zip(names, mesh.get_coordinate()))
        self.data_axes = mesh_lib.data_axes(mesh)
        self.model_axis = "model" if "model" in names else None
        self.D = 1
        self.d = 0
        for a in self.data_axes:             # pod-major flat data index
            self.d = self.d * sizes[a] + coord[a]
            self.D *= sizes[a]
        self.M = sizes.get("model", 1)
        self.m = coord.get("model", 0)
        self.model_group = (mesh.get_group("model") if self.M > 1 else None)
        self.data_group = None
        if self.D > 1:
            if len(self.data_axes) == 1:
                self.data_group = mesh.get_group(self.data_axes[0])
            else:
                # one group a model index over the flattened data axes;
                # every rank makes every group, in the same order
                ranks = mesh.mesh
                if self.model_axis is not None:
                    ranks = ranks.movedim(names.index("model"), -1)
                else:
                    ranks = ranks[..., None]
                for j in range(ranks.shape[-1]):
                    g = dist.new_group(ranks[..., j].flatten().tolist())
                    if j == self.m:
                        self.data_group = g

    # -- the partition -----------------------------------------------------

    def rows(self, k: int) -> Tuple[int, int]:
        return chunk_range(k, self.D, self.d)

    def blocks(self, nb: int) -> Tuple[int, int]:
        return chunk_range(nb, self.M, self.m)

    def cols(self, size: int) -> Tuple[int, int]:
        b0, b1 = self.blocks(size // self.align)
        return b0 * self.align, b1 * self.align

    def local_rows(self, x):
        r0, r1 = self.rows(x.shape[0])
        return x[r0:r1]

    def local_cols(self, x):
        c0, c1 = self.cols(x.shape[-1])
        return x[..., c0:c1]

    def __call__(self, arr, clients: bool):
        return self.local_cols(self.local_rows(arr) if clients else arr)

    def placements(self, clients: bool) -> Placements:
        """The reference's spec for the plane (``P(client_axes, model)``
        or ``P(model)``) as placements."""
        dax = self.data_axes
        client_axes = dax if len(dax) > 1 else (dax[0] if dax else None)
        spec = (client_axes, self.model_axis) if clients \
            else (self.model_axis,)
        return placements_of(spec, self.mesh)

    # -- collectives ----------------------------------------------------------

    def _gather(self, x, n: int, parts: int, group, dim: int):
        """Pieces of a dim of global size ``n`` split over ``parts`` ranks
        -> the whole dim, in rank order."""
        if parts == 1:
            return x
        c = -(-n // parts)
        xd = x.movedim(dim, 0)
        if xd.shape[0] < c:
            pad = torch.zeros((c - xd.shape[0],) + tuple(xd.shape[1:]),
                              dtype=xd.dtype, device=xd.device)
            xd = torch.cat([xd, pad])
        full = mesh_lib.all_gather(xd, group)
        pieces = [full[i * c:i * c + (e - s)]
                  for i, (s, e) in enumerate(chunk_range(n, parts, j)
                                             for j in range(parts))]
        return torch.cat(pieces).movedim(0, dim)

    def gather_rows(self, x, k: int):
        """(rows of this rank, ...) -> (k, ...)."""
        return self._gather(x, k, self.D, self.data_group, 0)

    def gather_blocks(self, x, nb: int):
        """(..., blocks of this rank) -> (..., nb): per-block tables."""
        return self._gather(x, nb, self.M, self.model_group, x.ndim - 1)

    def gather_cols(self, x, size: int):
        """(..., columns of this rank) -> (..., size), in whole blocks."""
        if self.M == 1:
            return x
        blk = x.reshape(x.shape[:-1] + (-1, self.align))
        full = self._gather(blk, size // self.align, self.M,
                            self.model_group, blk.ndim - 2)
        return full.reshape(x.shape[:-1] + (size,))

    def gather_table(self, x, k: int, nb: int):
        """A (rows, blocks) table of this rank's block -> (k, nb)."""
        return self.gather_rows(self.gather_blocks(x, nb), k)

    def sum_rows(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum over the data ranks of each rank's partial, added in
        rank order."""
        if self.D == 1:
            return partial
        parts = mesh_lib.all_gather(partial[None], self.data_group)
        acc = parts[0]
        for i in range(1, self.D):
            acc = acc + parts[i]
        return acc

    def max_model(self, t: torch.Tensor) -> torch.Tensor:
        """Max over the model ranks of float32 magnitudes (NaN kept): an
        int32 max of the bit patterns, exact."""
        if self.M == 1:
            return t
        bits = t.contiguous().view(torch.int32)
        return mesh_lib.all_reduce(bits, "max", self.model_group).view(
            torch.float32)

    def all_model(self, b: torch.Tensor) -> torch.Tensor:
        """Logical AND over the model ranks."""
        if self.M == 1:
            return b
        return mesh_lib.all_reduce(b.to(torch.int32), "min",
                                   self.model_group).bool()


_PLANES: Dict[int, FlatPlane] = {}


def flat_constrainer(mesh) -> FlatPlane:
    """The flat plane of ``mesh`` (:class:`FlatPlane`), made once a mesh
    (it makes process groups): the one sharding rule of the flat
    aggregation plane, shared by ``launch/specs.py`` and the simulation
    grid so the two cannot drift."""
    plane = _PLANES.get(id(mesh))
    if plane is None or plane.mesh is not mesh:
        plane = _PLANES[id(mesh)] = FlatPlane(mesh)
    return plane

