"""Functional NN primitives (port of ``repro/nn/basic.py``): path-keyed
deterministic initialization, parameter-tree utilities, norms, dense
layers, embeddings and gated MLPs.

Parameters live in nested ``dict[str, Tensor]`` trees with the JAX
package's key paths. Every leaf is drawn from a key derived from the
root seed and the parameter path, through the threefry port, so a client
holding only the scalar seed regenerates the frozen leaves that JAX
would (core/reconstruct.py).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import threefry

Params = Dict[str, Any]


def path_key(root_seed, path: str) -> threefry.Key:
    """The PRNG key of a parameter path: ``fold_in(key(seed),
    crc32(path) & 0x7FFFFFFF)``, stable across processes and packages."""
    k = threefry.key(root_seed) if isinstance(root_seed, int) else root_seed
    return threefry.fold_in(k, zlib.crc32(path.encode()) & 0x7FFFFFFF)


def normal_init(root_seed, path: str, shape, dtype=torch.float32,
                fan_in: int | None = None, stddev: float | None = None,
                device=None):
    """Gaussian init, LeCun-normal by fan-in unless ``stddev`` is given."""
    if stddev is None:
        if fan_in is None:
            fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
        stddev = 1.0 / np.sqrt(max(fan_in, 1))
    dev = resolve_device(device)
    z = threefry.normal(path_key(root_seed, path), shape, dev)
    # JAX multiplies the f32 draw by the f32-rounded stddev (in place here:
    # one leaf-sized buffer)
    return z.mul_(float(np.float32(stddev))).to(dtype)


def zeros_init(_root_seed, _path, shape, dtype=torch.float32, device=None,
               **_kw):
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def ones_init(_root_seed, _path, shape, dtype=torch.float32, device=None,
              **_kw):
    return torch.ones(shape, dtype=dtype, device=resolve_device(device))


# Initializer registry used by reconstruct: every leaf records how it was
# made so the frozen side can be regenerated without shipping bytes.
INITIALIZERS = {
    "normal": normal_init,
    "zeros": zeros_init,
    "ones": ones_init,
}


# ---------------------------------------------------------------------------
# Param tree utilities


def flatten_params(tree: Params, prefix: str = "") -> Iterable[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order — jax's pytree leaf order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flatten_params(v, path)
        else:
            yield path, v


def unflatten_params(flat: Dict[str, Any]) -> Params:
    out: Params = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over trees of one structure (the first's)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    return [v for _, v in flatten_params(tree)]


def tree_size(tree) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(np.prod(tuple(x.shape))) * x.element_size()
               for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Norms and dense layers


def groupnorm(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """GroupNorm over channel-last input (N, H, W, C) or (N, C), in f32."""
    dt = x.dtype
    x = x.float()
    c = x.shape[-1]
    xg = x.reshape(x.shape[:-1] + (num_groups, c // num_groups))
    axes = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
    mu = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    x = xg.reshape(x.shape)
    return (x * scale.float() + bias.float()).to(dt)


def init_dense(seed, path, d_in, d_out, dtype=torch.float32,
               bias: bool = False, device=None):
    p = {"kernel": normal_init(seed, f"{path}/kernel", (d_in, d_out), dtype,
                               fan_in=d_in, device=device)}
    if bias:
        p["bias"] = zeros_init(seed, f"{path}/bias", (d_out,), dtype,
                               device=device)
    return p


def dense(x, p, compute_dtype=None):
    """x @ kernel (+ bias), kernel kept in JAX's (d_in, d_out) layout."""
    k = p["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    y = x @ k
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms (scale by 1 + scale, computed in float32, cast back)


def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dt)


def init_norm(seed, path, d, dtype, norm_type: str, device=None):
    p = {"scale": zeros_init(seed, f"{path}/scale", (d,), dtype, device)}
    if norm_type != "rmsnorm":
        p["bias"] = zeros_init(seed, f"{path}/bias", (d,), dtype, device)
    return p


def apply_norm(x, p, norm_type: str):
    if norm_type == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Embedding, activations and MLP


def init_embedding(seed, path, vocab, d, dtype, device=None):
    return {"embedding": normal_init(seed, f"{path}/embedding", (vocab, d),
                                     dtype, stddev=0.02, device=device)}


def _vocab_piece(table_rows: int, vocab: int):
    """The ambient tensor-parallel group when a (vocab, ...) table holds
    only this rank's rows of ``vocab`` (its vocab dim split on "model"),
    else None."""
    tp = mesh_lib.current_tp()
    return tp if tp is not None and vocab and table_rows != vocab else None


def embed(ids, p, compute_dtype, vocab: int = 0):
    """The rows of ``ids``. Under tensor parallelism with the table's
    vocab rows split (``vocab`` the whole vocab), a masked lookup of this
    rank's rows, the others' ids zero, summed over the ranks (exact: one
    rank holds each id)."""
    table = p["embedding"]
    tp = _vocab_piece(table.shape[0], vocab)
    if tp is None:
        return table[ids].to(compute_dtype)
    n = table.shape[0]
    local = ids.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)].to(compute_dtype)
    return mesh_lib.tp_reduce(torch.where(inside[..., None], rows, 0.0))


def unembed(x, p, compute_dtype, vocab: int = 0):
    """Tied logits ``x @ embedding.T``; with the vocab rows split on
    "model", this rank's vocab columns of them."""
    table = p["embedding"]
    if _vocab_piece(table.shape[0], vocab) is not None:
        x = mesh_lib.tp_copy(x)
    return x.to(compute_dtype) @ table.to(compute_dtype).T


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": torch.nn.functional.silu, "gelu": _gelu,
            "relu": torch.relu}[name]


def init_mlp(seed, path, d_model, d_ff, dtype, gated: bool = True,
             bias: bool = False, device=None):
    names = ("wi_gate", "wi_up", "wo") if gated else ("wi", "wo")
    return {n: init_dense(seed, f"{path}/{n}",
                          d_ff if n == "wo" else d_model,
                          d_model if n == "wo" else d_ff, dtype, bias,
                          device=device)
            for n in names}


def row_parallel(x, p, compute_dtype=None):
    """``dense`` on a row-parallel (input-dim split) kernel: this rank's
    partial product, summed over the "model" ranks, then the bias."""
    y = mesh_lib.tp_reduce(dense(x, {"kernel": p["kernel"]}, compute_dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def mlp(x, p, act: str, compute_dtype, d_ff: int = 0):
    """The (gated) MLP. Under tensor parallelism with the FFN dim split
    on "model" (``d_ff`` the whole width, ``wo``'s rows this rank's):
    the input enters through ``tp_copy``, the up projections give this
    rank's columns, and ``wo``'s partial products are summed over the
    ranks."""
    f = activation(act)
    split = (mesh_lib.current_tp() is not None and d_ff
             and p["wo"]["kernel"].shape[-2] != d_ff)
    out = row_parallel if split else dense
    if split:
        x = mesh_lib.tp_copy(x)
    if "wi_gate" in p:
        g = dense(x, p["wi_gate"], compute_dtype)
        u = dense(x, p["wi_up"], compute_dtype)
        return out(f(g) * u, p["wo"], compute_dtype)
    h = f(dense(x, p["wi"], compute_dtype))
    return out(h, p["wo"], compute_dtype)


def maybe_constrain(x, spec):
    """Best-effort sharding constraint, port of the reference's
    GSPMD hint.

    Filters the spec per dimension: an axis that is absent from the
    ambient mesh (``launch/mesh.use_mesh``), or that does not divide the
    dimension, degrades to None for that dim only, instead of dropping
    the whole constraint. A no-op without an ambient mesh and on a plain
    tensor (a rank's local computation has nothing to place); a DTensor
    is redistributed to the filtered spec (a dim left None replicates,
    as the reference's constraint replicates it)."""
    mesh = mesh_lib.get_abstract_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    sizes = mesh_lib.axis_sizes(mesh)
    filt = []
    for d, ax in enumerate(spec):
        if ax is None:
            filt.append(())
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        # keep the subset of axes that exist on the ambient mesh
        present = tuple(a for a in axes if a in sizes)
        total = 1
        for a in present:
            total *= sizes[a]
        if present and d < x.ndim and x.shape[d] % total == 0 \
                and x.shape[d] >= total:
            filt.append(present)
        else:
            filt.append(())
    if not any(filt):
        return x
    placements = []
    for name in mesh_lib.axis_names(mesh):
        dims = [d for d, axes in enumerate(filt) if name in axes]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return x.redistribute(x.device_mesh, tuple(placements))
