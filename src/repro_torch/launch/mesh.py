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
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_reduce(t.contiguous(), op, group))
