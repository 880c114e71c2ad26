"""Seed-based reconstruction of frozen parameters (Algorithm 1, line 5),
port of ``repro/core/reconstruct.py``.

Clients receive ``(y_t, z)`` with ``z`` a scalar seed and regenerate the
frozen leaves locally: every leaf's key is ``fold_in(key(z),
crc32(path))`` (nn/basic.py), so any holder of ``z`` draws the same
Gaussians.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core import partition as part
from repro_torch.nn import basic


def reconstruct(init_fn: Callable[..., Dict[str, Any]], seed: int,
                freeze_spec, device=None) -> Dict[str, Any]:
    """Regenerate the frozen tree from the scalar seed."""
    return part.partition(init_fn(seed, device=device), freeze_spec)[1]


def make_reconstructor(init_fn, seed: int, freeze_spec, device=None):
    """Zero-argument reconstructor of the frozen tree (the reference jits
    it; eager torch draws every leaf and keeps the frozen ones)."""

    def _rec():
        return reconstruct(init_fn, seed, freeze_spec, device=device)

    return _rec


def init_partitioned(init_fn, seed: int, freeze_spec, device=None):
    """Server-side round-0 split: (y0, frozen)."""
    return part.partition(init_fn(seed, device=device), freeze_spec)


def verify_roundtrip(init_fn, seed: int, freeze_spec, device=None) -> bool:
    """Invariant: merge(partition(x)) == x and reconstruct is exact."""
    full = init_fn(seed, device=device)
    y, z = part.partition(full, freeze_spec)
    z2 = reconstruct(init_fn, seed, freeze_spec, device=device)
    fz, fz2 = dict(basic.flatten_params(z)), dict(basic.flatten_params(z2))
    ok = set(fz) == set(fz2) and all(torch.equal(fz[k], fz2[k]) for k in fz)
    fa = dict(basic.flatten_params(full))
    fb = dict(basic.flatten_params(part.merge(y, z)))
    ok2 = set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)
    return ok and ok2
