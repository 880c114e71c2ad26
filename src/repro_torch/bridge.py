"""Parameter trees across the two packages.

The JAX package's trees, handed over as nested dicts of numpy arrays,
become the port's nested ``dict[str, Tensor]`` and back. Layouts are kept
as they are (HWIO conv kernels, ``(d_in, d_out)`` dense kernels), so the
two packages' flat buffers line up leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device


def from_numpy_tree(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of array-likes -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)


def to_numpy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
