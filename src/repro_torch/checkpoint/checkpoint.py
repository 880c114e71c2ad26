"""Checkpointing, port of ``repro/checkpoint/checkpoint.py``.

A FedPT checkpoint stores only the *trainable* tree, the scalar seed, the
freeze-spec and the server optimizer state — the frozen side regenerates
from the seed on restore, so checkpoints shrink by the frozen fraction
(the same 46x as the communication path, for the CIFAR-10 2.16% row).

The file is the reference's: one ``.npz`` with ``y/<path>`` per trainable
leaf, ``s/<i>`` per server-state leaf in JAX's leaf order (dict keys
sorted, tuples and lists in order, ``None`` no leaf) and a ``__meta__``
JSON, so either package reads what the other wrote. Leaves go to the host
through ``.detach().cpu().numpy()`` and come back on the caller's device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.nn import basic


def with_suffix(path: str) -> str:
    """Normalize a checkpoint path to carry the ``.npz`` suffix.

    ``np.savez`` silently appends ``.npz`` when the path lacks it, so
    both ends normalize through this and any spelling round-trips."""
    return path if path.endswith(".npz") else path + ".npz"


# ---------------------------------------------------------------------------
# server-state trees (dicts, tuples, lists, None; tensor and int leaves)


def state_leaves(tree) -> List[Any]:
    """The leaves of a server-state tree in JAX's ``tree_leaves`` order
    (tensors and Python ints)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in state_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in state_leaves(v)]
    if tree is None:
        return []
    return [tree]


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the same tree."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        return "None" if t is None else "*"
    return f"PyTreeDef({node(tree)})"


def leaf_to_numpy(leaf) -> np.ndarray:
    """A leaf on the host. A Python int (an optimizer's step counter) is
    written as int32, as JAX's integer counters are without x64."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return leaf.detach().cpu().numpy()


def to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor of its dtype on ``dev``."""
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def leaf_from_numpy(arr: np.ndarray, like, dev: torch.device):
    """``arr`` as the type the template leaf ``like`` holds: a Python int,
    or a tensor of the template's dtype on ``dev``."""
    if isinstance(like, int):
        return int(arr)
    return to_device(arr, dev).to(like.dtype)


def state_from_leaves(template, leaves: List[Any], dev: torch.device):
    """Rebuild ``template``'s structure from ``leaves`` (numpy arrays in
    :func:`state_leaves` order), each leaf as the template's type."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return leaf_from_numpy(next(it), t, dev)
    return build(template)


def tree_arrays(prefix: str, tree) -> Dict[str, np.ndarray]:
    """``{prefix/path: array}`` for every leaf of a parameter tree."""
    return {f"{prefix}/{k}": leaf_to_numpy(v)
            for k, v in basic.flatten_params(tree)}


def arrays_tree(prefix: str, arrays: Dict[str, np.ndarray],
                dev: torch.device):
    """The parameter tree under ``prefix`` of :func:`tree_arrays`'s
    output, as tensors on ``dev``."""
    cut = len(prefix) + 1
    return basic.unflatten_params({
        k[cut:]: to_device(v, dev)
        for k, v in arrays.items() if k.startswith(prefix + "/")})


# ---------------------------------------------------------------------------
# model checkpoints


def save(path: str, trainable, seed: int, freeze_spec, server_state=None,
         round_num: int = 0, extra: Optional[Dict[str, Any]] = None):
    path = with_suffix(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = tree_arrays("y", trainable)
    if server_state is not None:
        for i, l in enumerate(state_leaves(server_state)):
            arrays[f"s/{i}"] = leaf_to_numpy(l)
        meta_state = treedef_str(server_state)
    else:
        meta_state = ""
    meta = {"seed": int(seed), "freeze_spec": list(freeze_spec),
            "round": int(round_num), "server_state_treedef": meta_state,
            "extra": extra or {}}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load(path: str, server_state_template=None, device=None):
    """Returns (trainable, seed, freeze_spec, server_state, round, extra),
    the tensors on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with np.load(with_suffix(path), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        trainable = arrays_tree("y", {k: z[k] for k in z.files}, dev)
        server_state = None
        if server_state_template is not None:
            n = len(state_leaves(server_state_template))
            server_state = state_from_leaves(
                server_state_template, [z[f"s/{i}"] for i in range(n)], dev)
    return (trainable, meta["seed"], tuple(meta["freeze_spec"]),
            server_state, meta["round"], meta["extra"])


def restore_full_model(path: str, init_fn, device=None):
    """Restore the complete model on ``device``: trainable from the file,
    frozen regenerated from the stored seed through ``init_fn(seed)``
    (the port's path-keyed init)."""
    from repro_torch.core import partition as part
    dev = resolve_device(device)
    trainable, seed, freeze_spec, _, rnd, _ = load(path, device=dev)
    frozen = part.partition(init_fn(seed), freeze_spec)[1]
    frozen = basic.tree_map(lambda t: t.to(dev), frozen)
    return part.merge(trainable, frozen), rnd
