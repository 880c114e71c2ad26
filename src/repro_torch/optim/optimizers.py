"""Minimal functional optimizers, port of ``repro/optim/optimizers.py``:
(init, update) pairs over parameter dicts, used as ClientOpt (fresh
state every round) and ServerOpt (state kept across rounds). Updates
return new tensors; nothing is modified in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.nn.basic import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (params, grads, state) -> (params, state)
    name: str = ""


def sgd(lr: float) -> Optimizer:
    def init(_params):
        return ()

    def update(params, grads, state):
        return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads), state

    return Optimizer(init, update, f"sgd(lr={lr})")


def sgdm(lr: float, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(params, grads, m):
        m = tree_map(lambda mm, g: momentum * mm + g.to(mm.dtype), m, grads)
        if nesterov:
            step = tree_map(lambda mm, g: momentum * mm + g.to(mm.dtype),
                            m, grads)
        else:
            step = m
        new = tree_map(lambda p, s: p - lr * s.to(p.dtype), params, step)
        return new, m

    return Optimizer(init, update, f"sgdm(lr={lr},m={momentum})")


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        return {"m": z, "v": tree_map(torch.clone, z), "t": 0}

    def update(params, grads, state):
        t = state["t"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g.float().square(),
                     state["v"], grads)
        # JAX computes the bias corrections in float32
        bc1 = float(1 - np.float32(b1) ** np.float32(t))
        bc2 = float(1 - np.float32(b2) ** np.float32(t))
        new = tree_map(lambda p, mm, vv: p - (lr * (mm / bc1) / (
            torch.sqrt(vv / bc2) + eps)).to(p.dtype), params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, f"adam(lr={lr})")


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"sgd": sgd, "sgdm": sgdm, "adam": adam}[name](lr, **kw)


# --- tree arithmetic helpers -------------------------------------------------


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_global_norm(tree):
    return torch.sqrt(sum(l.float().square().sum() for l in tree_leaves(tree)))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)
