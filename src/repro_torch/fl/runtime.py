"""Federated runtime, port of ``repro/fl/runtime.py``: the server training
loop that examples and benchmarks call.

``run_federated`` is the homogeneous-synchronous special case of the
simulation grid (``sim/grid.py``): a uniform always-available fleet, no
straggler deadline, no over-selection. Heterogeneous fleets, straggler
handling and buffered async aggregation are reached by passing a
``sim.grid.GridConfig`` to ``sim.grid.run_grid`` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import comm, fedpt
from repro_torch.nn.basic import tree_leaves
from repro_torch.sim import grid as simgrid


@dataclasses.dataclass
class TrainResult:
    y: Any
    frozen: Any
    history: List[Dict[str, float]]
    comm: comm.CommReport
    seconds_per_round: float


def run_federated(init_fn: Callable[[int], Any], loss_fn: Callable,
                  dataset, rc: fedpt.RoundConfig, rounds: int,
                  freeze_spec=(), seed: int = 0, data_kind: str = "images",
                  eval_every: int = 0,
                  eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
                  server_opt=None, log: bool = False,
                  device=None) -> TrainResult:
    """Generic FedPT training loop (freeze_spec=() == fully trainable
    FedAvg — the paper's baseline), on ``device`` (CUDA by default).
    Delegates to the simulation grid in its homogeneous-synchronous
    configuration, which equals a plain round loop fed the same streams
    bit for bit."""
    res = simgrid.run_grid(init_fn, loss_fn, dataset, rc, rounds,
                           grid=simgrid.GridConfig(mode="sync",
                                                   fleet="uniform"),
                           freeze_spec=freeze_spec, seed=seed,
                           data_kind=data_kind, eval_every=eval_every,
                           eval_fn=eval_fn, server_opt=server_opt, log=log,
                           device=device)
    return TrainResult(y=res.y, frozen=res.frozen, history=res.history,
                       comm=res.comm, seconds_per_round=res.seconds_per_round)


def dataset_num_clients(ds) -> int:
    return simgrid.num_clients(ds)


def accuracy_eval(forward_fn, images, labels, batch: int = 256):
    """Classification accuracy evaluator factory: ``images`` and
    ``labels`` are host arrays, moved batch by batch to the device of the
    parameters the evaluator is given."""

    def ev(params):
        dev = tree_leaves(params)[0].device
        correct = 0
        with torch.no_grad():
            for i in range(0, len(labels), batch):
                logits = forward_fn(params, torch.as_tensor(
                    images[i:i + batch], device=dev))
                want = torch.as_tensor(labels[i:i + batch], device=dev)
                correct += int((logits.argmax(-1) == want).sum())
        return {"accuracy": correct / len(labels)}

    return ev


def nwp_accuracy_eval(forward_fn, tokens, batch: int = 128):
    """Next-word-prediction accuracy (the paper's SO NWP metric): the
    share of positions 1..S-1 whose token is the argmax of the logits at
    the position before. ``tokens`` is a host (N, S) array, moved batch by
    batch to the device of the parameters the evaluator is given."""

    def ev(params):
        dev = tree_leaves(params)[0].device
        correct = total = 0
        with torch.no_grad():
            for i in range(0, len(tokens), batch):
                t = torch.as_tensor(tokens[i:i + batch], device=dev)
                pred = forward_fn(params, t)[:, :-1, :].argmax(-1)
                correct += int((pred == t[:, 1:]).sum())
                total += pred.numel()
        return {"accuracy": correct / total}

    return ev
