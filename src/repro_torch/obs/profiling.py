"""Optional ``torch.profiler`` annotation hooks for traced grid runs, port
of ``repro/obs/profiling.py``.

Virtual-time spans (``obs/trace.py``) say *when the simulated fleet* was
busy; a wall-time profile says where the *host* and the card actually
spent their time. With ``TelemetryConfig(profile=True)`` the grid wraps
its hot paths — the sync round, the async lane step (one per tier) and
the buffered-apply server tail — in named ranges, so a profile captured
around the run (``torch.profiler.profile``, or :func:`capture`) shows
``grid/round_fn``, ``grid/lane_step[<tier>]`` and ``grid/server_apply``
blocks that line up with the virtual-time flush spans one to one.

A range is a ``torch.profiler.record_function`` (what the PyTorch
profiler records), plus an NVTX range when the run's device is CUDA, so
Nsight Systems sees the same names. Opening and closing a range adds no
device synchronization.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def annotation(name: str, cuda: bool = False):
    """Context manager marking a named region in the profiler timeline;
    ``cuda`` adds an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if not cuda:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def annotate(fn: Callable, name: str, enabled: bool = True,
             cuda: bool = False) -> Callable:
    """Wrap ``fn`` so each call runs inside ``annotation(name)``. With
    ``enabled=False`` (telemetry off, or profile not requested) returns
    ``fn`` unchanged — no added frame on the default path."""
    if not enabled:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with annotation(name, cuda):
            return fn(*args, **kwargs)

    return wrapped


def annotate_map(fns: dict, name: str, enabled: bool = True,
                 cuda: bool = False) -> dict:
    """``annotate`` over a dict of callables (the grid's per-tier lane
    step / client step tables), tagging each with its key."""
    if not enabled:
        return fns
    return {k: annotate(fn, f"{name}[{k}]", cuda=cuda)
            for k, fn in fns.items()}


@contextlib.contextmanager
def capture(path: Optional[str]):
    """Context manager: profile the enclosed block (CPU, and CUDA when
    there is a card) and write a Chrome trace (JSON) to ``path``; a no-op
    when ``path`` is None. The reference writes a TensorBoard logdir
    through ``jax.profiler.trace`` instead."""
    if path is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
