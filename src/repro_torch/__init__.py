"""PyTorch/CUDA port of the FedPT reproduction in ``src/repro``.

Sub-packages and function names mirror ``repro`` so that every function
has a findable counterpart; inside, the code is plain PyTorch: parameter
trees are nested ``dict[str, Tensor]`` keyed like the JAX trees, random
generators are explicit, and every entry point takes a ``device``.

This package never imports ``jax`` nor any module of ``repro``
(``repro/__init__.py`` imports jax and flips a process-wide PRNG flag);
what it needs from there it keeps as its own copy.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is wanted (explicitly or by default) and
    there is none, so the port never drops to the CPU on its own; pass
    ``device="cpu"`` to run the plain versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:   # so that it compares equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
