"""Hand-written CUDA kernels of the port, with their plain torch versions.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs
the plain version (``kernels/ref.py``) for a CPU tensor. ``LAUNCHES``
counts, per kernel, the wrapper calls that launched it, so a run can
show that its main path went through the kernels; ``ROUTES`` splits them
by route where a wrapper picks one by shape.
"""
from __future__ import annotations

LAUNCHES = {"sumsq": 0, "leaf_maxabs": 0, "fake_quantize_flat": 0,
            "block_stats": 0, "pack": 0, "apply_coeff": 0, "clip_flat": 0,
            "clip_accumulate": 0, "swa_attention": 0, "seed_reconstruct": 0}
# launches of a kernel with more than one route, by route
ROUTES = {"fake_quantize_flat/cluster": 0, "fake_quantize_flat/two_pass": 0,
          "clip_flat/cluster": 0, "clip_flat/three_launch": 0,
          "pack/row_combine": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0
