"""Convolutional primitives (port of ``repro/nn/conv.py``).

The public layout stays JAX's: NHWC activations and HWIO kernels, so
parameters and flat buffers line up with the reference; the tensors are
permuted only around ``F.conv2d`` / ``F.max_pool2d``. The convolution
stays a library call, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import basic


def init_conv(seed, path, k, c_in, c_out, dtype=torch.float32,
              bias: bool = True, device=None):
    p = {"kernel": basic.normal_init(seed, f"{path}/kernel",
                                     (k, k, c_in, c_out), dtype,
                                     fan_in=k * k * c_in, device=device)}
    if bias:
        p["bias"] = basic.zeros_init(seed, f"{path}/bias", (c_out,), dtype,
                                     device=device)
    return p


def conv2d(x, p, stride: int = 1, padding: str = "SAME"):
    """NHWC x, HWIO kernel. ``"SAME"`` at stride 1 pads (k-1)//2 on each
    side (odd kernels only); ``"VALID"`` pads nothing."""
    w = p["kernel"].to(x.dtype)
    k = w.shape[0]
    if padding == "SAME":
        if stride != 1 or k % 2 == 0:
            raise NotImplementedError("SAME padding is ported for odd "
                                      "kernels at stride 1 only")
        pad = (k - 1) // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def maxpool2d(x, window: int = 2, stride: int = 2):
    """VALID max-pool over the H and W axes of an NHWC tensor."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def init_groupnorm(seed, path, c, dtype=torch.float32, device=None):
    return {"scale": basic.ones_init(seed, f"{path}/scale", (c,), dtype,
                                     device=device),
            "bias": basic.zeros_init(seed, f"{path}/bias", (c,), dtype,
                                     device=device)}


def apply_groupnorm(x, p, groups: int = 32):
    g = min(groups, x.shape[-1])
    while x.shape[-1] % g:
        g -= 1
    return basic.groupnorm(x, p["scale"], p["bias"], g)
