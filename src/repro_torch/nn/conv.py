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


def same_pads(n: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one spatial axis of length n: the
    output keeps ceil(n / stride) positions, the total pad is
    max((ceil(n / stride) - 1) * stride + k - n, 0), and the low side
    takes the smaller half. Returns (low, high)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x, p, stride: int = 1, padding: str = "SAME"):
    """NHWC x, HWIO kernel, at any stride. ``"SAME"`` pads as XLA does
    (:func:`same_pads`): a symmetric pad rides in ``F.conv2d``, an
    uneven one (stride 2 on an even side, an even kernel) is applied
    with ``F.pad`` before a VALID convolution; ``"VALID"`` pads
    nothing."""
    w = p["kernel"].to(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        (hl, hh), (wl, wh) = (same_pads(x.shape[1], kh, stride),
                              same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        hl = hh = wl = wh = 0
    else:
        raise ValueError(f"unknown padding {padding!r}")
    xc = x.permute(0, 3, 1, 2)
    if (hl, wl) == (hh, wh):
        pad = (hl, wl)
    else:
        xc, pad = F.pad(xc, (wl, wh, hl, hh)), 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def maxpool2d(x, window: int = 2, stride: int = 2):
    """VALID max-pool over the H and W axes of an NHWC tensor."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avgpool_global(x):
    """Mean over the H and W axes of an NHWC tensor: (N, H, W, C) -> (N, C)."""
    return x.mean(dim=(1, 2))


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
