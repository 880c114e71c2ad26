"""The paper's EMNIST CNN (Table 6), port of ``repro/models/paper_models.py``:
conv(5x5,32) -> maxpool -> conv(5x5,64) -> GN -> maxpool -> dense(512) ->
dense(62). 1,690,174 params; freezing the first dense layer leaves 4.97%
trainable.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.nn import basic, conv as conv_lib


def init_emnist_cnn(seed: int, dtype=torch.float32,
                    device=None) -> Dict[str, Any]:
    kw = dict(dtype=dtype, device=device)
    return {
        "conv1": conv_lib.init_conv(seed, "conv1", 5, 1, 32, **kw),
        "conv2": conv_lib.init_conv(seed, "conv2", 5, 32, 64, **kw),
        "gn": conv_lib.init_groupnorm(seed, "gn", 64, **kw),
        "dense1": basic.init_dense(seed, "dense1", 3136, 512, bias=True, **kw),
        "dense2": basic.init_dense(seed, "dense2", 512, 62, bias=True, **kw),
    }


def emnist_cnn_forward(params, images):
    """images: (B, 28, 28, 1) NHWC -> logits (B, 62)."""
    x = conv_lib.conv2d(images, params["conv1"])
    x = torch.relu(x)
    x = conv_lib.maxpool2d(x)
    x = conv_lib.conv2d(x, params["conv2"])
    x = conv_lib.apply_groupnorm(x, params["gn"], groups=2)
    x = torch.relu(x)
    x = conv_lib.maxpool2d(x)
    # flatten in NHWC order: the frozen (3136, 512) kernel expects the
    # 7*7*64 channel-last order, an NCHW flatten would scramble it
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(basic.dense(x, params["dense1"]))
    return basic.dense(x, params["dense2"])


# FedPT freeze spec from the paper: the first dense layer (95.03% of params)
EMNIST_FREEZE = (r"^dense1/",)
