"""The paper's three experiment models, port of
``repro/models/paper_models.py`` with the reference's parameter paths (so
path-keyed init draws the reference's bits):

* EMNIST CNN (Table 6): conv(5x5,32) -> maxpool -> conv(5x5,64) -> GN ->
  maxpool -> dense(512) -> dense(62). 1,690,174 params; freezing the
  first dense layer leaves 4.97% trainable.
* ResNet-18 with GroupNorm for CIFAR-10 (Table 2): frozen conv stages
  3 / 3,2 / 3,2,1 / 3,2,1,0 give 26.09 / 7.61 / 2.99 / 1.67 % trainable
  (the reference's counts; the paper prints 26.25 / 8.07 / 3.47 / 2.16).
* Stack Overflow NWP Transformer (Table 3): 3 layers, d=96, d_ff=2048,
  8 heads x 12, vocab 10,004; freezing the first FFN dense of blocks
  2 / 1,2 / 0,1,2 leaves 91.22 / 82.43 / 73.65 % trainable. Its
  attention is the plain einsum of the reference (no kernel in either
  package).
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# ResNet-18 with GroupNorm (CIFAR-10)

_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (channels, first stride)


def init_resnet18(seed: int, num_classes: int = 10, dtype=torch.float32,
                  device=None) -> Dict[str, Any]:
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {
        "stem": conv_lib.init_conv(seed, "stem", 3, 3, 64, bias=False, **kw),
        "stem_gn": conv_lib.init_groupnorm(seed, "stem_gn", 64, **kw),
        "fc": basic.init_dense(seed, "fc", 512, num_classes, bias=True, **kw),
    }
    c_in = 64
    for si, (c, _stride) in enumerate(_STAGES):
        for bi in range(2):
            path = f"stage{si}/block{bi}"
            blk = {
                "conv1": conv_lib.init_conv(seed, f"{path}/conv1", 3,
                                            c_in if bi == 0 else c, c,
                                            bias=False, **kw),
                "gn1": conv_lib.init_groupnorm(seed, f"{path}/gn1", c, **kw),
                "conv2": conv_lib.init_conv(seed, f"{path}/conv2", 3, c, c,
                                            bias=False, **kw),
                "gn2": conv_lib.init_groupnorm(seed, f"{path}/gn2", c, **kw),
            }
            if bi == 0 and c_in != c:
                blk["proj"] = conv_lib.init_conv(seed, f"{path}/proj", 1,
                                                 c_in, c, bias=False, **kw)
            p[f"stage{si}_block{bi}"] = blk
        c_in = c
    return p


def resnet18_forward(params, images):
    """images: (B, H, W, 3) NHWC -> logits. Stride-2 convolutions pad as
    XLA's "SAME" does (``conv.same_pads``)."""
    x = conv_lib.conv2d(images, params["stem"])
    x = torch.relu(conv_lib.apply_groupnorm(x, params["stem_gn"]))
    for si, (_c, stride) in enumerate(_STAGES):
        for bi in range(2):
            blk = params[f"stage{si}_block{bi}"]
            st = stride if bi == 0 else 1
            h = conv_lib.conv2d(x, blk["conv1"], stride=st)
            h = torch.relu(conv_lib.apply_groupnorm(h, blk["gn1"]))
            h = conv_lib.conv2d(h, blk["conv2"])
            h = conv_lib.apply_groupnorm(h, blk["gn2"])
            sc = x
            if "proj" in blk:
                sc = conv_lib.conv2d(x, blk["proj"], stride=st)
            elif st != 1:
                sc = x[:, ::st, ::st, :]
            x = torch.relu(h + sc)
    x = conv_lib.avgpool_global(x)
    return basic.dense(x, params["fc"])


def resnet18_freeze_spec(frozen_stages):
    """Paper Table 10: freeze the conv layers of residual stages, never the
    norms, the deepest (largest) stage first; downsample projections stay
    trainable."""
    return tuple(rf"^stage{s}_block\d/(conv1|conv2)/" for s in frozen_stages)


# Table 2 rows, largest-first freeze schedule (decreasing stage index).
RESNET_FREEZE_SCHEDULE = {
    26.25: (3,),
    8.07: (3, 2),
    3.47: (3, 2, 1),
    2.16: (3, 2, 1, 0),
}


# ---------------------------------------------------------------------------
# Stack Overflow NWP Transformer (3 layers, d=96, ff=2048, 8 heads x 12)

_SO_D, _SO_FF, _SO_HEADS, _SO_HEAD_DIM, _SO_LAYERS = 96, 2048, 8, 12, 3


def init_so_transformer(seed: int, vocab: int = 10004, seq: int = 20,
                        dtype=torch.float32, device=None) -> Dict[str, Any]:
    d, ff, h, hd = _SO_D, _SO_FF, _SO_HEADS, _SO_HEAD_DIM
    kw = dict(dtype=dtype, device=device)

    def norm(path):
        return basic.init_norm(seed, path, d, dtype, "layernorm", device)

    p: Dict[str, Any] = {
        "embed": basic.init_embedding(seed, "embed", vocab, d, dtype,
                                      device=device),
        "pos": basic.normal_init(seed, "pos", (seq, d), dtype, stddev=0.02,
                                 device=device),
    }
    for li in range(_SO_LAYERS):
        path = f"layer{li}"
        p[path] = {
            "ln1": norm(f"{path}/ln1"),
            "wq": basic.init_dense(seed, f"{path}/wq", d, h * hd, bias=True,
                                   **kw),
            "wk": basic.init_dense(seed, f"{path}/wk", d, h * hd, bias=True,
                                   **kw),
            "wv": basic.init_dense(seed, f"{path}/wv", d, h * hd, bias=True,
                                   **kw),
            "wo": basic.init_dense(seed, f"{path}/wo", h * hd, d, bias=True,
                                   **kw),
            "ln2": norm(f"{path}/ln2"),
            "ffn1": basic.init_dense(seed, f"{path}/ffn1", d, ff, bias=True,
                                     **kw),
            "ffn2": basic.init_dense(seed, f"{path}/ffn2", ff, d, bias=True,
                                     **kw),
        }
    p["final_ln"] = norm("final_ln")
    return p


def so_transformer_forward(params, tokens):
    """tokens: (B, S) integer -> logits (B, S, vocab), float32. Causal
    mask (masked scores set to -1e30), float32 softmax, tied input and
    output embeddings."""
    h, hd = _SO_HEADS, _SO_HEAD_DIM
    B, S = tokens.shape
    x = basic.embed(tokens, params["embed"], torch.float32)
    x = x + params["pos"][None, :S, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    li = 0
    while f"layer{li}" in params:
        lp = params[f"layer{li}"]
        hx = basic.apply_norm(x, lp["ln1"], "layernorm")
        q = basic.dense(hx, lp["wq"]).reshape(B, S, h, hd)
        k = basic.dense(hx, lp["wk"]).reshape(B, S, h, hd)
        v = basic.dense(hx, lp["wv"]).reshape(B, S, h, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(float(hd))
        s = torch.where(mask, s, -1e30)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, h * hd)
        x = x + basic.dense(o, lp["wo"])
        hx = basic.apply_norm(x, lp["ln2"], "layernorm")
        hx = torch.relu(basic.dense(hx, lp["ffn1"]))
        x = x + basic.dense(hx, lp["ffn2"])
        li += 1
    x = basic.apply_norm(x, params["final_ln"], "layernorm")
    return basic.unembed(x, params["embed"], torch.float32)


def so_freeze_spec(frozen_blocks):
    """Paper Table 11: freeze the first FFN dense of the given encoder blocks."""
    return tuple(rf"^layer{b}/ffn1/" for b in frozen_blocks)
