"""Serving shapes and step functions, port of the serving part of
``repro/launch/specs.py``.

The FROZEN tree is held in bf16 (read-only weights) and the TRAINABLE
tree in f32 (the master copy): the standard mixed-precision split of the
reference's ``param_structs``. The prefill and decode steps take the two
halves and merge them.

Shapes (the reference's):
  train_4k     seq 4,096   global_batch 256   -> fedpt_round_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token)
  long_500k    seq 524,288 global_batch 1     -> serve_step (1 token)
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, match_freeze
from repro_torch.core import partition as part
from repro_torch.models import decoder_lm as dlm
from repro_torch.nn import basic

SHAPES = {
    "train_4k": dict(seq=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq=524288, global_batch=1, kind="decode"),
}

# the sliding window applied to mistral-nemo for long_500k only (the
# reference's serving variant: a rolling-buffer SWA cache)
NEMO_SERVE_WINDOW = 8192


def serving_config(cfg: ModelConfig, shape: str) -> ModelConfig:
    if shape == "long_500k" and cfg.name == "mistral-nemo-12b":
        return cfg.with_(sliding_window=NEMO_SERVE_WINDOW)
    return cfg


def serving_split(params, cfg: ModelConfig):
    """(trainable f32, frozen bf16) halves of a parameter tree, split by
    the config's freeze spec.

    ``params`` is consumed: each frozen leaf is taken out of it as its
    bf16 copy is made, so that the float32 leaf is freed at once (when
    the caller holds it nowhere else) rather than after the whole frozen
    half is copied. Eight layers of Jamba-v0.1 at full width would
    otherwise hold 47.2 GiB of frozen float32 beside its 23.6 GiB bf16
    copy. The trainable leaves stay in ``params``."""
    y, z = {}, {}
    for path in [p for p, _ in basic.flatten_params(params)]:
        *dirs, name = path.split("/")
        parent = params
        for d in dirs:
            parent = parent[d]
        if match_freeze(path, cfg.freeze_spec):
            z[path] = parent.pop(name).to(torch.bfloat16)
        else:
            y[path] = parent[name].float()
    return basic.unflatten_params(y), basic.unflatten_params(z)


def param_structs(cfg: ModelConfig, seed: int = 0):
    """The serving split's shapes and dtypes, as tensors on the meta
    device (no memory): (trainable f32, frozen bf16)."""
    return serving_split(dlm.init_model(cfg, seed, device="meta"), cfg)


def _on(device, *trees) -> None:
    for tree in trees:
        for path, leaf in basic.flatten_params(tree):
            if leaf.device != device:
                raise ValueError(f"parameter {path} is on {leaf.device}, the "
                                 f"step runs on {device}")


def make_prefill_step(cfg: ModelConfig, device=None):
    """prefill_step(y, frozen, batch) -> logits (B, S, V), on the card
    unless ``device="cpu"``; ``batch["tokens"]`` (B, S) may be any
    integer array. The VLM also takes ``batch["prefix_embeds"]`` (B, P,
    1152) (the logits then cover P + S positions), the encoder-decoder
    ``batch["encoder_embeds"]`` (B, E, d_model)."""
    dev = resolve_device(device)

    def prefill_step(y, frozen, batch):
        _on(dev, y, frozen)
        params = part.merge(y, frozen)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        kw = {}
        if cfg.family == "vlm":
            kw["prefix_embeds"] = torch.as_tensor(batch["prefix_embeds"],
                                                  device=dev)
        if cfg.is_encoder_decoder:
            kw["encoder_embeds"] = torch.as_tensor(batch["encoder_embeds"],
                                                   device=dev)
        logits, _ = dlm.forward(params, cfg, tokens, **kw)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None):
    """serve_step(y, frozen, cache, tokens) -> (logits (B, 1, V), cache),
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)

    def serve_step(y, frozen, cache, tokens):
        _on(dev, y, frozen)
        params = part.merge(y, frozen)
        return dlm.decode_step(params, cfg, cache,
                               torch.as_tensor(tokens, device=dev))

    return serve_step
