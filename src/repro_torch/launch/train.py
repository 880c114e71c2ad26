"""Training launcher, port of ``repro/launch/train.py``. Two modes, on
the card unless ``--device cpu``:

* paper tasks: federated training of the paper's own models on synthetic
  federated data —
    PYTHONPATH=src python -m repro_torch.launch.train --task emnist \\
        --rounds 100 [--fully-trainable] [--device cpu]
  ``--task`` is ``emnist`` (Table 1), ``cifar`` (ResNet-18-GN, Table 2)
  or ``stackoverflow`` (the NWP transformer, Table 3);
* assigned architectures: FedPT on the reduced variant of a ported
  architecture (``reduced_config``; ``--reduced`` is accepted, as the
  reference parses it, and every ``--arch`` run is reduced) —
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --rounds 10 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core import fedpt
from repro_torch.data import synthetic as syn
from repro_torch.fl import runtime
from repro_torch.models import decoder_lm as dlm
from repro_torch.models import paper_models as pm


def reduced_config(cfg, max_layers: int = 2, d_model: int = 256,
                   vocab: int = 512):
    """Smoke-scale variant of an assigned architecture (same family/wiring)."""
    slots, _ = dlm.layer_program(cfg)
    period = len(slots)
    layers = max(period, (max_layers + period - 1) // period * period)
    d = min(cfg.d_model, d_model)
    heads = min(cfg.num_heads, max(1, d // 64))
    kvh = max(1, min(cfg.num_kv_heads, heads))
    while heads % kvh:
        kvh -= 1
    return cfg.with_(
        num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=kvh,
        head_dim=d // heads if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        moe_d_ff=min(cfg.expert_d_ff, 2 * d) if cfg.num_experts else 0,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        vocab_size=min(cfg.vocab_size, vocab),
        kv_lora_rank=min(cfg.kv_lora_rank, 64),
        q_lora_rank=min(cfg.q_lora_rank, 96),
        qk_nope_head_dim=32 if cfg.use_mla else cfg.qk_nope_head_dim,
        qk_rope_head_dim=16 if cfg.use_mla else cfg.qk_rope_head_dim,
        v_head_dim=32 if cfg.use_mla else cfg.v_head_dim,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 16) or 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 8),
        compute_dtype="float32",
    )


def image_loss(forward_fn):
    """Mean cross-entropy of ``forward_fn(params, b["images"])`` against
    ``b["labels"]``."""
    def loss_fn(params, b):
        lp = torch.log_softmax(forward_fn(params, b["images"]), -1)
        return -lp.gather(1, b["labels"].long()[:, None]).mean(), {}
    return loss_fn


def token_loss(forward_fn):
    """Next-word cross-entropy of ``forward_fn(params, b["tokens"])``."""
    def loss_fn(params, b):
        logits = forward_fn(params, b["tokens"])
        return dlm.lm_loss(logits[:, :-1], b["tokens"][:, 1:]), {}
    return loss_fn


@dataclasses.dataclass
class PaperTask:
    """One of the paper's tasks, as ``run_paper_task`` trains it."""
    dataset: Any
    init_fn: Callable[[int], Any]
    loss_fn: Callable
    freeze_spec: tuple
    rc: fedpt.RoundConfig
    kind: str
    eval_fn: Callable


def paper_task(task: str, fully_trainable: bool = False, seed: int = 0,
               device=None, cifar_side: int = 24,
               so_vocab: int = 2004) -> PaperTask:
    """The reference's task settings, with its parameters built on
    ``device``. ``cifar_side`` (CIFAR-10's images are 32 x 32) and
    ``so_vocab`` (the model's vocab is 10,004) keep the reference's CPU
    cuts by default."""
    dev = resolve_device(device)
    if task == "emnist":
        ds = syn.make_federated_images(60, 60, (28, 28, 1), 62, seed=seed)
        init_fn = lambda s: pm.init_emnist_cnn(s, device=dev)  # noqa: E731
        fwd = pm.emnist_cnn_forward
        spec = () if fully_trainable else pm.EMNIST_FREEZE
        rc = fedpt.RoundConfig(20, 2, 16, "sgd", 0.05, "sgd", 0.5)
        kind = "images"
    elif task == "cifar":
        ds = syn.make_federated_images(50, 100, (cifar_side, cifar_side, 3),
                                       10, seed=seed)
        init_fn = lambda s: pm.init_resnet18(s, device=dev)  # noqa: E731
        fwd = pm.resnet18_forward
        spec = () if fully_trainable else pm.resnet18_freeze_spec((3,))
        rc = fedpt.RoundConfig(10, 2, 32, "sgdm", 10**-0.5, "sgdm", 0.1)
        kind = "images"
    elif task == "stackoverflow":
        ds = syn.make_federated_tokens(64, 64, vocab=so_vocab, seed=seed)
        init_fn = lambda s: pm.init_so_transformer(  # noqa: E731
            s, vocab=so_vocab, device=dev)
        fwd = pm.so_transformer_forward
        spec = () if fully_trainable else pm.so_freeze_spec((0, 1, 2))
        rc = fedpt.RoundConfig(32, 2, 16, "adam", 0.1, "sgd", 0.03)
        kind = "tokens"
    else:
        raise ValueError(task)
    if kind == "images":
        loss_fn = image_loss(fwd)
        ev = runtime.accuracy_eval(fwd, ds.test_images, ds.test_labels)
    else:
        loss_fn = token_loss(fwd)
        ev = runtime.nwp_accuracy_eval(fwd, ds.test_tokens)
    return PaperTask(ds, init_fn, loss_fn, spec, rc, kind, ev)


def run_paper_task(task: str, rounds: int, fully_trainable: bool,
                   seed: int = 0, log: bool = True, device=None):
    """Train one of the paper's tasks for ``rounds`` rounds through
    ``run_federated``, evaluating every quarter of the run; on the card
    unless ``device="cpu"``."""
    pt = paper_task(task, fully_trainable, seed, device)
    return runtime.run_federated(
        pt.init_fn, pt.loss_fn, pt.dataset, pt.rc, rounds,
        freeze_spec=pt.freeze_spec, seed=seed, data_kind=pt.kind,
        eval_every=max(1, rounds // 4), eval_fn=pt.eval_fn, log=log,
        device=device)


@dataclasses.dataclass
class ArchTask:
    """An architecture's FedPT task, as ``run_reduced_arch`` trains it."""
    cfg: Any
    dataset: Any
    init_fn: Callable[[int], Any]
    loss_fn: Callable
    rc: fedpt.RoundConfig


def arch_task(cfg, seed: int = 0, device=None) -> ArchTask:
    """The reference's ``run_reduced_arch`` settings for the config
    ``cfg`` (reduced or not), with its parameters built on ``device``: 16
    clients x 32 sentences of 32 tokens, 4 clients x 2 SGD steps (lr 0.1)
    x 4 a round, server SGD with momentum (lr 0.5), ``train_loss`` with
    the tokens as their own labels; the VLM gets zero ``prefix_embeds``
    (B, num_prefix_tokens, 1152), the encoder-decoder zero
    ``encoder_embeds`` (B, encoder_seq_len, d_model), float32, as the
    reference's stubs."""
    dev = resolve_device(device)
    ds = syn.make_federated_tokens(16, 32, seq_len=32, vocab=cfg.vocab_size,
                                   seed=seed)

    def loss_fn(params, b):
        toks = b["tokens"]
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.zeros(
                (toks.shape[0], cfg.num_prefix_tokens, dlm.VISION_TOWER_DIM),
                device=toks.device)
        if cfg.is_encoder_decoder:
            batch["encoder_embeds"] = torch.zeros(
                (toks.shape[0], cfg.encoder_seq_len, cfg.d_model),
                device=toks.device)
        return dlm.train_loss(params, cfg, batch)

    return ArchTask(cfg, ds, lambda s: dlm.init_model(cfg, s, device=dev),
                    loss_fn, fedpt.RoundConfig(4, 2, 4, "sgd", 0.1, "sgdm",
                                               0.5))


def run_reduced_arch(arch: str, rounds: int, seed: int = 0, log: bool = True,
                     device=None):
    """FedPT on ``reduced_config`` of ``arch`` (its freeze spec) for
    ``rounds`` rounds through ``run_federated``, on the card unless
    ``device="cpu"``. Returns (TrainResult, cfg)."""
    at = arch_task(reduced_config(get_config(arch)), seed, device)
    return runtime.run_federated(at.init_fn, at.loss_fn, at.dataset, at.rc,
                                 rounds, freeze_spec=at.cfg.freeze_spec,
                                 seed=seed, data_kind="tokens", log=log,
                                 device=device), at.cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["emnist", "cifar", "stackoverflow"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--fully-trainable", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.task:
        res = run_paper_task(args.task, args.rounds, args.fully_trainable,
                             args.seed, device=args.device)
    else:
        res, cfg = run_reduced_arch(args.arch, args.rounds, args.seed,
                                    device=args.device)
        print(f"arch={cfg.name} trainable share: "
              f"{100 * res.comm.trainable_bytes / res.comm.full_bytes:.2f}%")
    print(f"final loss={res.history[-1]['loss']:.4f} "
          f"comm reduction={res.comm.reduction:.1f}x "
          f"sec/round={res.seconds_per_round:.2f}")


if __name__ == "__main__":
    main()
