"""Input specifications and step builders for every (architecture x
input-shape) pair, port of ``repro/launch/specs.py``: the substrate of
the dry run (``launch/dryrun.py``) and of the serving entry point.

The FROZEN tree is held in bf16 (read-only weights) and the TRAINABLE
tree in f32 (the master copy): the standard mixed-precision split of the
reference's ``param_structs``. Structures are tensors on the meta device
(no memory). The prefill and decode steps take the two halves and merge
them; the train step is one FedPT round on a mesh (:func:`make_train_step`).
On a mesh the train step and the prefill of dense attention with dense
or MoE FFNs are tensor-parallel on "model" (:func:`make_train_step`,
:func:`make_tp_prefill_step`): each rank computes on its pieces of the
parameters and never gathers the frozen tree.

Shapes (the reference's):
  train_4k     seq 4,096   global_batch 256   -> fedpt_round_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token)
  long_500k    seq 524,288 global_batch 1     -> serve_step (1 token)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config, match_freeze
from repro_torch.core import fedpt
from repro_torch.core import partition as part
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.models import decoder_lm as dlm
from repro_torch.nn import basic

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32

SHAPES = {
    "train_4k": dict(seq=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq=524288, global_batch=1, kind="decode"),
}

# long_500k needs sub-quadratic attention: sliding-window, SSM and hybrid
# architectures (and mistral-nemo through its serving window) take it;
# pure full-attention architectures skip it, as in the reference
LONG_OK = {"mixtral-8x7b", "jamba-v0.1-52b", "xlstm-350m", "mistral-nemo-12b"}
# the sliding window applied to mistral-nemo for long_500k only (the
# reference's serving variant: a rolling-buffer SWA cache)
NEMO_SERVE_WINDOW = 8192
VISION_TOWER_DIM = 1152


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return "pure full-attention arch: 500k decode excluded by design"
    return None


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


# ---------------------------------------------------------------------------
# Input specs per shape kind (tensors on the meta device)


def _sds(shape, dtype):
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def train_specs(cfg: ModelConfig, mesh, seq: int, global_batch: int,
                tau: int = 2):
    """(batch_struct, weights_struct, clients) for one federated round:
    one client a data rank, ``global_batch`` sequences split over the
    clients and their ``tau`` local steps."""
    clients = 1
    for a in mesh_lib.data_axes(mesh):
        clients *= mesh_lib.axis_size(mesh, a)
    b = global_batch // (clients * tau)
    assert b >= 1, (cfg.name, global_batch, clients, tau)
    tok_seq = seq - cfg.num_prefix_tokens if cfg.family == "vlm" else seq
    batch = {
        "tokens": _sds((clients, tau, b, tok_seq), I32),
        "labels": _sds((clients, tau, b, tok_seq), I32),
    }
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _sds(
            (clients, tau, b, cfg.num_prefix_tokens, VISION_TOWER_DIM), BF16)
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = _sds(
            (clients, tau, b, cfg.encoder_seq_len, cfg.d_model), BF16)
    weights = _sds((clients,), F32)
    return batch, weights, clients


def prefill_specs(cfg: ModelConfig, seq: int, global_batch: int):
    tok_seq = seq - cfg.num_prefix_tokens if cfg.family == "vlm" else seq
    batch = {"tokens": _sds((global_batch, tok_seq), I32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _sds(
            (global_batch, cfg.num_prefix_tokens, VISION_TOWER_DIM), BF16)
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = _sds(
            (global_batch, cfg.encoder_seq_len, cfg.d_model), BF16)
    return batch


def decode_specs(cfg: ModelConfig, seq: int, global_batch: int):
    cache = dlm.init_cache(cfg, global_batch, seq, dtype=BF16, device="meta")
    tokens = _sds((global_batch, 1), I32)
    return cache, tokens


# ---------------------------------------------------------------------------
# The train step on a mesh


def make_train_step(cfg: ModelConfig, mesh, y_struct, device=None):
    """FedPT round step for this architecture (client sgd, server sgdm),
    on ``mesh``: train_step(y, sstate, frozen, batch, weights, seed) ->
    (y_new, sstate_new, metrics).

    ``y``, the server state and ``frozen`` may arrive as DTensors placed
    by :func:`sharding.param_shardings` (the reference's layout) or whole.
    Where ``sharding.tensor_parallel_ok`` holds (dense attention and
    dense or MoE FFNs), the step is tensor-parallel on "model": each rank
    trains its data rank's clients on its pieces of ``y`` and of the
    frozen tree, which is never made whole (``nn/attention.tp_attention``,
    ``nn/basic.mlp`` / ``embed`` / ``unembed``, ``nn/moe``, the
    vocab-parallel loss); each client's delta is gathered over "model"
    into the flat plane's rows (``sharding.ModelShards``), and the server
    steps on its pieces, returned as DTensors of that layout. The other
    families keep the gathered layout: ``y`` gathered whole for the
    clients, whose copies ``torch.func.vmap`` never materializes, the
    server state and the frozen tree gathered on entry, and the new ``y``
    laid out again (``constrain_fn``). Either way the batch and weights
    are gathered on entry, each data rank trains its clients, and the
    flat plane (``sharding.flat_constrainer``) aggregates each rank's
    block of the delta buffer. Each client's tokens form their own MoE
    call, in the reference's round as here, so no data split is set. The
    round has no DP noise, so ``seed`` draws nothing. Runs on ``device``
    (CUDA unless ``device="cpu"``)."""
    rc = fedpt.RoundConfig(clients_per_round=0, local_steps=2, local_batch=0,
                           client_opt="sgd", client_lr=0.02,
                           server_opt="sgdm", server_lr=0.5)
    shard_y = shard_lib.param_shardings(y_struct, cfg, mesh)
    plane = shard_lib.flat_constrainer(mesh)
    if shard_lib.tensor_parallel_ok(cfg, mesh):
        return _tp_train_step(cfg, mesh, y_struct, shard_y, rc, plane,
                              device)

    def constrain(tree, clients: bool):
        if clients:
            return shard_lib.gathered(tree)
        return basic.tree_map(
            lambda x, pl: shard_lib.distribute(x, mesh, pl), tree, shard_y)

    def loss_fn(params, mb):
        return dlm.train_loss(params, cfg, mb)

    round_step, server_opt = fedpt.make_round_fn(
        loss_fn, rc, device=device, constrain_fn=constrain,
        constrain_flat_fn=plane)

    def train_step(y, sstate, frozen, batch, weights, seed=None):
        y_new, ss_new, metrics = round_step(
            y, shard_lib.gathered(sstate), shard_lib.gathered(frozen),
            shard_lib.gathered(batch), shard_lib.gathered(weights), None)
        return y_new, _laid_out_as(ss_new, sstate), metrics

    return train_step, server_opt


def _tp_train_step(cfg, mesh, y_struct, shard_y, rc, plane, device):
    """:func:`make_train_step`'s tensor-parallel step."""
    shards = shard_lib.ModelShards(mesh, y_struct, shard_y)
    tp = mesh_lib.model_parallel(mesh)

    def loss_fn(params, mb):
        with mesh_lib.tensor_parallel(tp):
            return dlm.train_loss(params, cfg, mb)

    round_step, server_opt = fedpt.make_round_fn(
        loss_fn, rc, device=device, constrain_flat_fn=plane,
        model_shards=shards)

    def train_step(y, sstate, frozen, batch, weights, seed=None):
        shard_z = shard_lib.param_shardings(frozen, cfg, mesh)
        y_new, ss_new, metrics = round_step(
            shards.local(y), shards.local(sstate),
            shard_lib.local_pieces(frozen, shard_z, mesh),
            shard_lib.gathered(batch), shard_lib.gathered(weights), None)
        return shards.dtensors(y_new), shards.dtensors(ss_new), metrics

    return train_step, server_opt


def _laid_out_as(tree, like):
    """Each leaf of ``tree`` as a DTensor placed as its twin in ``like``
    is, or as it is where the twin is no DTensor."""
    from torch.distributed.tensor import DTensor

    def one(x, ref):
        if isinstance(ref, DTensor):
            return shard_lib.distribute(x, ref.device_mesh, ref.placements)
        return x
    return basic.tree_map(one, tree, like)


def _data_local(tree):
    """Each DTensor leaf redistributed so that only its data-axis shards
    stay (the "model" axis gathered) and taken as its local tensor: a data
    rank's rows, whole in every other dim."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(x):
        if not isinstance(x, DTensor):
            return x
        names = mesh_lib.axis_names(x.device_mesh)
        pl = tuple(p if n in ("pod", "data") else Replicate()
                   for n, p in zip(names, x.placements))
        return x.redistribute(x.device_mesh, pl).to_local()
    return basic.tree_map(one, tree)


# ---------------------------------------------------------------------------
# Assembled lowering spec per (arch, shape, mesh)


# the layouts a job's step runs in (``LoweringJob.layout``, the dry run's
# ``layout`` key)
TP_LAYOUT = ("tensor-parallel on 'model' by the reference's rules: each "
             "rank computes on its pieces of y and the frozen tree, which "
             "is never gathered")
GATHERED_LAYOUT = ("data-parallel, parameters gathered whole on every rank "
                   "(not the reference's sharded layout: per-rank bytes and "
                   "collectives are not comparable to its dry run)")


@dataclasses.dataclass
class LoweringJob:
    arch: str
    shape: str
    fn: Callable
    args: tuple                 # tensors on the meta device
    in_shardings: tuple         # trees of placements, as args
    cfg: ModelConfig
    clients: int = 0
    layout: str = GATHERED_LAYOUT


def make_tp_prefill_step(cfg: ModelConfig, mesh, device=None):
    """The tensor-parallel prefill on ``mesh`` (``sharding.tensor_parallel_ok``
    configs): prefill(y, frozen, batch) -> logits as a DTensor of (B, S,
    V), its vocab split on "model" where the unembedding's is, its rows
    on the data axes where the batch's are. Each rank runs
    :func:`make_prefill_step`'s forward on its pieces of ``y`` and the
    frozen tree (DTensors or whole) and its data rank's rows: attention
    on its heads through ``flash_attention`` (the ``swa_attention`` kernel
    on the card), the FFN or experts on its pieces; no parameter is
    gathered. An MoE's capacity and slot ranks are counted over the
    global batch, as the reference's forward counts them
    (``sharding.batch_split``). A caller that wants whole logits asks the
    DTensor (``full_tensor()``)."""
    step = make_prefill_step(cfg, device)
    tp = mesh_lib.model_parallel(mesh)
    names = mesh_lib.axis_names(mesh)

    def prefill(y, frozen, batch):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        yl = shard_lib.local_pieces(
            y, shard_lib.param_shardings(y, cfg, mesh), mesh)
        zl = shard_lib.local_pieces(
            frozen, shard_lib.param_shardings(frozen, cfg, mesh), mesh)
        tokens = batch["tokens"]
        with mesh_lib.tensor_parallel(tp), mesh_lib.data_split(
                shard_lib.batch_split(mesh, tokens)):
            logits = step(yl, zl, _data_local(batch))
        rows = (tokens.placements if isinstance(tokens, DTensor)
                else (Replicate(),) * len(names))
        vocab = (Shard(2) if logits.shape[-1] != cfg.vocab_size
                 else Replicate())
        pl = tuple(vocab if n == "model" else rows[i]
                   for i, n in enumerate(names))
        shape = (tokens.shape[0], logits.shape[1], cfg.vocab_size)
        return shard_lib.from_local(logits, mesh, pl, shape)

    return prefill


def make_mesh_decode_step(cfg: ModelConfig, mesh, device=None):
    """The data-parallel decode on ``mesh``: serve_step(y, frozen, cache,
    tokens) -> (this data rank's logits (B_local, 1, V), its cache), the
    parameters gathered whole, the cache's "model" shards gathered for
    its rows; an MoE's capacity and slot ranks counted over the global
    batch's ``B`` rows (``sharding.batch_split``)."""
    step = make_decode_step(cfg, device)

    def decode(y, frozen, cache, tokens):
        with mesh_lib.data_split(shard_lib.batch_split(mesh, tokens)):
            return step(shard_lib.gathered(y), shard_lib.gathered(frozen),
                        _data_local(cache), _data_local(tokens))

    return decode


def build_job(arch: str, shape: str, mesh, cfg_override=None,
              device="cpu") -> LoweringJob:
    """The step of ``shape``'s kind for ``arch`` on ``mesh``, its argument
    structures and their placements. Where ``sharding.tensor_parallel_ok``
    holds, the train step and the prefill are tensor-parallel
    (:func:`make_train_step`, :func:`make_tp_prefill_step`; ``layout``
    :data:`TP_LAYOUT`); otherwise, and for decode, the steps run
    data-parallel: their parameters gathered whole, the batch (and the
    cache, its "model" shards gathered) a data rank's rows."""
    base_cfg = cfg_override if cfg_override is not None else get_config(arch)
    info = SHAPES[shape]
    cfg = serving_config(base_cfg, shape)
    y_struct, z_struct = param_structs(cfg)
    shard_y = shard_lib.param_shardings(y_struct, cfg, mesh)
    shard_z = shard_lib.param_shardings(z_struct, cfg, mesh)
    rep = shard_lib.placements_of((), mesh)
    tp = shard_lib.tensor_parallel_ok(cfg, mesh)
    layout = TP_LAYOUT if tp and info["kind"] != "decode" \
        else GATHERED_LAYOUT

    if info["kind"] == "train":
        batch, weights, clients = train_specs(cfg, mesh, info["seq"],
                                              info["global_batch"])
        train_step, server_opt = make_train_step(cfg, mesh, y_struct, device)
        sstate_struct = server_opt.init(y_struct)
        # sgdm state mirrors y's structure -> the same placements
        shard_sstate = shard_lib.param_shardings(sstate_struct, cfg, mesh)
        args = (y_struct, sstate_struct, z_struct, batch, weights,
                _sds((1,), I32))
        inshard = (shard_y, shard_sstate, shard_z,
                   shard_lib.batch_sharding(batch, mesh),
                   shard_lib.batch_sharding(weights, mesh), rep)
        return LoweringJob(arch, shape, train_step, args, inshard, cfg,
                           clients, layout)

    if info["kind"] == "prefill":
        batch = prefill_specs(cfg, info["seq"], info["global_batch"])
        if tp:
            prefill = make_tp_prefill_step(cfg, mesh, device)
        else:
            step = make_prefill_step(cfg, device)

            def prefill(y, frozen, batch):
                # an MoE's capacity and slot ranks over the global batch
                with mesh_lib.data_split(
                        shard_lib.batch_split(mesh, batch["tokens"])):
                    return step(shard_lib.gathered(y),
                                shard_lib.gathered(frozen),
                                _data_local(batch))
        args = (y_struct, z_struct, batch)
        inshard = (shard_y, shard_z, shard_lib.batch_sharding(batch, mesh))
        return LoweringJob(arch, shape, prefill, args, inshard, cfg,
                           layout=layout)

    cache, tokens = decode_specs(cfg, info["seq"], info["global_batch"])
    decode = make_mesh_decode_step(cfg, mesh, device)
    long_ctx = shape == "long_500k"
    shard_cache = shard_lib.cache_shardings(cache, cfg, mesh, long_ctx)
    tok_shard = (shard_lib.batch_sharding(tokens, mesh)
                 if not long_ctx else rep)
    args = (y_struct, z_struct, cache, tokens)
    inshard = (shard_y, shard_z, shard_cache, tok_shard)
    return LoweringJob(arch, shape, decode, args, inshard, cfg)
