#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on the GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times SRC   # another tree's redesigned kernels
    python3 chip_smoke.py --sweep   # sumsq, Q->DQ, clip, max-abs launch shapes
    python3 chip_smoke.py --dp-ftrl SRC     # DP-FTRL's rounds on another tree
    python3 chip_smoke.py --mixtral   # phase 7 alone (Mixtral-8x7B)
    python3 chip_smoke.py --deepseek  # phase 8 alone (DeepSeek-V2, MLA)
    python3 chip_smoke.py --ssm       # phase 9 alone (xLSTM-350M, Jamba-v0.1)
    python3 chip_smoke.py --vlm-encdec  # phase 10 alone (PaliGemma, Whisper)
    python3 chip_smoke.py --mesh      # phase 11 alone (the mesh)
    python3 chip_smoke.py --examples  # phase 12 alone (examples_torch/)
    python3 chip_smoke.py --profiler-probe  # launches a profiler records

Needs one CUDA card and ``nvcc``; imports nothing of JAX nor of the JAX
package. Phases, in order, each failing the run on error:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and identify the card;
2. hold every kernel against its plain torch version on the card at the
   main paths' shapes, plus the edge cases (an all-zero leaf, a NaN, an
   Inf, exact .5 ties), then time each kernel, its plain version and,
   where one exists, the one PyTorch call that computes the same
   function:
   - sumsq, max-abs and Q->DQ at the quickstart's (10, 89,088) delta
     buffer with its 8-leaf block map, plus a ragged layout: max-abs and
     Q->DQ bit for bit (Q->DQ on its one-launch cluster route), sumsq
     within rtol 1e-5 of a float64 sum (also at 1,695,744); Q->DQ on its
     two-pass route at the FedAvg row (1,656 blocks) and at both sides of
     the route boundary (256 / 257 blocks), max-abs bit for bit at the
     FedAvg width (10 and 6 rows), each call's route or launch asserted;
     max-abs'
     record carries its whole call's device time and, at the FedAvg width,
     its warm and L2-cold times against their bounds (``call_times``);
     ``--kernel-times SRC`` times the package under SRC (``src`` for
     this tree, or another tree unpacked by ``git archive``) and nothing
     else: sumsq at 89,088 and 1,695,744 and Q->DQ at (10, 89,088) and
     (6, 89,088) by ``ab_times`` (wrapper, named kernels' and whole
     call's device time, ``torch.dot``'s wall and device time), max-abs
     and the two-pass Q->DQ at the FedAvg width warm and L2-cold, with the
     blocking host-to-device copies of ``core/flat.fake_quantize`` and of
     a quickstart round at int8 (not in the default run);
   - the fused tail's stats, pack and apply at the FedAvg baseline's
     (10, 1,695,744) buffer with its 10-leaf map: block max-abs, block
     sum of squares, codes (finite rows) and the apply bit for bit, the
     quantized row sums within 2 * blocks * 2**-24 relative (two orders of
     the same float32 sum);
   - the DP clip: ``clip_flat`` over the async lane's (6, 89,088) rows and
     over (6, 1,695,744), ``clip_accumulate`` at N = 89,088 and 1,695,744,
     with a zero row, a row under the clip (bit for bit), a NaN row, an
     Inf row and ragged N; the row norms within ``dp_clip.norm_rtol``
     (their a-priori bound), the clip-and-accumulate within rtol 1e-6 of
     its plain version (one torch.sum); each clip_flat call's route
     asserted: one launch on the cluster route at (6, 89,088) and with a
     ragged last block, there bit for bit the three-launch entry's values
     and norms, and the three-launch route at (6, 1,695,744) and n + 77;
     ``--kernel-times``' ``ab_times`` also times clip_flat and
     seed_reconstruct (float32 and bf16) and prints digests of their
     outputs, so that two trees show whether they give the same bits;
   - ``swa_attention`` at (1, 32, 4096, 128) bf16 with 8 kv heads (GQA rep
     4), windows 0 and 1,000, at a ragged S = 4,000, and at the
     prefill's (1, 32, 32768, 128) in its layout under windows 0 and
     8192, within 2**-8 relative + 1e-5 of its plain version (one bf16
     rounding), the same bits twice; its round-once mode (``round_p``,
     what the serving path's ``flash_attention`` launches) at the
     prefill's shape under both windows within bound (i)
     (``swa_attention.round_p_tolerance``) of its plain version
     ``ref.chunked_attention_ref(..., chunk=64)``, closer to it than the
     float32-p mode, the same bits twice (each plain version at the
     prefill's shape run once); the round-once mode timed at the
     prefill's shape causal beside ``scaled_dot_product_attention``, with
     its ptxas registers and spills; ``--kernel-times`` also times the
     float32-p mode and window 8192, with SASS wgmma and TMA load counts,
     TFLOP/s, the launches the profiler records, and the card's clock and
     power under sustained load (``attention_times``); with a logit
     softcap or an offset q ``flash_attention`` runs the plain
     ``chunked_attention`` on the card, held to the CPU path;
     ``seed_reconstruct`` at NeMo's frozen FFN leaf (5120, 14336) and a
     ragged (300, 200): hash words bit for bit, Gaussians within 8 ulps in
     float32 and one bf16 ulp in bf16, one launch a call; timed in both
     types, with the kernel's static SASS instruction counts;
3. drive the main paths: synchronous FedPT rounds on the full-width
   EMNIST CNN (init from seed 0 through the threefry port), 10 rounds of
   10 clients x 2 local SGD steps x batch 16, each followed by one
   profiled round (device-busy share, host ops by self time):
   - the quickstart (``EMNIST_FREEZE``) at ``uplink_bits`` 0 and 8, on
     the staged tail;
   - the FedAvg baseline (every parameter trainable) at ``uplink_bits=8``:
     variant A on the fused tail's exact route, and variant B, DP-FedAvg
     (clip 0.5, noise multiplier 0.4) with the quarantine screen, on its
     coefficient route, plus one round with a poisoned (NaN) client that
     must be quarantined;
   each path's losses are finite (and fall, but for B, whose noise at 10
   clients promises no fall), its first round agrees with the same round
   on the CPU through the plain versions, and every kernel of the path
   was launched (Q->DQ on its cluster route alone where the path
   quantizes; the profiled round counts its blocking copies); then
   - ``fl.runtime.run_federated``, the quickstart at ``uplink_bits=0``
     through the simulation grid, whose history must equal a plain
     ``make_round_fn`` loop fed the grid's streams bit for bit (cuDNN set
     deterministic for both) and whose measured bytes equal the
     transfers times the payloads;
   - the async grid, FedBuff over the pareto-mobile fleet (concurrency
     12, goal 6, polynomial staleness) at ``uplink_bits=8`` with
     per-flush DP (clip 0.5, noise multiplier 0.4), 12 server updates;
     its first 3 updates again on the card and on the CPU, whose virtual
     clock, staleness, scheduler stats, wire bytes and DP summary must be
     equal, losses within rel 1e-4 and y within a derived bound; the
     lane's Q->DQ and clip on their cluster routes alone; then the lane
     step and the buffered apply timed, one flush profiled;
   then time the staged and the fused tail against each other at both
   buffer sizes; then
   - the serving path: Mistral-NeMo-12B at full width (d_model 5120, 32
     heads, 8 kv heads, head_dim 128, d_ff 14336, vocab 131072), 4 of its
     40 layers, from ``init_model(cfg, 0)`` on the card, split by its
     freeze spec into trainable f32 and frozen bf16; ``make_prefill_step``
     on 1 x 32,768 tokens under ``serving_config`` of prefill_32k (full
     causal) and long_500k (window 8192), median of 3 and a profiled
     split into attention kernel / matmuls / rest, logits finite, the
     windowed attention's kernel time below 0.8x the causal one's; greedy
     ``generate`` (batch 4, prompt 8, 32 steps) under long_500k; then, on
     the card with the same weights, a 1 x 512 prefill through the kernel
     against the plain chunked attention at the reference's chunk of 512
     (windows 0 and 200), and
     ``generate``'s step-by-step prefill against ``forward`` at the prompt
     positions, each within 2**-4 of the largest |logit|;
   ``generate`` also samples 32 steps at temperature 1 from the bf16
   logits, and ``threefry.categorical`` on the card must pick the CPU
   port's tokens on fixed float32 and bf16 logits, but in rows whose top
   two perturbed logits lie within the Gumbel bound (their count
   printed);
4. drive the paper's other two models at full width, float32, TF32 off
   (``launch/train.paper_task``), 10 rounds each, with the launch counts
   set to 0 just before and read just after, the server tail's routes
   (staged), the accuracy at the end, the peak device memory around one
   client update and one profiled round; each path's first round
   against the CPU's (the update by norm, ``check_model_round``; ResNet's
   at 3 of the cohort's 10 clients, RESNET_CHECK_CLIENTS), each path's
   own first ``sumsq`` launch (the cohort's update at the flat width)
   against the plain version and a float64 sum (``check_path_sumsq``),
   the trainable counts and flat layouts asserted:
   - ResNet-18-GN on CIFAR-10-shaped data (50 clients x 100 images of
     32 x 32, 10 classes), 10 clients x 2 sgdm steps x batch 32, PT
     (stage 3 frozen, 26.09%) and FedAvg;
   - the SO NWP transformer at vocab 10,004 (64 clients x 64 sentences of
     20 tokens), 32 clients x 2 Adam steps x 16, PT (73.65%) and FedAvg,
     NWP accuracy on the 512 test sentences;
   - the async DP grid of path 6 on the SO PT model: its lane rows of
     1,653 blocks take the two-pass Q->DQ through ``leaf_maxabs`` and
     the three-launch clip, no cluster route;
   - ``examples/dp_federated_lm.py`` at vocab 10,004: the SO PT model
     with the DP-FTRL server (``tree_noise``), 5 rounds, then through
     ``run_federated``; its profiled round counts the blocking copies;
5. drive trainability tiers (``core/plan.py``) on the full-width EMNIST
   CNN with ``examples/async_heterogeneous.py``'s three-tier plan (full,
   mid freezing conv2, lite freezing conv1 as well), each path with the
   launch counts set to 0 just before and read just after, a wall median,
   one profiled round or flush (busy share, launches, blocking copies);
   phase 2 holds the cluster Q->DQ (bit for bit) and the cluster clip
   (norms within ``dp_clip.norm_rtol``) at the mid and lite lanes'
   (6, 36,864) and (6, 34,816) over their own block maps:
   - ``--tiers``: the async path's fleet at int8 with capability-assigned
     tiers, 12 updates, beside the same fleet all-full, whose uplink must
     bill more bytes; per-tier ``tier_stats``; the uplink kernels' launches
     by row width; its first 3 updates on the card and on the CPU with
     clock, staleness, bytes and tier census equal, y by norm;
   - the same with per-flush DP (clip 0.5, z 0.4): the clip on each
     tier's lane, y as the async DP path holds it;
   - sync FedAvg (every parameter trainable) at int8 with an explicit tier
     map over the 40 clients: round 0 card vs CPU, 10 rounds on the fused
     exact route with the per-block denominator, one DP-FedAvg round on
     the coefficient route, and a lite-only cohort whose conv1 / conv2
     leaves must come back bit for bit;
   - ``examples/adaptive_tiers.py``: the adaptive-capability policy on
     pareto-mobile-diurnal, 16 updates, re-tiered every 4, the census
     before and after;
6. drive checkpoint / resume and the edge topology on the full-width
   EMNIST CNN under ``torch.backends.cudnn.deterministic = True``, with
   snapshots in a temporary directory:
   - async kill -> resume: the async DP path (12 updates) with
     ``tests/test_resume.py``'s chaos faults, the screen and jittered
     links, snapshots every 2, killed between updates 6 and 7 and resumed
     from the kill's snapshot: history, y, stats, bytes and DP summary
     bit for bit the straight run (run twice, also bit for bit), the
     resumed segment on the cluster Q->DQ and clip; snapshot bytes, the
     encode / save / load / decode times, the update wall with snapshots
     on and off;
   - sync kill -> resume: the quickstart at ``uplink_bits=8`` with
     crashes (0.1), 10 rounds, killed between rounds 5 and 6, bit for
     bit;
   - the topology: one region and 4 regions bit for bit the flat grid
     (the client->edge hop equal to the flat ledger), their update walls,
     the blocking copies a flush with telemetry off and on; 4 shocked
     regions (a region down 1.2 virtual seconds every 0.8, crashes 0.1):
     shocks fired, the first 3 updates card vs CPU with the hop ledger,
     edge counters and shocks equal, and a kill -> resume bit for bit;
   - ``TelemetryConfig(profile=True)`` inside ``torch.profiler``: a
     ``grid/server_apply`` range a flush of the trace and a
     ``grid/lane_step[None]`` range a lane step; the update wall with
     the ranges on and off (medians of 10 runs);
7. FedPT fine-tuning of Mixtral-8x7B at full width (d_model 4,096, 32
   heads, 8 kv heads, head_dim 128, 8 experts top-2, expert FFN 14,336,
   vocab 32,000, window 4,096; only depth is cut), each path with the
   launch counts set to 0 just before and read just after:
   - training, 2 of 32 layers, the config's dtypes (float32 parameters,
     bf16 compute), its freeze spec (the routed experts frozen):
     ``launch/train.arch_task``'s data and round configuration through
     ``runtime.run_federated``, 8 rounds (``examples/
     federated_llm_finetune.py``), the loss falling; 346,116,096 of
     3,164,688,384 parameters trainable; ``sumsq`` once a round at that
     width and within ``dp_clip.sumsq_rtol`` of a float64 sum, timed
     there; the round walls, the peak memory of one client update, one
     profiled round; ``moe_ffn`` at full width within rtol 2e-4 / atol
     2e-5 of ``moe_ffn_dense_fallback`` (float32, capacity factor 8.0);
     one round of the reduced config card vs CPU (``check_model_round``);
   - serving, 4 of 32 layers on the serving split (5,637,144,576 frozen
     bf16 expert weights): ``make_prefill_step`` on 1 x 32,768 tokens at
     Mixtral's own window (median of 3, tokens/s, ``swa_attention`` once
     a layer, a profiled split into the attention kernel, the expert
     matmuls, routing / dispatch / combine and the rest), greedy
     ``generate`` (batch 4, prompt 8, 32 steps); then a 1 x 512 prefill
     through the kernel against the plain chunked attention (windows
     4,096 and 200) and the step-by-step prefill against ``forward`` at
     capacity factor 8.0, within 2**-4 of the largest |logit|, the second
     side of each routed as the first (``routing_spy``: bf16 router
     near-ties flip between two computations), the flips counted;
   phase 2 also holds the round-once ``swa_attention`` at window 4,096 at
   the prefill's shape within bound (i) and times it; the init's own
   peak memory is printed (threefry draws in pieces);
8. DeepSeek-V2 at full width (d_model 5,120, 128 heads of MLA: kv_lora
   512, q_lora 1,536, q / k heads of 128 + 64 rope, v heads of 128; 160
   experts top-6 of 1,536 plus 2 shared; vocab 102,400; only depth is
   cut), each path with the launch counts set to 0 just before and read
   just after:
   - training, 1 of 60 layers, float32 parameters, bf16 compute, the
     routed experts frozen, ``arch_task``'s data and round through
     ``runtime.run_federated``, 8 rounds, the loss falling;
     1,245,824,000 of 5,020,697,600 parameters trainable (flat size
     1,245,825,024); ``sumsq`` once a round there and within
     ``dp_clip.sumsq_rtol`` of a float64 sum, timed; the init's and a
     client update's peak memory, the round walls, one profiled round;
     one round of the reduced config (MLA 48 / 32) card vs CPU, loss
     within 1e-5 relative and the update within 1e-3 by norm;
   - serving, 2 of 60 layers on the serving split (7,549,747,200 frozen
     bf16 expert weights): ``make_prefill_step`` on 1 x 32,768 tokens
     (median of 3, tokens/s, ``swa_attention`` once a layer at q / k
     heads of 192 and v heads of 128, a profiled split into attention,
     expert matmuls, routing / dispatch / combine, MLA projections and
     the rest), greedy ``generate`` (batch 4, prompt 8, 32 steps) from
     the compressed (c_kv, k_pe) cache (1,152 bytes a token a layer);
     then a 1 x 512 prefill through the kernel against the plain chunked
     attention and the absorbed-form step-by-step prefill against
     ``forward`` at capacity factor 32 (no drops), within 2**-4 of the
     largest |logit|, the second side routed as the first;
   phase 2 also holds ``swa_attention`` at (1, 128, 4,096 and 4,000, 192
   / 128) bf16 in both modes and the float32 kernel at (1, 4, 1,000, 48
   / 32) against their plain versions, and times it at the prefill's
   (1, 128, 32,768, 192 / 128) against its 44.47 ms bound beside
   ``scaled_dot_product_attention``;
9. the SSM families at full width (``nn/ssm.py``): xLSTM-350M, 8 of its
   24 layers, trained by FedPT (its frozen split asserted, 8 rounds of
   ``run_reduced_arch``'s data and round, a finite falling loss, sumsq
   once a round at the flat width and within its bound of a float64 sum,
   one profiled round, the reduced config's round card vs CPU) and served
   (a 16 x 2,048 prefill, profiled at 16 x 128, greedy decode with the
   recurrent state's bytes, the step-by-step prefill against ``forward``
   over 160 positions in float32, the bf16 gap printed) at all 24;
   Jamba-v0.1
   served at one period, 8 of its 32 layers (a 1 x 32,768 prefill with
   ``swa_attention`` in its attention
   layer, profiled at 1 x 4,096 into Mamba's scan and projections,
   attention, experts, dispatch and the rest, greedy decode, kernel vs
   plain attention and step-by-step prefill against ``forward`` on 1 x
   512, the second side routed as the first) and its reduced round card
   vs CPU;
10. the VLM and the encoder-decoder at full width: PaliGemma-3B trained
   by FedPT at 8 of its 18 layers (the 18-layer split asserted on meta
   tensors; 256 zero patch embeddings before each sentence) and served
   at all 18 (a 64 x (256 + 256) prefill through
   ``swa_attention`` with the bidirectional prefix at head dim 256,
   profiled at 8 x (256 + 256), greedy text decode, kernel vs plain on 1
   x (256 + 64) and the step-by-step prefill against ``forward``);
   Whisper large-v3 trained by FedPT at 3 + 3 layers over the full 1,500
   zero frames and served at 32 + 32 (16 x 1,500 frames and 16 x 448
   tokens: ``swa_attention`` in every encoder, decoder and
   cross-attention call, 96 a prefill; decode against
   ``build_cross_cache``'s K / V, the cross cache's bytes a sequence;
   kernel vs plain and stepped decode vs ``forward`` at 1 x 1,500 frames
   and 64 tokens); each with its split asserted, a falling loss,
   ``sumsq`` once a round and a reduced round card vs CPU; phase 2 holds
   and times the kernel at their three shapes;
11. the mesh: a 1-rank NCCL group and the ``single`` mesh; the
   quickstart at int8, FedAvg B (fused coefficient route, DP, screen) and
   the async DP FedBuff grid run with ``mesh="single"`` and without, bit
   for bit with equal kernel launches (cuDNN deterministic);
   (c) ``launch/specs.make_train_step``'s gathered layout: Mixtral-8x7B
   with its experts in the ``2d_swapped`` mode at 2 layers (1 client x
   tau 2 x 1 sequence of 4,096 tokens), bit for bit the unmeshed round
   with equal launches; (e) the tensor-parallel step's wiring on that 1-rank mesh
   (on a 1-rank "model" axis the pieces are whole and no layer splits):
   ``make_train_step`` for StableLM-2-1.6B at full width (2 of 24
   layers, as (c)) and ``specs.make_tp_prefill_step`` for Mixtral-8x7B
   at phase 7's 4 layers (1 x 32,768, window 4,096, ``swa_attention``),
   each bit for bit the unmeshed run with equal launches; (f) the
   tensor-parallel layers on a 4-rank "model" axis on the one card
   (four threads, a threaded process group, mesh (1, 4)): Mixtral-8x7B
   at full width, 2 layers, its tensor-parallel prefill
   (``swa_attention`` on each rank's 8 q / 2 kv heads) held to the
   unmeshed one routed alike, and one tensor-parallel train step in
   float32 compute held to the unmeshed round by update norm, the
   frozen leaves the model received on each rank its pieces, and
   ``swa_attention`` timed at the local-head shape; (g) DeepSeek-V2 at
   1 layer on a (2, 2) mesh of threads, its routed experts in the 2-D
   layout; (h) Jamba-v0.1 at 2 layers (attention period 2: Mamba on each
   rank's channels with the dense FFN, then attention with the MoE) and
   (i) xLSTM-350M at one period (3 mLSTM blocks, their projections
   split, and the sLSTM whole), (j) PaliGemma-3B at 2 of 18 layers
   (16 rows of 256 patch embeddings and 256 tokens; ``mm_proj`` whole
   and the same on every rank) and (k) Whisper large-v3 at 2 + 2 layers
   (16 rows of 1,500 frames and 448 tokens; the encoder's and the
   cross-attention's ``swa_attention`` at a rank's 5 heads, the vocab
   whole) on (1, 4) meshes of threads, each held as (f) is, the card's
   peak over each leg's meshed prefill printed;
   (d) one ``launch/dryrun`` subprocess (Mixtral-8x7B x train_4k in a
   fake (16, 16) world on the host, tensor-parallel), its traced per-rank peak
   beside the card's memory and the largest tensors that hold it;
12. the examples: each ``examples_torch/`` twin's ``main`` in this
   process on the card, at every invocation that ``ci.yml``'s
   ``examples``, ``telemetry`` and ``chaos`` jobs make of the reference
   example, the quickstart and ``dp_federated_lm`` at their defaults,
   ``federated_llm_finetune`` on one id of each family (8 rounds) and
   ``serve_longcontext`` as is; each run's own assertions, the kernels
   its path must launch (counts set to 0 just before it), its wall
   time, its traced event streams held by ``repro_torch.obs.schema``
   (the kinds the CI requires, and causal ids) and the hostile
   hierarchical run's metrics held to ``GOLDEN_telemetry_metrics.json``
   by ``repro_torch.obs.compare`` with the CI's ``--fail-on`` counters;
13. print the ``kernels`` JSON line, the card's name and power limit,
   and, last, the ``{"ok": true, "device": ...}`` line. Each phase prints
   its seconds on a line of its own.

Exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_CLIENTS, EXAMPLES, CLIENTS_PER_ROUND, LOCAL_STEPS, LOCAL_BATCH = 40, 50, 10, 2, 16
ROUNDS = 10
# variant B: DP-FedAvg as the JAX package's tests run it
DP_CLIP, DP_NOISE = 0.5, 0.4
POISONED = 3          # the client whose upload is NaN in B's extra round
# the async path: examples/async_heterogeneous.py's FedBuff settings
CONCURRENCY, GOAL, ASYNC_UPDATES, ASYNC_CHECKED = 12, 6, 12, 3
# no main path launches them: no engine of either package calls
# clip_accumulate or seed_reconstruct (only kernels/ops, the tests and this
# script's kernel phase reach them)
NO_ENGINE = {"clip_accumulate", "seed_reconstruct"}
# the CUDA kernels behind sumsq, leaf_maxabs, fake_quantize_flat, clip_flat
# and seed_reconstruct on this tree and on the trees before their
# redesign, for timing the two side by side
AB_KERNELS = {
    "sumsq": ("sumsq_one_launch_kernel", "sumsq_partials_kernel",
              "sum_partials_kernel"),
    "leaf_maxabs": ("maxabs_fold_kernel", "leaf_maxabs_kernel"),
    "fake_quantize_flat": ("qdq_cluster_kernel", "maxabs_fold_kernel",
                           "leaf_maxabs_kernel", "qdq_kernel"),
    "clip_flat": ("clip_cluster_kernel", "block_sumsq_kernel",
                  "row_scale_kernel", "scale_kernel"),
    "seed_reconstruct": ("seed_kernel",),
}
# NeMo's frozen FFN leaf, the shape a server regenerates from the seed
SEED_SHAPE = (5120, 14336)
HOST_COPY_OPS = ("cudaMemcpyAsync", "cudaStreamSynchronize")
HOST_SHOWN = HOST_COPY_OPS + ("cudaLaunchKernel",)
U = 2.0 ** -24


def qss_rtol(n_blocks: int) -> float:
    """The quantized row sums add the same n_blocks positive products in
    two orders (the row combine's fixed order on the card, torch's order
    in the plain version); each float32 sum is within (n - 1) * 2**-24 of
    the exact one
    (first-order bound of recursive summation), so they are within twice
    that of each other."""
    return 2 * n_blocks * 2.0 ** -24


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal NaN positions, and identical float32 bits everywhere else
    (compared on the host, the NaNs zeroed in place of taking the rest
    out: a masked copy of a 10**9-element output took seconds)."""
    a, b = a.float().cpu(), b.float().cpu()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(nan_a, nan_b):
        return False
    return torch.equal(a.masked_fill(nan_a, 0.0).view(torch.int32),
                       b.masked_fill(nan_b, 0.0).view(torch.int32))


def digest(*ts: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes: equal
    digests of two trees' outputs on the same inputs mean the same bits."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in float64 where both are finite (on the host)."""
    a, b = a.double().cpu(), b.double().cpu()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not both.any():
        return 0.0
    return float(torch.where(both, (a - b).abs(), 0.0).max())


def time_ms(fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean time per call over back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# a buffer written or read between launches to leave the 50 MB L2 cold,
# and the cycles the card sleeps before an event-timed call (so that the
# host has queued the whole call when the start event runs)
FLUSH_BYTES = 128 * 2 ** 20
SLEEP_CYCLES = 400_000
_FLUSH = {}


def flush_buffer(dev) -> torch.Tensor:
    """The L2 flush buffer on ``dev``, made at first use; free_flush()
    drops it, so that it stays out of later memory readings."""
    if dev not in _FLUSH:
        _FLUSH[dev] = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32,
                                 device=dev)
    return _FLUSH[dev]


def free_flush() -> None:
    _FLUSH.clear()
    torch.cuda.empty_cache()


def span_ms(fn, iters: int = 20, flush=None, read: bool = False) -> float:
    """Mean device span (ms) of one call of fn, by CUDA events recorded
    around each call alone: every device operation of the call and the
    gaps between them. The card sleeps first, so the host has queued the
    call; with ``flush`` it writes (or, with ``read``, reads) that buffer
    first, so the call finds L2 cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(iters):
        if flush is not None and read:
            flush.sum()
        elif flush is not None:
            flush.fill_(float(i))
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


# Late in a long process a profiler session records fewer launches than
# it ran, a count that grows with the process's age whatever the
# session's length (``--profiler-probe``; PERF.md), so the short sessions
# of the later phases recorded none (ROADMAP Queue 3). Each session's
# calls sit between PAD_LAUNCHES spin kernels (``torch.cuda._sleep``, ~50
# us each) on either side, which the results leave out.
PAD_LAUNCHES, PAD_CYCLES, PAD_KERNEL = 256, 100_000, "spin_kernel"


def _profiler_pad():
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()


def profiled_calls(fn, iters: int):
    """The profiler's key averages over ``iters`` calls of ``fn``, after one
    traced warm-up call that the profiler discards, the calls between two
    pads of spin kernels (left out of the averages)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=iters,
                                   repeat=1)) as prof:
        for i in range(1 + iters):
            if i == 1:
                _profiler_pad()
            fn()
            torch.cuda.synchronize()
            if i == iters:
                _profiler_pad()
            prof.step()
    return [ev for ev in prof.key_averages() if PAD_KERNEL not in ev.key]


def device_ms(fn, kernel_names=None, iters: int = 50):
    """Mean device time (ms) per call of the named CUDA kernels (of every
    kernel the call runs when ``kernel_names`` is None), from the
    profiler; None when the profiler shows no device time. Each named
    kernel launches once per call, so its share is its mean time per
    recorded launch: a trace can drop a launch (on the H100 it kept one
    of two 150-350 ms attention calls), which a total over ``iters``
    calls would halve."""
    total = 0.0
    for ev in profiled_calls(fn, iters):
        if kernel_names is None:
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0)) / iters
        elif any(k in ev.key for k in kernel_names):
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0)) / ev.count
    return total / 1e3 if total > 0 else None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def call_times(fn, knames, nbytes: float, nops: float, dev) -> dict:
    """One call of fn timed warm and L2-cold: the wrapper (CUDA events over
    back-to-back calls), the named kernels' device time back to back
    (warm: the rows were just read), after a 128 MB write (``cold``) and
    after a 128 MB read (``cold_read``), from the profiler; the whole
    call's device time back to back (every device op, a memset included);
    the whole call's span by events around each call alone, warm and both
    cold; and the byte bound. A write leaves L2 full of dirty lines whose
    write-back to HBM falls inside the timed call; a read leaves it full of
    clean ones, so ``cold_read`` is the reading to hold against the HBM
    bound."""
    flush = flush_buffer(dev)

    def cold():
        flush.fill_(1.0)
        return fn()

    def cold_read():
        flush.sum()
        return fn()
    return {"wrapper_ms": time_ms(fn),
            "kernels_ms": device_ms(fn, knames),
            "call_device_ms": device_ms(fn),
            "span_ms": span_ms(fn),
            "cold_kernels_ms": device_ms(cold, knames, 20),
            "cold_span_ms": span_ms(fn, flush=flush),
            "cold_read_kernels_ms": device_ms(cold_read, knames, 20),
            "cold_read_span_ms": span_ms(fn, flush=flush, read=True),
            "bound_ms": bound(nbytes, nops)[0]}


def maxabs_bytes(rows: int, n: int, n_leaves: int) -> int:
    """leaf_maxabs' least traffic: x read once, the block->leaf map read
    once, the (rows, L) maxima written once."""
    return 4 * rows * n + 4 * (n // 1024) + 4 * rows * n_leaves


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def host_op_counts(fn, iters: int, names=HOST_COPY_OPS):
    """Calls of the named CUDA runtime functions per call of ``fn`` (mean
    over ``iters`` calls after one warm-up), from the profiler's host
    events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    counts = {name: 0 for name in names}
    for ev in prof.key_averages():
        if ev.key in counts:
            counts[ev.key] += ev.count
    return {name: c / iters for name, c in counts.items()}


def kernel_records(specs, iters=(200, 50, 50), warmup: int = 5,
                   ops_per_s: float = F32_OPS_PER_S):
    """Time each kernel's wrapper, its plain version and the library call
    (``iters`` calls each: wrapper and library, plain, profiled device),
    and compute its bound: one ``kernels`` record each (all keys but
    ``launches``; ``library_device_ms`` is the library call's device
    time). A plain version given as ``(output, ms)`` was run and timed
    once already (a long one, at a kernel's full shape)."""
    records = []
    n_kern, n_plain, n_dev = iters
    for (name, source, replaces, kern, plain, lib, knames, nbytes,
         nops) in specs:
        once = isinstance(plain, tuple)
        err = max(max_abs_diff(a, b) for a, b in zip(
            as_tuple(kern()), as_tuple(plain[0] if once else plain())))
        bound_ms, bound_by = bound(nbytes, nops, ops_per_s)
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err,
            "ms": time_ms(kern, n_kern, warmup),
            "plain_ms": plain[1] if once else time_ms(plain, n_plain,
                                                       warmup),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (time_ms(lib, n_kern, warmup) if lib is not None
                           else None),
            "device_ms": device_ms(kern, knames, n_dev),
            "library_device_ms": (device_ms(lib, None, n_dev)
                                  if lib is not None else None),
        })
        if len(knames) > 1:
            print(f"  {name}: device ms by CUDA kernel "
                  f"{ {k: device_ms(kern, (k,)) for k in knames} }")
    return records


def emnist_loss(params, batch):
    from repro_torch.models import paper_models as pm
    logits = pm.emnist_cnn_forward(params, batch["images"])
    lp = torch.log_softmax(logits, -1)
    return -lp.gather(1, batch["labels"].long()[:, None]).mean(), {}


def check_kernels(layout, layout_a, dev):
    """Phase 2: sumsq, max-abs and Q->DQ against their plain versions at
    the quickstart's buffer (Q->DQ on its cluster route), Q->DQ at the
    FedAvg width and at both sides of the route boundary, and max-abs and
    the two-pass Q->DQ at the SO async lane's rows, each call's route
    asserted; returns their records."""
    from repro_torch import kernels
    from repro_torch.kernels import dp_clip, quantize, ref

    gen = torch.Generator(device="cpu").manual_seed(0)
    K, N, L = CLIENTS_PER_ROUND, layout.size, len(layout.sizes)
    bl = layout.block_leaf()
    bl_dev = torch.as_tensor(bl, dtype=torch.int32, device=dev)
    mat = (torch.randn((K, N), generator=gen) * 1e-2).to(dev)
    # edge cases: an all-zero leaf in row 0, a NaN in row 3, an Inf in row 5
    edge = mat.clone()
    z0, z1 = layout.offsets[2], layout.offsets[2] + layout.padded[2]
    edge[0, z0:z1] = 0.0
    edge[3, layout.offsets[3] + 17] = float("nan")
    edge[5, layout.offsets[5] + 3] = float("inf")
    # a ragged layout: leaves of 1, 3, 2 and 1 blocks, 3 rows
    rag_bl = np.array([0, 1, 1, 1, 2, 2, 3], np.int32)
    rag = (torch.randn((3, rag_bl.size * 1024), generator=gen)).to(dev)

    kernels.reset_launches()
    for name, x, blk, nl in (("main", mat, bl, L), ("edge", edge, bl, L),
                             ("ragged", rag, rag_bl, 4)):
        got = quantize.leaf_maxabs(x, blk, nl)
        want = ref.leaf_maxabs_ref(x, blk, nl)
        if not same_bits(got, want):
            raise AssertionError(f"leaf_maxabs != plain version ({name})")
        got = quantize.fake_quantize_flat(x, blk, nl)
        want = ref.fake_quantize_flat_ref(x, blk, n_leaves=nl)
        if not same_bits(got, want):
            raise AssertionError(f"fake_quantize_flat != plain version "
                                 f"({name}): max diff {max_abs_diff(got, want)}")
        print(f"  leaf_maxabs, fake_quantize_flat == plain, bit for bit "
              f"({name}, {tuple(x.shape)})")
    if (kernels.ROUTES["fake_quantize_flat/cluster"],
            kernels.ROUTES["fake_quantize_flat/two_pass"]) != (3, 0):
        raise AssertionError(f"fake_quantize_flat routes {kernels.ROUTES}, "
                             f"not the cluster route three times")
    # the two-pass route: the FedAvg row; and the route boundary (256
    # blocks a row) with a leaf map that is not contiguous
    wide = (torch.randn((K, layout_a.size), generator=gen) * 1e-2).to(dev)
    wide[3, 12_345] = float("nan")
    # max-abs where it runs, the FedAvg width: 10 and 6 rows
    bl_a, L_a = layout_a.block_leaf(), len(layout_a.sizes)
    for rows in (K, GOAL):
        kernels.reset_launches()
        got = quantize.leaf_maxabs(wide[:rows], bl_a, L_a)
        if not same_bits(got, ref.leaf_maxabs_ref(wide[:rows], bl_a, L_a)):
            raise AssertionError(f"leaf_maxabs != plain version (FedAvg, "
                                 f"{rows} rows)")
        if kernels.LAUNCHES["leaf_maxabs"] != 1:
            raise AssertionError(f"leaf_maxabs (FedAvg, {rows} rows) "
                                 f"launched {kernels.LAUNCHES['leaf_maxabs']}"
                                 f" times, not once")
        print(f"  leaf_maxabs == plain, bit for bit (FedAvg, "
              f"{(rows, layout_a.size)}, plan "
              f"{quantize.maxabs_plan(rows, layout_a.size)})")
    for name, x, blk, nl, route in (
            ("FedAvg", wide, layout_a.block_leaf(), len(layout_a.sizes),
             "two_pass"),
            ("256 blocks", wide[:2, :256 * 1024].contiguous(),
             np.arange(256, dtype=np.int32) % 5, 5, "cluster"),
            ("257 blocks", wide[:2, :257 * 1024].contiguous(),
             np.arange(257, dtype=np.int32) % 5, 5, "two_pass")):
        kernels.reset_launches()
        got = quantize.fake_quantize_flat(x, blk, nl)
        if not same_bits(got, ref.fake_quantize_flat_ref(x, blk,
                                                         n_leaves=nl)):
            raise AssertionError(f"fake_quantize_flat != plain version "
                                 f"({name})")
        if kernels.ROUTES[f"fake_quantize_flat/{route}"] != 1:
            raise AssertionError(f"fake_quantize_flat ({name}) took "
                                 f"{kernels.ROUTES}, not {route}")
        print(f"  fake_quantize_flat == plain, bit for bit, on the {route} "
              f"route ({name}, {tuple(x.shape)})")
    if not torch.isnan(quantize.fake_quantize_flat(edge, bl, L)[3]).any():
        raise AssertionError("the NaN row lost its NaN")
    if quantize.fake_quantize_flat(edge, bl, L)[0, z0:z1].abs().max() != 0:
        raise AssertionError("the all-zero leaf did not stay zero")

    vec = mat[0].contiguous()
    for name, v in (("main", vec),
                    ("ragged", torch.randn(N + 77, generator=gen).to(dev)),
                    ("FedAvg", wide[0].contiguous())):
        got = dp_clip.sumsq(v)
        want64 = float((v.double() ** 2).sum())
        if not math.isclose(float(got), want64, rel_tol=1e-5):
            raise AssertionError(f"sumsq {float(got)} vs float64 {want64} "
                                 f"({name})")
        if not torch.equal(got, dp_clip.sumsq(v)):
            raise AssertionError("sumsq differs between two runs")
        print(f"  sumsq within rtol 1e-5 of float64, same bits twice "
              f"({name}, n={v.numel()}): rel err "
              f"{abs(float(got) - want64) / want64:.3e}")

    # the SO async lane's rows over its 46-leaf map, the one main path
    # that launches max-abs and the two-pass Q->DQ: one launch each
    bl_so, L_so, n_so = so_lane_block_leaf(dev)
    so = clip_rows(n_so, torch.Generator().manual_seed(20), dev)
    kernels.reset_launches()
    if not same_bits(quantize.leaf_maxabs(so, bl_so, L_so),
                     ref.leaf_maxabs_ref(so, bl_so, L_so)):
        raise AssertionError("leaf_maxabs != plain version (SO lane)")
    if kernels.LAUNCHES["leaf_maxabs"] != 1:
        raise AssertionError(f"leaf_maxabs (SO lane) launched "
                             f"{kernels.LAUNCHES['leaf_maxabs']} times")
    kernels.reset_launches()
    if not same_bits(quantize.fake_quantize_flat(so, bl_so, L_so),
                     ref.fake_quantize_flat_ref(so, bl_so, n_leaves=L_so)):
        raise AssertionError("fake_quantize_flat != plain version (SO lane)")
    once = {"leaf_maxabs": 1, "fake_quantize_flat": 1,
            "fake_quantize_flat/two_pass": 1}
    got = {**kernels.LAUNCHES, **kernels.ROUTES}
    if {k: got[k] for k in once} != once:
        raise AssertionError(f"fake_quantize_flat (SO lane) launched "
                             f"{got}, not once on the two-pass route")
    print(f"  leaf_maxabs, fake_quantize_flat == plain, bit for bit, one "
          f"launch each, two-pass route (SO lane, {tuple(so.shape)}, "
          f"{L_so} leaves)")

    # (name, source, replaces, kernel call, plain call, library call,
    #  kernel names for the profiler, bytes, ops)
    nb = bl.size
    records = kernel_records([
        ("sumsq", "src/repro_torch/kernels/csrc/sumsq.cu",
         "src/repro/kernels/dp_clip.py:25",
         lambda: dp_clip.sumsq(vec), lambda: ref.flat_sumsq_ref(vec),
         lambda: torch.dot(vec, vec), ("sumsq_one_launch_kernel",),
         N * 4 + 4, 2 * N),
        ("leaf_maxabs", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:35",
         lambda: quantize.leaf_maxabs(mat, bl_dev, L),
         lambda: ref.leaf_maxabs_ref(mat, bl_dev, L), None,
         AB_KERNELS["leaf_maxabs"], maxabs_bytes(K, N, L), 2 * K * N),
        ("fake_quantize_flat", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:52",
         lambda: quantize.fake_quantize_flat(mat, bl_dev, L),
         lambda: ref.fake_quantize_flat_ref(mat, bl_dev, n_leaves=L), None,
         ("qdq_cluster_kernel",), 2 * K * N * 4 + nb * 4, 5 * K * N),
    ])
    # max-abs: the whole call at the record's shape, and the FedAvg width
    # where it runs, warm and L2-cold (call_times)
    rec = records[1]
    rec["call_device_ms"] = device_ms(
        lambda: quantize.leaf_maxabs(mat, bl_dev, L))
    bl_a_dev = torch.as_tensor(bl_a, dtype=torch.int32, device=dev)
    rec["shapes"] = []
    for rows in (K, GOAL):
        x = wide[:rows]
        rec["shapes"].append({
            "shape": [rows, layout_a.size],
            **call_times(lambda x=x: quantize.leaf_maxabs(x, bl_a_dev, L_a),
                         AB_KERNELS["leaf_maxabs"],
                         maxabs_bytes(rows, layout_a.size, L_a),
                         2 * rows * layout_a.size, dev)})
    return records


def ab_times(dev, label: str) -> dict:
    """sumsq and fake_quantize_flat timed through the package on
    ``sys.path`` (this tree's, or another tree's with ``--kernel-times
    SRC``), for comparing the two trees in one call: per shape the
    wrapper (CUDA events over back-to-back calls), the named CUDA kernels'
    device time and the whole call's device time (every device op of the
    call, a memset included), with the bound and, for sumsq,
    ``torch.dot``'s wall and device time; then the blocking host-to-device
    copies per call of ``core/flat.fake_quantize`` (a new layout each
    call, as the round engine makes one) and per profiled quickstart round
    at ``uplink_bits=8``; then ``clip_flat`` at the async lane's (6,
    89,088) and at (6, 1,695,744) and ``seed_reconstruct`` at
    ``SEED_SHAPE`` in float32 and bfloat16 the same way, each with a
    digest of its output (equal digests: the same bits on both trees) and
    the seed kernel's SASS counts and issue-rate estimate
    (:func:`seed_issue`); then ``leaf_maxabs`` at (10, 89,088), at the
    FedAvg width (6 | 10, 1,695,744) and at the SO PT lane's (6,
    1,692,672), and the two-pass ``fake_quantize_flat`` it serves at the
    last three, warm and L2-cold
    (:func:`call_times`), each with a digest, beside a per-block
    ``torch.linalg.vector_norm(..., inf)`` of the same rows as a yardstick
    of one read. Prints and returns one JSON object."""
    from repro_torch.core import flat as flat_lib, reconstruct
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build, dp_clip, quantize
    from repro_torch.kernels import seed_reconstruct as sr
    from repro_torch.models import paper_models as pm
    from repro_torch.nn import threefry

    gen = torch.Generator(device="cpu").manual_seed(11)
    y0, frozen = reconstruct.init_partitioned(pm.init_emnist_cnn, 0,
                                              pm.EMNIST_FREEZE, device=dev)
    layout = flat_lib.FlatLayout.of(y0)
    N, L = layout.size, len(layout.sizes)
    bl = torch.as_tensor(layout.block_leaf(), dtype=torch.int32, device=dev)
    out = {"tree": label}
    for n in (N, 1_695_744):
        v = torch.randn(n, generator=gen).to(dev)

        def call(v=v):
            return dp_clip.sumsq(v)

        def dot(v=v):
            return torch.dot(v, v)
        out[f"sumsq n={n}"] = {
            "wrapper_ms": time_ms(call),
            "kernels_ms": device_ms(call, AB_KERNELS["sumsq"]),
            "call_device_ms": device_ms(call),
            "bound_ms": bound(4 * n + 4, 2 * n)[0],
            "dot_ms": time_ms(dot), "dot_device_ms": device_ms(dot)}
    for rows in (CLIENTS_PER_ROUND, GOAL):
        m = (torch.randn((rows, N), generator=gen) * 1e-2).to(dev)

        def call(m=m):
            return quantize.fake_quantize_flat(m, bl, L)
        out[f"fake_quantize_flat ({rows}, {N})"] = {
            "wrapper_ms": time_ms(call),
            "kernels_ms": device_ms(call, AB_KERNELS["fake_quantize_flat"]),
            "call_device_ms": device_ms(call),
            "bound_ms": bound(8 * rows * N + 4 * bl.numel(), 5 * rows * N)[0]}
    m = (torch.randn((CLIENTS_PER_ROUND, N), generator=gen) * 1e-2).to(dev)
    out["flat.fake_quantize host ops per call"] = host_op_counts(
        lambda: flat_lib.fake_quantize(m, flat_lib.FlatLayout.of(y0), 8), 10)
    ds = syn.make_federated_images(N_CLIENTS, EXAMPLES, (28, 28, 1), 62,
                                   alpha=1.0, seed=0)
    (batch, w), = cohorts(ds, 1)
    round_fn, sopt = make_round(8, dev)
    sstate = sopt.init(y0)
    out["quickstart bits 8 round host ops"] = host_op_counts(
        lambda: round_fn(y0, sstate, frozen, batch, w, threefry.key(0)), 3)
    cgen = torch.Generator(device="cpu").manual_seed(13)
    for n in (N, 1_695_744):
        m = clip_rows(n, cgen, dev)

        def call(m=m):
            return dp_clip.clip_flat(m, DP_CLIP)
        out[f"clip_flat ({GOAL}, {n})"] = {
            "wrapper_ms": time_ms(call),
            "kernels_ms": device_ms(call, AB_KERNELS["clip_flat"]),
            "call_device_ms": device_ms(call),
            "bound_ms": bound(8 * GOAL * n + 4 * GOAL, 3 * GOAL * n)[0],
            "digest": digest(*call())}
    rows, cols = SEED_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        def call(dtype=dtype):
            return sr.seed_reconstruct(42, 7, SEED_SHAPE, 0.02, dtype=dtype,
                                       device=dev)
        out[f"seed_reconstruct {SEED_SHAPE} {dtype}"] = {
            "wrapper_ms": time_ms(call, 50),
            "kernels_ms": device_ms(call, AB_KERNELS["seed_reconstruct"], 20),
            "call_device_ms": device_ms(call, None, 20),
            "bound_ms": bound(dtype.itemsize * rows * cols,
                              32 * rows * cols)[0],
            "digest": digest(call())}
    out["seed_reconstruct issue-rate estimate"] = seed_issue(sr, _build, dev)
    # max-abs at the quickstart's buffer and, where it runs, at the FedAvg
    # width, with the two-pass Q->DQ it serves there: warm and L2-cold
    ya, _ = reconstruct.init_partitioned(pm.init_emnist_cnn, 0, (),
                                         device=dev)
    layout_a = flat_lib.FlatLayout.of(ya)
    Na, La = layout_a.size, len(layout_a.sizes)
    bla = torch.as_tensor(layout_a.block_leaf(), dtype=torch.int32,
                          device=dev)
    bls, Ls, Ns = so_lane_block_leaf(dev)
    mgen = torch.Generator(device="cpu").manual_seed(19)
    for rows, n, blk, nl in ((CLIENTS_PER_ROUND, N, bl, L),
                             (GOAL, Na, bla, La),
                             (CLIENTS_PER_ROUND, Na, bla, La),
                             (GOAL, Ns, bls, Ls)):
        m = (torch.randn((rows, n), generator=mgen) * 1e-2).to(dev)

        def call(m=m, blk=blk, nl=nl):
            return quantize.leaf_maxabs(m, blk, nl)
        out[f"leaf_maxabs ({rows}, {n})"] = {
            **call_times(call, AB_KERNELS["leaf_maxabs"],
                         maxabs_bytes(rows, n, nl), 2 * rows * n, dev),
            "digest": digest(call())}

        def block_norm(m=m, rows=rows):
            # per-block max|x|: one read of the same rows, not the same
            # function (no per-leaf fold), so only a yardstick
            return torch.linalg.vector_norm(m.view(rows, -1, 1024),
                                            float("inf"), -1)
        # its reduction kernel, by the functor torch's inf norm runs (the
        # flushing sum's kernel is also a reduce_kernel)
        out[f"vector_norm inf by block ({rows}, {n})"] = call_times(
            block_norm, ("AbsMaxOps",), 4 * rows * n, rows * n, dev)
        if n in (Na, Ns):
            def qdq(m=m, blk=blk, nl=nl):
                return quantize.fake_quantize_flat(m, blk, nl)
            out[f"fake_quantize_flat two-pass ({rows}, {n})"] = {
                **call_times(qdq, AB_KERNELS["fake_quantize_flat"],
                             8 * rows * n + 4 * blk.numel(), 5 * rows * n,
                             dev),
                "digest": digest(qdq())}
    print("[ab] " + json.dumps(out))
    return out


def check_fused_kernels(layout, dev):
    """Phase 2, fused tail: stats, pack and apply against their plain
    versions at the FedAvg baseline's buffer, clean and with the edge
    cases; returns their records."""
    from repro_torch.kernels import agg_tail, ref

    gen = torch.Generator(device="cpu").manual_seed(2)
    K, N, L = CLIENTS_PER_ROUND, layout.size, len(layout.sizes)
    bl = layout.block_leaf()
    mat = (torch.randn((K, N), generator=gen) * 1e-2).to(dev)
    # an all-zero leaf in row 0, a NaN in row 3, an Inf in row 5, and in
    # row 7 exact .5 ties: leaf 0 is one block, so its scale is 127 / 127
    edge = mat.clone()
    z0, z1 = layout.offsets[2], layout.offsets[2] + layout.padded[2]
    edge[0, z0:z1] = 0.0
    edge[3, layout.offsets[3] + 17] = float("nan")
    edge[5, layout.offsets[5] + 3] = float("inf")
    edge[7, :1024] = 0.0
    edge[7, 0] = 127.0
    edge[7, 1:255] = torch.arange(-126.5, 127.0, device=dev)
    w = torch.linspace(0.5, 1.5, K, device=dev)
    noise = (torch.randn(N, generator=gen) * 1e-3).to(dev)

    for name, x in (("main", mat), ("edge", edge)):
        fin = torch.isfinite(x).all(dim=1)
        bmax, bsumsq = agg_tail.block_stats(x)
        want_max, want_ss = ref.agg_block_stats_ref(x, with_sumsq=True)
        if not (same_bits(bmax, want_max) and same_bits(bsumsq, want_ss)):
            raise AssertionError(f"block_stats != plain version ({name})")
        sblock = ref.agg_scales_ref(bmax, bl, 8, L)
        q, qss = agg_tail.pack(x, sblock)
        if not torch.equal(q[fin], ref.agg_pack_ref(x, sblock, 8)[fin]):
            raise AssertionError(f"pack codes != plain version ({name})")
        want_qss = ref.agg_quant_sumsq_ref(q, sblock)
        rel = float(((qss - want_qss).abs() / want_qss.abs())[fin].max())
        if not rel <= qss_rtol(bl.size):
            raise AssertionError(f"pack row sums off by rel {rel} ({name})")
        coeff = torch.nan_to_num((w / w.sum())[:, None] * sblock, nan=0.0,
                                 posinf=0.0, neginf=0.0)
        for nz in (None, noise):
            out = agg_tail.apply_coeff(q, coeff, nz)
            if not same_bits(out, ref.agg_apply_ref(q, coeff, noise=nz)):
                raise AssertionError(f"apply_coeff != plain version ({name})")
        again = agg_tail.block_stats(x), agg_tail.pack(x, sblock)
        if not (same_bits(again[0][1], bsumsq) and torch.equal(again[1][0], q)
                and same_bits(again[1][1], qss) and same_bits(
                    agg_tail.apply_coeff(q, coeff, noise),
                    agg_tail.apply_coeff(q, coeff, noise))):
            raise AssertionError(f"a fused kernel differs between two runs "
                                 f"({name})")
        print(f"  block_stats (max, sumsq), pack codes, apply_coeff == plain, "
              f"bit for bit; row sums within rel {rel:.3e}; same bits twice "
              f"({name}, {tuple(x.shape)}, rows {fin.sum().item()} finite)")
        if name == "edge":
            if bool(torch.isfinite(bmax[3]).all()) or bool(
                    torch.isfinite(bmax[5]).all()):
                raise AssertionError("a non-finite row looks finite")
            if not torch.equal(q[7, 0, 1:255].cpu(), torch.arange(
                    -126.5, 127.0).round().to(torch.int8)):
                raise AssertionError(".5 ties did not round half to even")
            if q[0].reshape(-1)[z0:z1].abs().max() != 0:
                raise AssertionError("the all-zero leaf did not stay zero")

    bmax, _ = agg_tail.block_stats(mat)
    sblock = ref.agg_scales_ref(bmax, bl, 8, L)
    q, _ = agg_tail.pack(mat, sblock)
    coeff = (w / w.sum())[:, None] * sblock
    nb = bl.size
    src = "src/repro_torch/kernels/csrc/agg_tail.cu"
    return kernel_records([
        ("block_stats", src, "src/repro/kernels/agg_tail.py:81",
         lambda: agg_tail.block_stats(mat),
         lambda: ref.agg_block_stats_ref(mat, with_sumsq=True), None,
         ("block_stats_kernel",), K * N * 4 + 2 * K * nb * 4, 3 * K * N),
        ("pack", src, "src/repro/kernels/agg_tail.py:87",
         lambda: agg_tail.pack(mat, sblock),
         lambda: (lambda c: (c, ref.agg_quant_sumsq_ref(c, sblock)))(
             ref.agg_pack_ref(mat, sblock, 8)), None,
         ("pack_kernel", "row_combine_kernel"),
         K * N * 5 + K * nb * 4 + K * 4, 6 * K * N),
        ("apply_coeff", src, "src/repro/kernels/agg_tail.py:106",
         lambda: agg_tail.apply_coeff(q, coeff, noise),
         lambda: ref.agg_apply_ref(q, coeff, noise=noise), None,
         ("apply_kernel",), K * N + K * nb * 4 + 2 * N * 4, 2 * K * N),
    ])


def clip_rows(n, gen, dev, rows=GOAL):
    """Rows for the clip: clipped, zero, under the clip, a NaN, an Inf,
    clipped (and more clipped rows past six)."""
    m = torch.randn((rows, n), generator=gen) * 1e-2
    m[1] = 0.0
    m[2] *= 0.5 * DP_CLIP / float(m[2].double().norm())
    m[3, n // 3] = float("nan")
    m[4, n // 2] = float("inf")
    m[5] *= 40.0
    return m.to(dev)


def clip_three_launch(m):
    """clip_flat's three-launch route on the rows m, called through its C
    entry whatever route the wrapper would take: (clipped, norms)."""
    from repro_torch.kernels import _build, dp_clip
    R, n = m.shape
    lib = _build.load("dp_clip.cu", dp_clip._CLIP_SIGNATURES)
    out, norms = torch.empty_like(m), torch.empty(R, device=m.device)
    bss, scales = dp_clip._scratch(R, n, m.device)
    _build.raise_on_error("dp_clip_rows_f32", lib.dp_clip_rows_f32(
        m.data_ptr(), R, n, dp_clip.BLOCK, DP_CLIP, bss.data_ptr(),
        norms.data_ptr(), scales.data_ptr(), out.data_ptr(),
        _build.stream_ptr(m)))
    return out, norms


def check_clip_kernels(layout, layout_a, dev):
    """Phase 2, the DP clip: clip_flat and clip_accumulate against their
    plain versions at the async lane's rows and the FedAvg width, with the
    edge cases, each clip_flat call's route asserted (the cluster route at
    the lane's rows and with a ragged last block, bit for bit the
    three-launch entry's values and norms; the three-launch route at the
    FedAvg width, at n % 4 != 0 and at the SO async lane's rows); returns
    their records and prints the other shape's times."""
    from repro_torch import kernels
    from repro_torch.kernels import dp_clip, ref

    gen = torch.Generator(device="cpu").manual_seed(4)
    gen_so = torch.Generator(device="cpu").manual_seed(21)
    _, _, n_so = so_lane_block_leaf("cpu")
    for n, route, g in ((layout.size, "cluster", gen),
                        (layout_a.size, "three_launch", gen),
                        (layout.size + 512, "cluster", gen),
                        (layout.size + 77, "three_launch", gen),
                        (n_so, "three_launch", gen_so)):   # the SO lane
        m = clip_rows(n, g, dev)
        kernels.reset_launches()
        got, gnorm = dp_clip.clip_flat(m, DP_CLIP)
        if (kernels.LAUNCHES["clip_flat"],
                kernels.ROUTES[f"clip_flat/{route}"]) != (1, 1):
            raise AssertionError(f"clip_flat at n={n} took {kernels.ROUTES}, "
                                 f"not one launch on the {route} route")
        if route == "cluster":
            three, tnorm = clip_three_launch(m)
            if not (same_bits(got, three) and same_bits(gnorm, tnorm)):
                raise AssertionError(f"clip_flat's cluster route differs "
                                     f"from the three-launch entry at n={n}")
        want, wnorm = ref.flat_clip_ref(m, DP_CLIP)
        rtol = dp_clip.norm_rtol(n)
        rel = max(abs(float(gnorm[r]) - float(wnorm[r])) / float(wnorm[r])
                  for r in (0, 5))
        vrel = max(float(((got[r] - want[r]).abs()
                          / want[r].abs().clamp_min(1e-30)).max())
                   for r in (0, 5))
        if not (rel <= rtol and vrel <= rtol + 3 * U):
            raise AssertionError(f"clip_flat off its plain version at n={n}: "
                                 f"norm rel {rel}, values rel {vrel}")
        for r in (1, 2, 3, 4):
            if not (same_bits(got[r], want[r])
                    and same_bits(gnorm[r], wnorm[r])):
                raise AssertionError(f"clip_flat row {r} != plain version, "
                                     f"bit for bit (n={n})")
        if not (same_bits(got[2], m[2]) and bool(torch.isnan(got[3]).all())):
            raise AssertionError("a row under the clip changed, or the NaN "
                                 "row lost its NaN")
        again = dp_clip.clip_flat(m, DP_CLIP)
        if not (same_bits(again[0], got) and same_bits(again[1], gnorm)):
            raise AssertionError("clip_flat differs between two runs")
        same = (", bit for bit the three-launch entry" if route == "cluster"
                else "")
        print(f"  clip_flat == plain: norms within rel {rel:.3e} (bound "
              f"{rtol:.3e}), zero / under-clip / NaN / Inf rows bit for bit, "
              f"same bits twice ({tuple(m.shape)}, {route} route{same})")
    for n in (layout.size, layout_a.size, layout.size + 77):
        acc = (torch.randn(n, generator=gen) * 1e-3).to(dev)
        for scale in (1e-2, 1e-5):           # clipped, under the clip
            x = (torch.randn(n, generator=gen) * scale).to(dev)
            got, gnorm = dp_clip.clip_accumulate(acc, x, DP_CLIP)
            want, wnorm = ref.dp_clip_accumulate_ref(acc, x, DP_CLIP)
            rel = abs(float(gnorm) - float(wnorm)) / float(wnorm)
            terms = acc.abs() + x.abs() * min(1.0, DP_CLIP / float(wnorm))
            ok = rel <= 1e-6 and bool(((got - want).abs()
                                       <= 1e-6 * terms).all())
            if scale == 1e-5:
                ok = ok and same_bits(got, acc + x)
            if not ok or not same_bits(
                    dp_clip.clip_accumulate(acc, x, DP_CLIP)[0], got):
                raise AssertionError(f"clip_accumulate off its plain version "
                                     f"(n={n}, scale {scale}): norm rel {rel}")
        # a zero x, an Inf and a NaN: bit for bit the plain version's
        for edge, value in (("zero", 0.0), ("inf", float("inf")),
                            ("nan", float("nan"))):
            xe = torch.zeros_like(x) if edge == "zero" else x.clone()
            xe[n // 2] = value
            got, gnorm = dp_clip.clip_accumulate(acc, xe, DP_CLIP)
            want, wnorm = ref.dp_clip_accumulate_ref(acc, xe, DP_CLIP)
            if not (same_bits(got, want) and same_bits(gnorm, wnorm)):
                raise AssertionError(f"clip_accumulate ({edge}) != plain "
                                     f"version, bit for bit (n={n})")
        print(f"  clip_accumulate within rtol 1e-6 of plain (last norm rel "
              f"{rel:.3e}), under-clip / zero / Inf / NaN bit for bit, same "
              f"bits twice (n={n})")

    src = "src/repro_torch/kernels/csrc/dp_clip.cu"
    knames = AB_KERNELS["clip_flat"]

    def specs(rows, n):
        m = (torch.randn((rows, n), generator=gen) * 1e-2).to(dev)
        acc = (torch.randn(n, generator=gen) * 1e-3).to(dev)
        return [
            # torch.renorm clips each row to L2 norm C as one call (its
            # denominator is norm + 1e-7, and it returns no norms)
            ("clip_flat", src, "src/repro/kernels/dp_clip.py:70",
             lambda: dp_clip.clip_flat(m, DP_CLIP),
             lambda: ref.flat_clip_ref(m, DP_CLIP),
             lambda: torch.renorm(m, 2, 0, DP_CLIP), knames,
             8 * rows * n + 4 * rows, 3 * rows * n),
            ("clip_accumulate", src, "src/repro/kernels/dp_clip.py:41",
             lambda: dp_clip.clip_accumulate(acc, m[0], DP_CLIP),
             lambda: ref.dp_clip_accumulate_ref(acc, m[0], DP_CLIP), None,
             knames[1:], 12 * n + 4, 4 * n),
        ]
    # the JSON line's shapes: clip_flat at the async lane's buffer,
    # clip_accumulate at the FedAvg width; the other shape printed
    main = specs(GOAL, layout.size)[:1] + specs(1, layout_a.size)[1:]
    other = specs(GOAL, layout_a.size)[:1] + specs(1, layout.size)[1:]
    for rec in kernel_records(other):
        shape = "(6, 1695744)" if rec["name"] == "clip_flat" else "(89088,)"
        lib = ("" if rec["library_ms"] is None else
               f", torch.renorm {rec['library_ms']:.5f} ms (device "
               f"{fmt_ms(rec['library_device_ms'])})")
        print(f"  {rec['name']} at {shape}: wrapper {rec['ms']:.5f} ms, "
              f"device {fmt_ms(rec['device_ms'])} ms, plain "
              f"{rec['plain_ms']:.5f} ms, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}){lib}")
    return kernel_records(main)


def quickstart_rc(bits=0, dp=False):
    """The quickstart's configuration: 10 clients x 2 local SGD steps x
    batch 16, client lr 0.05, server SGD lr 0.5, at ``uplink_bits``;
    ``dp`` adds DP clip and noise."""
    from repro_torch.core import fedpt
    extra = (dict(dp_clip_norm=DP_CLIP, dp_noise_multiplier=DP_NOISE)
             if dp else {})
    return fedpt.RoundConfig(clients_per_round=CLIENTS_PER_ROUND,
                             local_steps=LOCAL_STEPS, local_batch=LOCAL_BATCH,
                             client_opt="sgd", client_lr=0.05,
                             server_opt="sgd", server_lr=0.5,
                             uplink_bits=bits, **extra)


def make_round(bits, dev, dp=False):
    """The quickstart's round; ``dp`` adds DP-FedAvg (clip, noise) and the
    quarantine screen."""
    from repro_torch.core import fedpt, sanitize
    return fedpt.make_round_fn(
        emnist_loss, quickstart_rc(bits, dp), device=dev,
        sanitize=sanitize.SanitizeConfig() if dp else None)


def cohorts(ds, n):
    """The quickstart's first n (batch, weights) draws, from seed 0."""
    from repro_torch.data import synthetic as syn
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        cids = syn.sample_cohort(rng, ds.num_clients, CLIENTS_PER_ROUND)
        out.append(syn.cohort_batch(ds, cids, LOCAL_STEPS, LOCAL_BATCH, rng))
    return out


def device_busy_ms(prof) -> float:
    """The union of the device events' intervals (kernels, copies,
    memsets) in a profiler trace, in ms: the time the card was busy,
    where kernels that overlap (cuDNN runs some on streams of its own)
    count once."""
    from torch.autograd import DeviceType
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def profile_round(step, what: str = "round", host: bool = True):
    """One round (or flush) under the profiler, printed on one line: wall
    ms; device-busy ms (:func:`device_busy_ms`) and its share; the device
    ops and their summed time (above the busy time where kernels
    overlap); the host ops with the most self time, with the calls of
    ``cudaMemcpyAsync`` / ``cudaStreamSynchronize`` (a blocking copy to
    the card makes one of each) and ``cudaLaunchKernel``. Without
    ``host`` only the CUDA activity is traced (the runtime calls and the
    device ops, no aten ops): a round of tens of thousands of launches
    then takes the profiler a fraction of the time to walk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    summed = 0.0
    ops = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            summed += getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
            ops += ev.count
    busy = device_busy_ms(prof)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top = [(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count)
           for e in host[:6]]
    top += [(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count)
            for e in host if e.key in HOST_SHOWN and
            e.key not in [t[0] for t in top]]
    print(f"  profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), "
          f"{ops} device ops summing to {summed:.3f} ms; host ops by self "
          f"time (name, ms, calls): {top}")


def check_against_cpu(label, bits, dp, ds, y0, frozen, dev):
    """One round on the card against the same round on the CPU through
    the plain versions, from the same start, batch and round key."""
    from repro_torch.bridge import from_numpy_tree, to_numpy_tree
    from repro_torch.nn import threefry
    from repro_torch.nn.basic import flatten_params
    batch, w = cohorts(ds, 1)[0]
    out = {}
    for d, y, z in ((dev, y0, frozen),
                    ("cpu", from_numpy_tree(to_numpy_tree(y0), "cpu"),
                     from_numpy_tree(to_numpy_tree(frozen), "cpu"))):
        round_fn, sopt = make_round(bits, d, dp)
        y1, _, m = round_fn(y, sopt.init(y), z, batch, w, threefry.key(0))
        out[str(torch.device(d).type)] = (
            float(m["loss"]), float(m["delta_norm"]),
            {k: v.cpu() - y0k.cpu() for (k, v), (_, y0k) in zip(
                flatten_params(y1), flatten_params(y))})
    (lg, ng, dg), (lc, nc, dc) = out["cuda"], out["cpu"]
    worst = max(float((dg[k] - dc[k]).abs().max()) for k in dg)
    step = max(float(v.abs().max()) for v in dc.values())
    if dp:
        # the noise is the same draw (erfinv's log1p and sqrt may round an
        # ulp or two apart); a client value on a rounding boundary may flip
        # by one int8 step, at most clip / 127 after the clip, which the
        # fixed denominator and server_lr shrink; allow two such steps
        tol = 2 * 0.5 * DP_CLIP / 127 / CLIENTS_PER_ROUND + 1e-6
        norm_rtol = 1e-3
    else:
        # bits 0: float reassociation only (cuDNN's and the CPU's
        # convolution orders, TF32 off), measured at ~1e-3 of max|dy| on an
        # H100, so 1e-2; bits 8: besides, a client value on a rounding
        # boundary may flip by one quantization step, which the weighted
        # mean and server_lr shrink to well under max|dy| / 127 at 10
        # clients; allow two such steps
        tol = (1e-2 * step if bits == 0 else 2 * step / 127) + 1e-7
        norm_rtol = 1e-3 if bits == 0 else 1e-2
    ok = (abs(lg - lc) <= 1e-4 * abs(lc) and abs(ng - nc) <= norm_rtol * nc
          and worst <= tol)
    print(f"  {label}, round 0, card vs CPU: loss {lg:.7f} / {lc:.7f}, "
          f"delta_norm {ng:.7f} / {nc:.7f}, max |dy| diff {worst:.3e} "
          f"(tol {tol:.3e})")
    if not ok:
        raise AssertionError(f"{label}: the card's round disagrees with "
                             f"the CPU's")


def drive_path(label, bits, dp, y0, frozen, draws, expect, dev):
    """The main path once: ROUNDS timed rounds with the launch counts set
    to 0 just before and read just after; then, for ``dp``, one round
    with a NaN client that must be quarantined, and one profiled round.
    Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.nn import threefry
    from repro_torch.nn.basic import tree_leaves
    round_fn, server_opt = make_round(bits, dev, dp)
    y, sstate = y0, server_opt.init(y0)
    losses, norms, ms = [], [], []
    kernels.reset_launches()
    for r, (batch, w) in enumerate(draws[:ROUNDS]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, sstate, m = round_fn(y, sstate, frozen, batch, w, threefry.key(r))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["delta_norm"]))
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    print(f"[main path] {label}: losses {[round(v, 4) for v in losses]}")
    print(f"  delta_norm {[round(v, 5) for v in norms]}")
    print(f"  per-round wall ms {[round(v, 3) for v in ms]} (median "
          f"{float(np.median(ms)):.3f}, first round included in the "
          f"list); launches {counts}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{label}: non-finite loss or norm")
    if not dp and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall")
    if not all(torch.isfinite(leaf).all() for leaf in tree_leaves(y)):
        raise AssertionError(f"{label}: non-finite parameters")
    check_expected(label, counts, expect)
    batch, w = draws[ROUNDS]
    if dp:
        poisoned = dict(batch, images=np.array(batch["images"], copy=True))
        poisoned["images"][POISONED] = np.nan
        y_p, _, m = round_fn(y, sstate, frozen, poisoned, w,
                             threefry.key(ROUNDS + 1))
        flagged = m["quarantine_nonfinite"].cpu().tolist()
        finite = (all(torch.isfinite(leaf).all() for leaf in tree_leaves(y_p))
                  and math.isfinite(float(m["delta_norm"])))
        print(f"  poisoned round (client {POISONED} NaN): quarantined "
              f"{flagged}, outliers {m['quarantine_outlier'].cpu().tolist()}, "
              f"finite update {finite}, delta_norm "
              f"{float(m['delta_norm']):.5f}")
        if flagged != [i == POISONED for i in range(CLIENTS_PER_ROUND)] or \
                not finite:
            raise AssertionError(f"{label}: the NaN client was not "
                                 f"quarantined cleanly")
    # one more round, under the profiler (its launches are not counted)
    profile_round(
        lambda: round_fn(y, sstate, frozen, batch, w, threefry.key(ROUNDS)))
    return counts


def check_expected(label, counts, expect):
    """Every kernel (or ``kernel/route``) in ``expect`` launched on the
    path; a path that expects a kernel's cluster route took no other."""
    for name in expect:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched "
                                 f"on its path")
    for name in expect:
        if name.endswith("/cluster"):
            kernel = name.split("/")[0]
            other = {k: v for k, v in counts.items()
                     if k.startswith(kernel + "/") and k != name and v}
            if other:
                raise AssertionError(f"{label}: {kernel} took {other}")


def leaves_of(tree):
    from repro_torch.nn.basic import flatten_params
    return [v for _, v in flatten_params(tree)]


def drive_run_federated(ds, y0, frozen, dev):
    """Path 5: ``run_federated`` on the quickstart at ``uplink_bits=0``,
    ROUNDS rounds from seed 0, with the launch counts set to 0 just before
    and read just after; its history against a plain ``make_round_fn``
    loop fed the grid's own streams (cohorts from ``default_rng(seed +
    77)``, keys ``seed * 100_003 + r``), bit for bit with cuDNN set
    deterministic for both runs. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.core import fedpt
    from repro_torch.data import synthetic as syn
    from repro_torch.fl import runtime
    from repro_torch.models import paper_models as pm
    from repro_torch.nn import threefry
    from repro_torch.sim import wire
    rc = quickstart_rc(0)
    label = "run_federated, quickstart, uplink_bits=0"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        round_fn, sopt = fedpt.make_round_fn(emnist_loss, rc, device=dev)
        y, ss = y0, sopt.init(y0)
        rng = np.random.default_rng(0 + 77)
        plain = []
        for r in range(ROUNDS):
            cids = syn.sample_cohort(rng, ds.num_clients, CLIENTS_PER_ROUND)
            batch, w = syn.cohort_batch(ds, cids, LOCAL_STEPS, LOCAL_BATCH,
                                        rng)
            y, ss, m = round_fn(y, ss, frozen, batch, w,
                                threefry.key(0 * 100_003 + r))
            plain.append(float(m["loss"]))
        kernels.reset_launches()
        res = runtime.run_federated(
            lambda seed: pm.init_emnist_cnn(seed, device=dev), emnist_loss,
            ds, rc, ROUNDS, freeze_spec=pm.EMNIST_FREEZE, seed=0, device=dev)
        counts = dict(kernels.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    losses = [h["loss"] for h in res.history]
    print(f"[main path] {label}: losses {[round(v, 4) for v in losses]}")
    print(f"  seconds_per_round (synchronized) "
          f"{1e3 * res.seconds_per_round:.3f} ms; launches {counts}")
    same = losses == plain and all(torch.equal(a, b) for a, b in zip(
        leaves_of(res.y), leaves_of(y)))
    print(f"  against the plain loop fed the grid's streams, "
          f"torch.backends.cudnn.deterministic=True: bit for bit {same}")
    if not same:
        raise AssertionError(f"{label}: history differs from the plain loop")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses not finite or not falling")
    down, up = wire.downlink_bytes(res.y), wire.uplink_bytes(res.y, 0)
    n = res.comm.transfers
    print(f"  comm: {n} transfers, measured down {res.comm.measured_down_bytes}"
          f" B = {n} x {down}, up {res.comm.measured_up_bytes} B = {n} x {up}")
    if n != ROUNDS * CLIENTS_PER_ROUND or (
            res.comm.measured_down_bytes, res.comm.measured_up_bytes) != (
                n * down, n * up):
        raise AssertionError(f"{label}: measured bytes off the payloads")
    if counts["sumsq"] <= 0:
        raise AssertionError(f"{label}: kernel sumsq was not launched")
    return counts


def emnist_async():
    """The async path's task: the quickstart's EMNIST CNN at int8 with
    per-flush DP, its data, and the kernels (and routes) its lane must
    launch."""
    from repro_torch.data import synthetic as syn
    from repro_torch.models import paper_models as pm
    return dict(label="async FedBuff, int8 + per-flush DP", loss_fn=emnist_loss,
                rc=quickstart_rc(8, dp=True), spec=pm.EMNIST_FREEZE,
                kind="images", batch_fn=syn.client_batch_images,
                init=pm.init_emnist_cnn,
                expect=("clip_flat", "clip_flat/cluster", "fake_quantize_flat",
                        "fake_quantize_flat/cluster"))


def async_run(ds, init, updates, dev, task=None):
    """The async FedBuff grid with per-flush DP at int8, ``updates``
    server updates from seed 0, on ``task`` (:func:`emnist_async` by
    default; its ``grid`` entry adds GridConfig fields)."""
    from repro_torch.sim import grid
    task = task or emnist_async()
    gc = grid.GridConfig(mode="async", fleet="pareto-mobile",
                         concurrency=CONCURRENCY, goal_count=GOAL,
                         staleness="polynomial", **task.get("grid", {}))
    return grid.run_grid(init, task["loss_fn"], ds, task["rc"], updates,
                         grid=gc, freeze_spec=task["spec"], seed=0,
                         data_kind=task["kind"], device=dev)


def edge_view(res):
    """A run's topology side: the per-hop ledger, the edge and region
    counters by region, and the shocks its trace recorded."""
    counters = {name: dict(res.metrics.counter(name).labels) for name in
                ("edge_flushes", "edge_up_bytes", "edge_down_bytes",
                 "region_dispatches", "region_uploads")}
    shocks = ([(e.t, dict(e.payload)) for e in res.telemetry.events
               if e.kind == "shock"] if res.telemetry is not None else [])
    return res.comm.hop_traffic, counters, shocks


def check_async_against_cpu(ds, dev, task=None):
    """The async path's first ASYNC_CHECKED updates on the card against
    the same run on the CPU through the plain versions, from the same
    parameters: the host side equal (clock, staleness, scheduler stats,
    bytes, DP summary, under a plan ``tier_stats``, under a topology the
    hop ledger, edge counters and shocks, :func:`edge_view`), the losses
    within rel 1e-4, and y within the DP bound below, or, without DP, the
    update by norm within UPDATE_NORM_REL (the int8 flips, unbounded a
    priori without the clip, and the convolutions' float orders)."""
    from repro_torch.bridge import from_numpy_tree, to_numpy_tree
    task = task or emnist_async()
    host = to_numpy_tree(task["init"](0, device=dev))
    card = async_run(ds, lambda s: task["init"](s, device=dev),
                     ASYNC_CHECKED, dev, task)
    cpu = async_run(ds, lambda s: from_numpy_tree(host, "cpu"),
                    ASYNC_CHECKED, "cpu", task)
    exact = (len(card.history) == len(cpu.history) == ASYNC_CHECKED
             and all({k: v for k, v in a.items()
                      if k not in ("loss", "delta_norm")}
                     == {k: v for k, v in b.items()
                         if k not in ("loss", "delta_norm")}
                     for a, b in zip(card.history, cpu.history))
             and card.virtual_seconds == cpu.virtual_seconds
             and card.scheduler_stats == cpu.scheduler_stats
             and card.dp == cpu.dp
             and card.tier_stats == cpu.tier_stats
             and edge_view(card) == edge_view(cpu)
             and (card.comm.measured_down_bytes, card.comm.measured_up_bytes,
                  card.comm.transfers)
             == (cpu.comm.measured_down_bytes, cpu.comm.measured_up_bytes,
                 cpu.comm.transfers))
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(card.history, cpu.history))
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        leaves_of(card.y), leaves_of(cpu.y)))
    # the same noise draw (threefry bits equal; erfinv's log1p and sqrt
    # may round an ulp apart); a client value on an int8 rounding boundary
    # may flip by one step, at most clip / 127 once clipped (the step is
    # the leaf's max|x| / 127 <= ||x|| / 127, times min(1, clip / ||x||)),
    # which the fixed goal_count denominator and server_lr shrink; allow
    # two such steps per flush
    if task["rc"].dp_clip_norm > 0:
        tol = (ASYNC_CHECKED * 2 * task["rc"].server_lr * DP_CLIP / 127
               / GOAL + 1e-6)
        close, held = worst <= tol, f"tol {tol:.3e}"
    else:
        from repro_torch.core import partition as part
        y0, _ = part.partition(from_numpy_tree(host, "cpu"), task["spec"])
        gap, step = update_gap(y0, card.y, cpu.y)
        close = gap <= UPDATE_NORM_REL * step
        held = (f"||dy diff|| / ||dy|| {gap / step:.3e}, tol "
                f"{UPDATE_NORM_REL:.0e}")
    print(f"  async, first {ASYNC_CHECKED} updates, card vs CPU: virtual "
          f"clock / staleness / scheduler stats / bytes / DP summary"
          f"{' / tier_stats' if card.tier_stats else ''}"
          f"{' / hops, edge counters, shocks' if card.topology else ''} "
          f"equal {exact}; loss "
          f"rel {loss_rel:.3e} (tol 1e-4), max |y| diff {worst:.3e} "
          f"({held}); virtual seconds {card.virtual_seconds:.6f} / "
          f"{cpu.virtual_seconds:.6f}")
    if not (exact and loss_rel <= 1e-4 and close):
        raise AssertionError(f"{task['label']}: the card's run disagrees "
                             f"with the CPU's")
    if "signal_rel" in task:
        check_async_signal(ds, host, dev, task)


def check_async_signal(ds, host, dev, task):
    """The lane's signal, card against CPU: the first ASYNC_CHECKED
    updates again without the flush's noise, so that the updates are the
    clipped, int8 Q->DQ'd lanes alone, held by norm as the sync rounds on
    the model are, ||dy_card - dy_cpu|| <= task["signal_rel"] ||dy_cpu||.
    With the noise, the bound above is the noise's: on a wide lane one
    clipped update moves an element far less than clip / 127, and a
    zeroed lane would pass it."""
    import dataclasses
    from repro_torch.bridge import from_numpy_tree
    from repro_torch.core import partition as part
    quiet = {**task, "rc": dataclasses.replace(task["rc"],
                                               dp_noise_multiplier=0.0)}
    card = async_run(ds, lambda s: from_numpy_tree(host, dev),
                     ASYNC_CHECKED, dev, quiet)
    cpu = async_run(ds, lambda s: from_numpy_tree(host, "cpu"),
                    ASYNC_CHECKED, "cpu", quiet)
    y0, _ = part.partition(from_numpy_tree(host, "cpu"), task["spec"])
    gap, step = update_gap(y0, card.y, cpu.y)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(card.history, cpu.history))
    print(f"  async without the flush's noise, first {ASYNC_CHECKED} "
          f"updates, card vs CPU: ||dy|| {step:.4e}, ||dy diff|| / ||dy|| "
          f"{gap / step:.3e} (tol {task['signal_rel']:.0e}), loss rel "
          f"{loss_rel:.3e} (tol 1e-4)")
    if not (gap <= task["signal_rel"] * step and loss_rel <= 1e-4):
        raise AssertionError(f"{task['label']}: the card's lanes disagree "
                             f"with the CPU's")


def drive_async_dp(ds, dev, task=None):
    """The async grid, FedBuff with per-flush DP at int8, ASYNC_UPDATES
    server updates, with the launch counts set to 0 just before and read
    just after; then the card against the CPU, and the lane step and the
    buffered apply timed, one flush profiled. Path 6 on the EMNIST CNN
    (the default ``task``), and the SO transformer's lane. Returns the
    launch counts."""
    from repro_torch import kernels
    from repro_torch.core import dp as dp_lib, fedpt
    from repro_torch.nn import threefry
    task = task or emnist_async()
    label, rc = task["label"], task["rc"]
    init = lambda s: task["init"](s, device=dev)  # noqa: E731
    kernels.reset_launches()
    with tail_route_spy() as routes:
        res = async_run(ds, init, ASYNC_UPDATES, dev, task)
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    losses = [h["loss"] for h in res.history]
    norms = [h["delta_norm"] for h in res.history]
    print(f"[main path] {label}: losses {[round(v, 4) for v in losses]}")
    print(f"  delta_norm {[round(v, 5) for v in norms]}")
    print(f"  staleness_max {[h['staleness_max'] for h in res.history]}, "
          f"virtual seconds {res.virtual_seconds:.4f}, stats "
          f"{res.scheduler_stats}, dp {res.dp}")
    print(f"  seconds_per_round (per update, synchronized) "
          f"{1e3 * res.seconds_per_round:.3f} ms; launches {counts}; "
          f"server tail routes {dict(routes)}")
    sigma = DP_NOISE * DP_CLIP / GOAL
    if len(res.history) != ASYNC_UPDATES or not all(
            math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{label}: wrong record count or non-finite")
    if (res.dp["flushes"], res.dp["sigma"]) != (ASYNC_UPDATES, sigma) or \
            not math.isfinite(res.dp["epsilon"]):
        raise AssertionError(f"{label}: DP summary {res.dp}")
    check_expected(label, counts, task["expect"])
    check_async_against_cpu(ds, dev, task)

    # the two device steps of a flush, alone, at the path's shapes
    y, frozen = res.y, res.frozen
    lane_step = fedpt.make_lane_step(task["loss_fn"], rc, GOAL, device=dev)
    apply_fn = fedpt.make_buffered_apply(
        fedpt.resolve_server_opt(rc),
        flush_dp=dp_lib.FlushDPConfig(DP_CLIP, DP_NOISE, GOAL), device=dev)
    rng = np.random.default_rng(5)
    batches = [task["batch_fn"](ds, c, rc.local_steps, rc.local_batch,
                                rng)[0] for c in range(GOAL)]
    lane = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    w = np.full(GOAL, 0.7, np.float32)
    sstate = fedpt.resolve_server_opt(rc).init(y)
    rows, _ = lane_step(y, frozen, lane)

    lane_ms = wall_ms(lambda: lane_step(y, frozen, lane))
    apply_ms = wall_ms(lambda: apply_fn(y, sstate, rows, w,
                                        threefry.key(7)))
    print(f"  lane step ({GOAL} clients) {lane_ms:.3f} ms, buffered apply "
          f"({GOAL}, {rows.shape[1]}) {apply_ms:.3f} ms (wall, median of "
          f"10, synchronized)")
    profile_round(lambda: apply_fn(y, sstate, lane_step(y, frozen, lane)[0],
                                   w, threefry.key(7)),
                  "flush (one lane step + the apply)")
    return counts


def wall_ms(fn, iters=10):
    """Median host wall (ms) of ``iters`` synchronized calls of ``fn``,
    after one warm-up call."""
    fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def tail_routes(layouts, dev):
    """Staged against fused at both buffer sizes, for variant A's and B's
    pipelines (the arguments the round engine passes): wall ms per call
    (CUDA events over back-to-back calls) and device ms; and the noise
    draw alone at each size. Checks that the default route at the FedAvg
    size is the fused CUDA one."""
    from repro_torch.core import flat as flat_lib, sanitize
    from repro_torch.kernels import ops
    from repro_torch.nn import threefry
    gen = torch.Generator(device="cpu").manual_seed(3)
    K = CLIENTS_PER_ROUND
    sigma = DP_NOISE * DP_CLIP / K
    pipelines = {
        "A": dict(bits=8),
        "B": dict(bits=8, clip_norm=DP_CLIP, uniform=True, wsum_fixed=float(K),
                  sigma=sigma, rng=threefry.key(0),
                  screen=sanitize.SanitizeConfig()),
    }
    for lname, layout in layouts:
        mat = (torch.randn((K, layout.size), generator=gen) * 1e-2).to(dev)
        w = torch.full((K,), 50.0, device=dev)
        kw0 = dict(block_leaf=layout.block_leaf(), n_leaves=len(layout.sizes))
        for pname, pkw in pipelines.items():
            _, info = ops.agg_tail(mat, w, **kw0, **pkw)
            res = {}
            for route, thr in (("staged", 1 << 60), ("fused", 0)):
                def call(thr=thr):
                    return ops.agg_tail(mat, w, threshold=thr, **kw0, **pkw)
                res[route] = (time_ms(call, iters=50), device_ms(call))
            print(f"[tail] {lname} ({K}, {layout.size}), pipeline {pname}: "
                  f"staged {res['staged'][0]:.4f} ms (device "
                  f"{fmt_ms(res['staged'][1])}), fused {res['fused'][0]:.4f} "
                  f"ms (device {fmt_ms(res['fused'][1])}); default route "
                  f"{info['route']}")
            if lname == "FedAvg" and info["route"] != (
                    "fused/cuda/exact" if pname == "A" else "fused/cuda/coeff"):
                raise AssertionError(f"pipeline {pname} at the FedAvg size "
                                     f"took {info['route']}")

        def draw(n=layout.size):
            return flat_lib.draw_noise(threefry.key(0), n, sigma, dev)
        print(f"[tail] noise draw alone, {layout.size} floats: "
              f"{time_ms(draw, iters=50):.4f} ms (device "
              f"{fmt_ms(device_ms(draw))})")


# --- the serving path: Mistral-NeMo-12B at full width ------------------------

NEMO = "mistral-nemo-12b"
NEMO_LAYERS = 4            # of 40: depth cut to fit the run's time
PREFILL_LEN = 32768        # prefill_32k's length; its batch of 32 cut to 1
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = 4, 8, 32   # serve.py's defaults
CONSIST_LEN = 512
# (trainable, frozen) parameters of the 4 layers at full width
NEMO_SPLIT = (1_551_938_560, 880_803_840)
BF16_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
# the windowed prefill's attention must take less than this share of the
# causal one's kernel time: its visible pairs are 0.44 of the causal's, so
# only a structural skip of the tiles outside the window passes
WINDOW_GATE = 0.8
# kernel vs plain on the card. swa_attention (float32-p mode): the kernel
# rounds its float32 result to bf16 once (half a bf16 ulp, 2**-8 of the value
# at most); the two float32 computations differ by ~1e-6 (other summation
# orders, and p.v on the tensor cores as p_hi.v + p_lo.v, p within 2**-16 of
# its float32 value), covered by the absolute 1e-5. Its round-once mode is
# held to swa_attention.round_p_tolerance (bound (i)). seed_reconstruct: the
# same float32
# uniforms through CUDA's logf / cosf against torch's log / cos (each within
# 2 ulps of exact), a sqrt and two multiplies: 8 ulps.
SWA_REL, SWA_ABS, SEED_ULPS = 2.0 ** -8, 1e-5, 8
MIXTRAL_WINDOW = 4096      # Mixtral-8x7B's own sliding window
# the serving path's logits against its plain forms, relative to the largest
# |logit|: bf16 compute through 4 layers, where the plain attention rounds p
# to bf16 at the running max of 512-key chunks (the kernel at 64-key tiles)
# and a one-token decode step's GEMVs round other partial sums than the
# prefill's GEMMs; each bf16 rounding is 2**-9 relative and a layer adds a
# few of them to the residual stream
LOGIT_REL = 2.0 ** -4


def card_normal(shape, gen, dev, dtype=torch.bfloat16):
    """N(0, 1) of ``shape`` in ``dtype``, drawn on ``dev`` from a generator
    seeded by the host generator ``gen`` (a draw of 10**9 elements on the
    host took seconds)."""
    seed = int(torch.randint(2 ** 62, (1,), generator=gen))
    card = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=card, device=dev, dtype=dtype)


def swa_inputs(shape, kv_heads, gen, dev, layout_bshd=False):
    """q (B, H, S, D), k and v (B, KVH, S, D), bf16 N(0, 1) from ``gen``;
    as transposed views of (B, S, H, D) tensors, the model's layout, when
    ``layout_bshd``."""
    B, H, S, D = shape

    def one(h):
        x = card_normal((B, S, h, D), gen, dev)
        return x.transpose(1, 2) if layout_bshd else x.transpose(1, 2).contiguous()
    return one(H), one(kv_heads), one(kv_heads)


def kernel_label(mangled: str, marker: str) -> str:
    """``swa_kernel_tc<bf16, 192, 128, round-p>`` for a mangled entry
    function name holding ``marker``: its name and (dtype, DK, DV, mode)
    template arguments."""
    names = {"_nv_bfloat16": "bf16", "__half": "fp16", "If": "f32"}
    ty = next((v for k, v in names.items() if k in mangled), "?")
    dims = ", ".join(re.findall(r"Li(\d+)E", mangled))
    mode = {"Lb1E": ", round-p", "Lb0E": ", float32-p"}
    name = re.search(marker + r"\w*?(?=I)", mangled).group(0)
    return (f"{name}<{ty}, {dims}"
            f"{next((v for k, v in mode.items() if k in mangled), '')}>")


def ptxas_summary(log: str, marker: str):
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from ``nvcc -Xptxas -v`` output, for the entry functions whose mangled
    name holds ``marker``."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if marker in line else None
            spills = "spills not reported"
        elif current and "spill" in line:
            spills = line.strip()
        elif current and "registers" in line:
            out[kernel_label(current, marker)] = (
                line.split("Used ")[1].split(",")[0] + "; " + spills)
            current = None
    return out


def sass_counts(lib_path, marker: str, ops=("HGMMA", "UTMALDG")):
    """{kernel: {op: count}} of the SASS instructions ``ops`` (wgmma, TMA
    load) in each entry function of the built library whose name holds
    ``marker``, from ``cuobjdump -sass``; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if marker in name:
            out[kernel_label(name, marker)] = {op: fn.count(op) for op in ops}
    return out


def sass_totals(lib_path, marker: str):
    """{kernel: (all, main)} SASS instruction counts of each entry function
    of the built library whose name holds ``marker``, from ``cuobjdump
    -sass``: ``all`` every instruction of the function once, paths not
    taken included; ``main`` those before its first unpredicated EXIT, the
    straight-line body a thread runs when no slow path (a huge argument
    of cosf, a 64-bit division by a large divisor, ...) is taken: what
    one thread issues on the common path. None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if marker in name:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn)
            main = next((i for i, op in enumerate(ops)
                         if op.split()[0] == "EXIT"), len(ops))
            out[name] = (len(ops), main)
    return out


# the H100 SXM's instruction issue: 132 SMs x 4 schedulers, one warp
# instruction (32 lanes) a clock each
LANE_ISSUE_PER_CLOCK = 132 * 4 * 32


def seed_issue(sr, build, dev) -> dict:
    """The seed kernel's issue-rate estimate at SEED_SHAPE float32, for the
    package whose modules ``sr`` (seed_reconstruct) and ``build`` (_build)
    are: the SM clock the card holds over 3000 calls back to back, and per
    kernel instance its SASS counts (all, common path), the common path's
    instructions per element (a thread writes ``seed_plan``'s run, or one
    element where the tree has no plan) and that times the elements over
    the lanes the card issues at that clock."""
    rows, cols = SEED_SHAPE
    ms, clock, watts = clock_power(lambda: sr.seed_reconstruct(
        42, 7, SEED_SHAPE, 0.02, device=dev), 3000)
    out = {"ms_a_call": ms, "sm_clock_mhz": clock, "power_w": watts}
    sass = sass_totals(build.library_path("seed_reconstruct.cu"),
                       "seed_kernel") or {}
    for name, (total, main) in sass.items():
        itemsize = 2 if "bfloat16" in name else 4
        run = (sr.seed_plan(rows, cols, itemsize)[0]
               if hasattr(sr, "seed_plan") else 1)
        out[name] = {
            "all": total, "common_path": main, "per_element": main / run,
            "estimate_ms": (None if clock is None else main / run * rows
                            * cols / (LANE_ISSUE_PER_CLOCK * clock) / 1e3)}
    return out


def clock_power(fn, iters: int):
    """(ms per call, median SM clock in MHz, median board power in W) over
    ``iters`` back-to-back calls of ``fn``, with nvidia-smi sampling the
    card every 100 ms; a card held at its power limit lowers its clock."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    rows = []
    reader = threading.Thread(target=lambda: rows.extend(smi.stdout))
    reader.start()
    try:
        ms = time_ms(fn, iters, 0)
    finally:
        smi.terminate()
        smi.wait()
        reader.join()
    vals = [[float(x) for x in r.split(",")] for r in rows if r.strip()]
    vals = vals[len(vals) // 4:] or vals   # past the ramp
    if not vals:
        return ms, None, None
    return (ms, float(np.median([v[0] for v in vals])),
            float(np.median([v[1] for v in vals])))


def recorded_launches(fn, name: str, iters: int) -> int:
    """Launches of the named CUDA kernel that the profiler records over
    ``iters`` calls of ``fn`` (one each)."""
    return sum(ev.count for ev in profiled_calls(fn, iters) if name in ev.key)


def swa_where(q, k, v, window, causal=True, prefix_len=0) -> str:
    """``((1, 32, 4096), DK 128 / DV 128, bfloat16, 8 kv heads, window
    0)``: the shape and window a swa_attention check names (and the keys,
    the mask and the prefix where they are not the causal default)."""
    more = "" if k.shape[2] == q.shape[2] else f", {k.shape[2]} keys"
    more += "" if causal else ", non-causal"
    more += f", prefix {prefix_len}" if prefix_len else ""
    return (f"({tuple(q.shape[:3])}, DK {q.shape[3]} / DV {v.shape[3]}, "
            f"{str(q.dtype)[6:]}, {k.shape[1]} kv heads, window "
            f"{window}{more})")


def check_swa(q, k, v, window, causal=True, prefix_len=0):
    """swa_attention's float32-p mode within SWA_REL (2**-20 in float32)
    relative + SWA_ABS of ``ref.swa_attention_ref``, in q's dtype and
    (B, H, Sq, DV) shape, and the same bits twice."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    kw = dict(window=window, causal=causal, prefix_len=prefix_len)
    got = swa.swa_attention(q, k, v, **kw)
    want = ref.swa_attention_ref(q, k, v, window, causal,
                                 prefix_len=prefix_len)
    rel = 2.0 ** -20 if q.dtype == torch.float32 else SWA_REL
    err = (got.float() - want).abs()
    worst = float((err / (rel * want.abs() + SWA_ABS)).max())
    del want
    where = swa_where(q, k, v, window, causal, prefix_len)
    if (got.dtype != q.dtype or got.shape != q.shape[:3] + v.shape[3:]
            or worst > 1.0):
        raise AssertionError(f"swa_attention off its plain version "
                             f"{where}: max err {float(err.max())}, "
                             f"{worst:.3f} of the tolerance")
    if not same_bits(swa.swa_attention(q, k, v, **kw), got):
        raise AssertionError(f"swa_attention differs between two runs "
                             f"{where}")
    print(f"  swa_attention == plain within 2**{int(math.log2(rel))} rel + "
          f"{SWA_ABS} (max "
          f"err {float(err.max()):.3e}, {worst:.3f} of the tolerance), same "
          f"bits twice {where}")


def check_swa_round_p(q, k, v, window, want=None, causal=True,
                      prefix_len=0):
    """swa_attention's round-once mode within bound (i)
    (``swa.round_p_tolerance``) of ``want``, by default
    ``ref.chunked_attention_ref(..., chunk=64)`` computed here, closer to it
    by RMS than the float32-p mode (by half at least), and the same bits
    twice."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    kw = dict(window=window, causal=causal, prefix_len=prefix_len)
    got = swa.swa_attention(q, k, v, round_p=True, **kw)
    if want is None:
        want = ref.chunked_attention_ref(q, k, v, window, causal,
                                         chunk=swa.BK, prefix_len=prefix_len)
    tol = swa.round_p_tolerance(q, k, v, window, causal, got, want,
                                prefix_len=prefix_len)
    err = (got.float() - want.float()).abs()
    worst = float((err / tol).max())
    del tol
    where = swa_where(q, k, v, window, causal, prefix_len)
    if (got.dtype != q.dtype or got.shape != q.shape[:3] + v.shape[3:]
            or worst > 1.0):
        raise AssertionError(f"swa_attention round_p off its plain version "
                             f"{where}: max err {float(err.max())}, "
                             f"{worst:.3f} of bound (i)")
    rms = [float((a.float() - want.float()).pow(2).mean().sqrt())
           for a in (got, swa.swa_attention(q, k, v, **kw))]
    if not rms[0] < 0.5 * rms[1]:
        raise AssertionError(f"swa_attention round_p is not closer to the "
                             f"round-once oracle than the float32-p mode "
                             f"{where}: RMS {rms}")
    if not same_bits(swa.swa_attention(q, k, v, round_p=True, **kw), got):
        raise AssertionError(f"swa_attention round_p differs between two "
                             f"runs {where}")
    print(f"  swa_attention round_p == chunked_attention_ref(chunk=64) "
          f"within bound (i) (max err {float(err.max()):.3e}, "
          f"{worst:.3f} of the bound); RMS to it {rms[0]:.3e} against "
          f"the float32-p mode's {rms[1]:.3e}; same bits twice {where}")


def check_serving_kernels(dev, build_logs):
    """Phase 2, the serving path's kernels: swa_attention against its plain
    version at (1, 32, 4096, 128) bf16 with GQA rep 4, windows 0 and
    1,000, at a ragged S = 4,000, and at the prefill's (1, 32, 32768, 128)
    in its (B, S, H, D) layout under windows 0 and 8192, there also in its
    round-once mode against ``ref.chunked_attention_ref(..., chunk=64)``;
    seed_reconstruct at NeMo's frozen FFN leaf (5120, 14336) and a ragged
    (300, 200), its hash words bit for bit and its Gaussians within
    SEED_ULPS in float32 (one bf16 ulp in bf16), one launch a call.
    Returns their records, timed at the prefill's shape (1, 32, 32768,
    128) causal (swa_attention in the round-once mode the serving path
    launches; its plain version run and timed once, as the check's
    oracle) and at (5120, 14336) in float32 (bf16 printed beside it).
    Prints the attention kernels' registers and spills (``build_logs``:
    this run's ``-Xptxas -v`` output) and the round-once mode at
    Mixtral's window. The float32-p mode's times, the window 8192's, the
    achieved TFLOP/s, the clock under load, the windowed library call and
    the SASS counts are :func:`attention_times`' (``--kernel-times``)."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels import seed_reconstruct as sr
    from repro_torch.kernels import swa_attention as swa

    gen = torch.Generator(device="cpu").manual_seed(6)
    for S in (4096, 4000):
        q, k, v = swa_inputs((1, 32, S, 128), 8, gen, dev)
        for window in (0, 1000):
            check_swa(q, k, v, window)
    for shape in (SEED_SHAPE, (300, 200)):
        rows, cols = ref.seed_dims(shape)
        b1, b2 = sr.seed_bits(42, 7, shape, device=dev)
        w1, w2 = ref.seed_bits_plain(42, 7, rows, cols, device=dev)
        if not (torch.equal(b1, w1) and torch.equal(b2, w2)):
            raise AssertionError(f"seed_reconstruct's hash words differ from "
                                 f"the plain version's at {shape}")
        del b1, b2, w1, w2
        # float32 within SEED_ULPS; bf16 (the frozen leaves' type) within
        # one bf16 ulp, as SEED_ULPS float32 ulps may cross a rounding
        for dtype, bound_ulps in ((torch.float32, SEED_ULPS),
                                  (torch.bfloat16, 1 << 16)):
            kernels.reset_launches()
            got = sr.seed_reconstruct(42, 7, shape, 0.02, dtype=dtype,
                                      device=dev)
            if kernels.LAUNCHES["seed_reconstruct"] != 1:
                raise AssertionError("seed_reconstruct: not one launch a call")
            want = ref.seed_reconstruct_plain(42, 7, shape, 0.02, dtype=dtype,
                                              device=dev)
            ulps = int((got.float().view(torch.int32).long()
                        - want.float().view(torch.int32).long()).abs().max())
            if ulps > bound_ulps:
                raise AssertionError(f"seed_reconstruct {ulps} float32 ulps "
                                     f"off the plain version at {shape} "
                                     f"{dtype}")
            print(f"  seed_reconstruct: hash words bit for bit, Gaussians "
                  f"within {ulps} float32 ulps (bound {bound_ulps}) of plain "
                  f"{shape} {dtype}, one launch")
            del got, want

    src = "src/repro_torch/kernels/csrc/"
    if "swa_attention.cu" in build_logs:
        for name, info in ptxas_summary(build_logs["swa_attention.cu"],
                                        "swa_kernel").items():
            print(f"  ptxas {name}: {info}")
    else:
        print("  ptxas: not measured (swa_attention.cu built before this run)")
    # dynamic shared memory of the bf16 kernel at D = 128 (launch_tc): q
    # (128 x 128 bf16), three K and three V stages (64 x 128), 13 mbarriers,
    # 1024 bytes to align
    smem = (swa.BQ + 6 * swa.BK) * 128 * 2 + 13 * 8 + 1024
    print(f"  swa_kernel_tc<bf16, 128>: {smem} bytes of dynamic shared "
          f"memory, 384 threads, 1 block per SM")
    # the prefill's own shape and layout, under both of its windows and
    # Mixtral's; each plain round-once version run once, timed, and held
    # against the kernel (the causal one is the record's plain version)
    q, k, v = swa_inputs((1, 32, PREFILL_LEN, 128), 8, gen, dev,
                         layout_bshd=True)
    plain = {}
    for window in (0, 8192, MIXTRAL_WINDOW):
        if window != MIXTRAL_WINDOW:
            check_swa(q, k, v, window)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref.chunked_attention_ref(q, k, v, window, chunk=swa.BK)
        torch.cuda.synchronize()
        plain[window] = (time.perf_counter() - t0) * 1e3
        check_swa_round_p(q, k, v, window, want)
        if window == 0:
            want0 = want
        del want
    pairs = swa.visible_pairs(PREFILL_LEN, 0)
    nbytes = sum(t.numel() for t in (q, k, v, q)) * 2
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # the record: the round-once mode, which the serving path launches
    def round_p(window=0):
        return swa.swa_attention(q, k, v, window=window, round_p=True)
    rec_swa = kernel_records([
        ("swa_attention", src + "swa_attention.cu",
         "src/repro/kernels/swa_attention.py:83", round_p, (want0, plain[0]),
         lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
         ("swa_kernel",), nbytes, 4 * 32 * 128 * pairs)],
        iters=(10, 1, 10), warmup=1, ops_per_s=BF16_OPS_PER_S)
    del want0
    print(f"  swa_attention at (1, 32, {PREFILL_LEN}, 128) causal: round-once "
          f"wrapper {rec_swa[0]['ms']:.3f} ms, device "
          f"{fmt_ms(rec_swa[0]['device_ms'])} ms, plain {plain[0]:.3f} ms; "
          f"scaled_dot_product_attention {rec_swa[0]['library_ms']:.3f} ms "
          f"(device {fmt_ms(rec_swa[0]['library_device_ms'])} ms)")
    mpairs = swa.visible_pairs(PREFILL_LEN, MIXTRAL_WINDOW)
    mb = bound(nbytes, 4 * 32 * 128 * mpairs, BF16_OPS_PER_S)
    mms = time_ms(lambda: round_p(MIXTRAL_WINDOW), 10, 2)
    mdev = device_ms(lambda: round_p(MIXTRAL_WINDOW), ("swa_kernel",), 10)
    print(f"  swa_attention (round-once) at (1, 32, {PREFILL_LEN}, 128), "
          f"window {MIXTRAL_WINDOW} (Mixtral's): wrapper {mms:.3f} ms, device "
          f"{fmt_ms(mdev)} ms, bound {mb[0]:.3f} ms ({mb[1]}; {mpairs} of "
          f"{pairs} pairs), plain {plain[MIXTRAL_WINDOW]:.3f} ms; window "
          f"8192's plain {plain[8192]:.3f} ms")
    del q, k, v
    rows, cols = SEED_SHAPE

    def seed_spec(dtype):
        return ("seed_reconstruct", src + "seed_reconstruct.cu",
                "src/repro/kernels/seed_reconstruct.py:77",
                lambda: sr.seed_reconstruct(42, 7, SEED_SHAPE, 0.02,
                                            dtype=dtype, device=dev),
                lambda: ref.seed_reconstruct_plain(42, 7, SEED_SHAPE, 0.02,
                                                   dtype=dtype, device=dev),
                None, AB_KERNELS["seed_reconstruct"],
                dtype.itemsize * rows * cols, 32 * rows * cols)
    rec_seed = kernel_records([seed_spec(torch.float32)], iters=(50, 5, 20))
    bf16, = kernel_records([seed_spec(torch.bfloat16)], iters=(50, 5, 20))
    print(f"  seed_reconstruct at {SEED_SHAPE} bf16: wrapper "
          f"{bf16['ms']:.5f} ms, device {fmt_ms(bf16['device_ms'])} ms, "
          f"plain {bf16['plain_ms']:.5f} ms, bound {bf16['bound_ms']:.6f} ms "
          f"({bf16['bound_by']}), max abs err {bf16['max_abs_err']:.3e}")
    return rec_swa + rec_seed


def attention_times(dev):
    """``--kernel-times``: the attention kernel's times beside the default
    run's records, through the package on ``sys.path``: at the prefill's
    (1, 32, 32768, 128) the float32-p mode causal and both modes at window
    8,192 (wrapper and device ms, the bound), the achieved TFLOP/s of
    each (by the visible pairs and by the tiles issued), the launches the
    profiler records, each mode and ``scaled_dot_product_attention`` under
    sustained load with the clock and power, SDPA with the window as a
    (1, 1, S, S) boolean mask, and the kernel's SASS counts; at MLA's (1,
    128, 32768, 192 / 128) the float32-p mode and SDPA's backends."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device="cpu").manual_seed(6)
    q, k, v = swa_inputs((1, 32, PREFILL_LEN, 128), 8, gen, dev,
                         layout_bshd=True)
    pairs = swa.visible_pairs(PREFILL_LEN, 0)
    nbytes = sum(t.numel() for t in (q, k, v, q)) * 2
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def round_p(window=0):
        return swa.swa_attention(q, k, v, window=window, round_p=True)

    def f32p(window=0):
        return swa.swa_attention(q, k, v, window=window)
    dev_ms = {}
    for label, fn in (("round-once", round_p), ("float32-p", f32p)):
        for window in (0, 8192):
            wb = bound(nbytes, 4 * 32 * 128 * swa.visible_pairs(
                PREFILL_LEN, window), BF16_OPS_PER_S)
            wms = time_ms(lambda: fn(window), 10, 2)
            dev_ms[label, window] = device_ms(lambda: fn(window),
                                              ("swa_kernel",), 10)
            print(f"  swa_attention ({label}) at (1, 32, {PREFILL_LEN}, 128),"
                  f" window {window}: wrapper {wms:.3f} ms, device "
                  f"{fmt_ms(dev_ms[label, window])} ms, bound {wb[0]:.3f} ms "
                  f"({wb[1]})")
    # achieved rates: by the bound's count (4 D per visible pair) and by
    # what the kernel issues per pair of every 64-row x BK-key tile, each of
    # a block's two warpgroups computing all of the block's tiles: 4 D
    # (q.k, p.v) round-once, 6 D (q.k, p_hi.v, p_lo.v) float32-p
    for (mode, window), ms in dev_ms.items():
        if ms is None:
            print(f"  swa_attention TFLOP/s ({mode}, window {window}): not "
                  f"measured")
            continue
        flops = 4 if mode == "round-once" else 6
        tiles = 2 * sum(last - first + 1 for first, last, _ in
                        swa.tile_plan(PREFILL_LEN, window, True))
        vis = 4 * 128 * 32 * swa.visible_pairs(PREFILL_LEN, window)
        issued = flops * 128 * 32 * tiles * 64 * swa.BK
        print(f"  swa_attention TFLOP/s ({mode}, window {window}, device "
              f"{ms:.3f} ms): {vis / ms / 1e9:.1f} by 4 D per visible pair "
              f"({vis / 1e12:.3f} TFLOP), {issued / ms / 1e9:.1f} issued "
              f"({issued / 1e12:.3f} TFLOP, {flops} D per pair of {tiles} "
              f"warpgroup tiles a head); bf16 peak 989")
    for label, fn in (("round-once causal", round_p),
                      ("round-once window 8192", lambda: round_p(8192))):
        n = recorded_launches(fn, "swa_kernel", 10)
        print(f"  profiler: recorded {n} of 10 launches of swa_kernel "
              f"({label})")
    # under sustained load the kernel and SDPA run at the card's power limit
    for label, fn, iters in (
            ("swa_attention round-once causal", round_p, 20),
            ("swa_attention float32-p causal", f32p, 20),
            ("scaled_dot_product_attention causal",
             lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 40)):
        ms, clock, watts = clock_power(fn, iters)
        print(f"  {label}, {iters} calls back to back: {ms:.3f} ms a call, "
              f"median SM clock {fmt_ms(clock)} MHz, median power "
              f"{fmt_ms(watts)} W")
    # the windowed library call: SDPA with a (1, 1, S, S) boolean window
    # mask and k, v repeated to 32 heads, all built before the timed calls
    try:
        pos = torch.arange(PREFILL_LEN, device=dev)
        wmask = ((pos[:, None] >= pos[None, :])
                 & (pos[:, None] - pos[None, :] < 8192))[None, None]
        kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
        lib_w = time_ms(lambda: sdpa(q, kr, vr, attn_mask=wmask), 3, 1)
        print(f"  scaled_dot_product_attention, window 8192 as a (1, 1, S, S) "
              f"bool mask: {lib_w:.3f} ms")
        del wmask, kr, vr
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        print(f"  scaled_dot_product_attention, window 8192: not measured "
              f"({type(e).__name__}: {str(e).splitlines()[0][:200]})")
    counts = sass_counts(_build.library_path("swa_attention.cu"), "swa_kernel")
    for name, ops in (counts or {"SASS": "not measured (no cuobjdump)"}).items():
        print(f"  SASS {name}: {ops}")
    del q, k, v

    def one(d):
        return card_normal((1, PREFILL_LEN, MLA_HEADS, d), gen,
                           dev).transpose(1, 2)
    q, k, v = one(MLA_DK), one(MLA_DK), one(MLA_DV)
    ms = time_ms(lambda: swa.swa_attention(q, k, v), 5, 1)
    dms = device_ms(lambda: swa.swa_attention(q, k, v), ("swa_kernel",), 5)
    print(f"  swa_attention (float32-p) at (1, {MLA_HEADS}, {PREFILL_LEN}, "
          f"{MLA_DK} / {MLA_DV}) causal: wrapper {ms:.3f} ms, device "
          f"{fmt_ms(dms)} ms")
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for label, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                           ("cudnn", SDPBackend.CUDNN_ATTENTION),
                           ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        try:
            with sdpa_kernel(backend):
                ms = time_ms(lambda: sdpa(q, k, v, is_causal=True), 3, 1)
            print(f"  scaled_dot_product_attention ({label}) with Ev "
                  f"{MLA_DV} unlike E {MLA_DK}: {ms:.3f} ms")
        except RuntimeError as e:
            print(f"  scaled_dot_product_attention ({label}): refused "
                  f"({str(e).splitlines()[0][:120]})")
    del q, k, v
    torch.cuda.empty_cache()


def prefill_breakdown(fn):
    """Device time of one call by kind (ms): the attention kernel, the
    matrix products (cuBLAS), and the rest (norms, RoPE, casts, ...)."""
    split = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in profiled_calls(fn, 1):
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if "swa_kernel" in ev.key:
            split["attention"] += t
        elif any(s in ev.key.lower() for s in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "sm90")):
            split["matmul"] += t
        else:
            split["other"] += t
    return split


def rel_to_max(a, b) -> float:
    """max |a - b| over max |b|, in float32 on the card."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def plain_attention_forward(fn):
    """Run ``fn`` with the prefill's attention in its plain chunked form
    (``nn/attention.chunked_attention``) in place of the kernel."""
    from repro_torch.nn import attention
    kernel_fa = attention.flash_attention
    attention.flash_attention = attention.chunked_attention
    try:
        return fn()
    finally:
        attention.flash_attention = kernel_fa


def drive_serving(dev):
    """The serving path: Mistral-NeMo-12B at full width, 4 of its 40
    layers, from ``init_model(cfg, 0)`` on the card, split by its freeze
    spec (trainable f32, frozen bf16). Prefill 1 x 32,768 tokens through
    ``make_prefill_step`` under ``serving_config`` of prefill_32k (full
    causal) and long_500k (window 8192), then greedy ``generate`` (batch
    4, prompt 8, 32 steps) under long_500k, with the launch counts set to
    0 just before and read just after; then the consistency checks on the
    card. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import partition as part
    from repro_torch.launch import serve, specs
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn import basic

    base = get_config(NEMO).with_(num_layers=NEMO_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y, frozen = specs.serving_split(dlm.init_model(base, 0, device=dev), base)
    torch.cuda.synchronize()
    n_y, n_z = basic.tree_size(y), basic.tree_size(frozen)
    print(f"[serving] {NEMO}, {NEMO_LAYERS} of 40 layers at full width "
          f"(d_model {base.d_model}, {base.num_heads} heads, "
          f"{base.num_kv_heads} kv heads, head_dim {base.head_dim}, d_ff "
          f"{base.d_ff}, vocab {base.vocab_size}): init_model(cfg, 0) on "
          f"the card in {time.perf_counter() - t0:.2f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"trainable {n_y} f32 ({basic.tree_bytes(y) / 1e9:.2f} GB), frozen "
          f"{n_z} bf16 ({basic.tree_bytes(frozen) / 1e9:.2f} GB)")
    if (n_y, n_z) != NEMO_SPLIT:
        raise AssertionError(f"the NeMo split {(n_y, n_z)} differs from "
                             f"{NEMO_SPLIT} (trainable, frozen)")
    cfgs = {shape: specs.serving_config(base, shape)
            for shape in ("prefill_32k", "long_500k")}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, base.vocab_size, (1, PREFILL_LEN), dtype=np.int64)
    prompt = rng.integers(0, base.vocab_size, (DECODE_BATCH, DECODE_PROMPT),
                          dtype=np.int64)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    prefill = {}
    for shape, cfg in cfgs.items():
        step = specs.make_prefill_step(cfg, device=dev)
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        walls = []
        for _ in range(4):   # the first call warms up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = step(y, frozen, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        if logits.shape != (1, PREFILL_LEN, base.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill ({shape}): logits not finite or "
                                 f"of the wrong shape {tuple(logits.shape)}")
        del logits
        split = prefill_breakdown(lambda: step(y, frozen, batch))
        wall = float(np.median(walls[1:]))
        prefill[shape] = (wall, split)
        busy = sum(split.values())
        print(f"[serving] prefill 1 x {PREFILL_LEN} ({shape}, window "
              f"{cfg.sliding_window}): wall ms {[round(w, 3) for w in walls]} "
              f"(median of the last 3 {wall:.3f} ms, "
              f"{PREFILL_LEN / wall * 1e3:.1f} tokens/s); device ms by kind "
              f"{ {k: round(v, 3) for k, v in split.items()} }: attention "
              f"kernel {split['attention'] / NEMO_LAYERS:.3f} ms per layer, "
              f"{100 * split['attention'] / busy:.1f}% of the device time "
              f"{busy:.3f} ms")
    ratio = prefill["long_500k"][1]["attention"] / \
        prefill["prefill_32k"][1]["attention"]
    print(f"[serving] windowed / causal attention kernel time: {ratio:.3f} "
          f"(gate < {WINDOW_GATE}; visible pairs 0.437)")
    if not ratio < WINDOW_GATE:
        raise AssertionError("the windowed prefill's attention is not "
                             "skipping the tiles outside the window")

    cfg = cfgs["long_500k"]
    params = part.merge(y, frozen)
    serve.generate(params, cfg, prompt, 2, device=dev)   # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seqs = serve.generate(params, cfg, prompt, DECODE_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    counts = dict(kernels.LAUNCHES)
    n_steps = DECODE_PROMPT + DECODE_STEPS
    print(f"[serving] generate (long_500k, batch {DECODE_BATCH}, prompt "
          f"{DECODE_PROMPT}, {DECODE_STEPS} greedy steps): {wall:.3f} ms, "
          f"{wall / n_steps:.3f} ms per decode step ({n_steps} steps with "
          f"the step-by-step prefill), "
          f"{DECODE_BATCH * DECODE_STEPS / wall * 1e3:.1f} generated "
          f"tokens/s; row 0: {seqs[0].tolist()}")
    print(f"[serving] launches {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if seqs.shape != (DECODE_BATCH, n_steps) or \
            not bool(((seqs >= 0) & (seqs < base.vocab_size)).all()):
        raise AssertionError("generate: tokens of the wrong shape or range")
    # sampled decoding: categorical over the bf16 logits / temperature
    serve.generate(params, cfg, prompt, 2, temperature=1.0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sampled = serve.generate(params, cfg, prompt, DECODE_STEPS,
                             temperature=1.0, seed=0, device=dev)
    torch.cuda.synchronize()
    swall = (time.perf_counter() - t1) * 1e3
    print(f"[serving] generate sampled (temperature 1.0, seed 0, bf16 "
          f"logits): {swall:.3f} ms, {swall / n_steps:.3f} ms per decode "
          f"step; row 0: {sampled[0].tolist()}")
    if sampled.shape != seqs.shape or torch.equal(sampled, seqs) or \
            not bool(((sampled >= 0) & (sampled < base.vocab_size)).all()):
        raise AssertionError("sampled generate: tokens of the wrong shape "
                             "or range, or the greedy ones")

    # consistency on the card, with the same weights
    short = torch.from_numpy(tokens[:, :CONSIST_LEN]).to(dev)
    for label, c in (("window 0", cfgs["prefill_32k"]),
                     ("window 200", base.with_(sliding_window=200))):
        step = specs.make_prefill_step(c, device=dev)
        got = step(y, frozen, {"tokens": short})
        want = plain_attention_forward(
            lambda: step(y, frozen, {"tokens": short}))
        rel = rel_to_max(got, want)
        print(f"[serving] prefill 1 x {CONSIST_LEN} ({label}), kernel vs the "
              f"plain chunked attention on the card: max |diff| / max |logit| "
              f"{rel:.3e} (tolerance {LOGIT_REL:.3e}), argmax agreement "
              f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.4f}")
        if not rel <= LOGIT_REL:
            raise AssertionError(f"prefill logits: kernel vs plain {rel}")
    stepped, _ = serve.prefill_by_steps(params, cfg, prompt, n_steps,
                                        device=dev)
    full = specs.make_prefill_step(cfg, device=dev)(y, frozen,
                                                    {"tokens": prompt})
    rel = rel_to_max(stepped, full)
    print(f"[serving] step-by-step prefill (decode_attention) vs forward "
          f"(kernel) at the {DECODE_PROMPT} prompt positions of {DECODE_BATCH} "
          f"rows: max |diff| / max |logit| {rel:.3e} (tolerance "
          f"{LOGIT_REL:.3e}), argmax agreement "
          f"{float((stepped.argmax(-1) == full.argmax(-1)).float().mean()):.4f}")
    if not rel <= LOGIT_REL:
        raise AssertionError(f"decode vs forward logits: {rel}")
    return counts


# --- rule 3: the paper's other two models, DP-FTRL, sampled decoding ------

CIFAR_SIDE = 32       # CIFAR-10's own images (train.py's 24 is a CPU cut)
SO_VOCAB = 10004      # the SO model's vocab (train.py's 2,004 is a CPU cut)
DP_FTRL_ROUNDS = 5
DP_FTRL_CLIENTS = 48  # examples/dp_federated_lm.py's dataset
# (trainable, total, flat size, blocks, leaves) as the reference counts them
MODEL_SHAPES = {
    "ResNet PT": (2_914_634, 11_172_170, 2_942_976, 2_874, 52),
    "ResNet FedAvg": (11_172_170, 11_172_170, 11_200_512, 10_938, 56),
    "SO PT": (1_665_504, 2_261_472, 1_692_672, 1_653, 46),
    "SO FedAvg": (2_261_472, 2_261_472, 2_288_640, 2_235, 52),
}
# a card round against the CPU's on these models: the update's difference
# by norm, relative to the update (see check_model_round)
UPDATE_NORM_REL = 2e-2
# the clients of the ResNet rounds' cohort of 10 that the card-vs-CPU round
# takes: each client repeats the same computation on other images, and the
# CPU's ResNet-18 round took 47-49 s of phase 4's 165.5 at all 10
# (PERF.md); the ten run on the card in drive_model_path, whose own sumsq
# launch (the delta_norm of the cohort's update, at the flat width) is
# held against the plain version there (sumsq_seen, check_path_sumsq)
RESNET_CHECK_CLIENTS = 3


class sumsq_seen:
    """Inside a ``with``: the first launch of ``kernels/dp_clip.sumsq`` on
    the card (``first``: a copy of its input vector and its result), so
    that a main path's own sumsq is held against its plain version on the
    same input afterwards (:func:`check_path_sumsq`)."""

    def __enter__(self):
        from repro_torch.kernels import dp_clip
        self.mod, self.real, self.first = dp_clip, dp_clip.sumsq, None

        def spy(x, *a, **kw):
            out = self.real(x, *a, **kw)
            if self.first is None and x.device.type == "cuda":
                self.first = (x.clone(), out.clone())
            return out
        dp_clip.sumsq = spy
        return self

    def __exit__(self, *exc):
        self.mod.sumsq = self.real
        return False


def check_path_sumsq(label, seen):
    """The sumsq kernel's first launch on a main path (``sumsq_seen``)
    against its plain version (``ref.flat_sumsq_ref``) on the same input
    on the card, within rtol 1e-5 (phase 2's bound against float64), and
    within ``dp_clip.sumsq_rtol`` of a float64 sum."""
    from repro_torch.kernels import dp_clip, ref
    if seen.first is None:
        raise AssertionError(f"{label}: sumsq never launched on the card")
    x, got = seen.first
    got, plain, want = (float(got), float(ref.flat_sumsq_ref(x)),
                        float64_sumsq(x))
    rtol = dp_clip.sumsq_rtol(x.numel())
    print(f"  {label}: the path's first sumsq at n = {x.numel()}: {got!r}, "
          f"plain {plain!r} (rel {abs(got - plain) / plain:.3e}, tol 1e-5), "
          f"float64 {want!r} (rel {abs(got - want) / want:.3e}, bound "
          f"sumsq_rtol {rtol:.3e})")
    if not (abs(got - plain) <= 1e-5 * plain and abs(got - want) <= rtol * want):
        raise AssertionError(f"{label}: the path's sumsq is off its plain "
                             f"version")


class tail_route_spy:
    """Counts the server tail's routes (``info["route"]`` of every
    ``kernels/ops.agg_tail`` call the engines make) inside a ``with``."""

    def __enter__(self):
        from collections import Counter
        from repro_torch.kernels import ops
        self.ops, self.real, routes = ops, ops.agg_tail, Counter()

        def spy(*args, **kw):
            out, info = self.real(*args, **kw)
            routes[info["route"]] += 1
            return out, info
        ops.agg_tail = spy
        return routes

    def __exit__(self, *exc):
        self.ops.agg_tail = self.real
        return False


def so_lane_block_leaf(dev):
    """The SO PT row's block->leaf map from its 46 leaf sizes in the
    layout's (sorted path) order: the embedding, the final norm, per layer
    ffn2 (bias, kernel), ln1, ln2, then wk, wo, wq, wv (bias, kernel),
    and the positions. Built from the sizes alone, so that ``--kernel-times``
    times the lane's shape on a tree without the SO model; ``main`` holds
    it to the model's ``FlatLayout``. Returns (map, leaves, row length)."""
    d, ff = 96, 2048
    layer = [d, ff * d, d, d, d, d] + [d, d * d] * 4
    sizes = [SO_VOCAB * d, d, d] + layer * 3 + [20 * d]
    blocks = [-(-n // 1024) for n in sizes]
    bl = np.repeat(np.arange(len(sizes), dtype=np.int32), blocks)
    return torch.as_tensor(bl, device=dev), len(sizes), 1024 * len(bl)


def model_task(name, dev):
    """``launch/train.paper_task`` for a path of MODEL_SHAPES at full
    width, with its partitioned parameters on the card, the counts and
    layout asserted against the reference's."""
    from repro_torch.core import flat as flat_lib, partition as part
    from repro_torch.launch import train
    task = "cifar" if name.startswith("ResNet") else "stackoverflow"
    pt = train.paper_task(task, fully_trainable=name.endswith("FedAvg"),
                          device=dev, cifar_side=CIFAR_SIDE,
                          so_vocab=SO_VOCAB)
    y, frozen = part.partition(pt.init_fn(0), pt.freeze_spec)
    layout = flat_lib.FlatLayout.of(y)
    n_y, n_z = part.count_params(y), part.count_params(frozen)
    got = (n_y, n_y + n_z, layout.size, layout.num_blocks, len(layout.sizes))
    print(f"[model] {name}: {n_y + n_z} params, {n_y} trainable "
          f"({100 * n_y / (n_y + n_z):.2f}%), flat size {layout.size} in "
          f"{layout.num_blocks} blocks over {len(layout.sizes)} leaves")
    if got != MODEL_SHAPES[name]:
        raise AssertionError(f"{name}: (trainable, total, size, blocks, "
                             f"leaves) {got}, the reference's "
                             f"{MODEL_SHAPES[name]}")
    return pt, y, frozen


def task_draws(pt, n, rc=None, seed=0):
    """The first n (batch, weights) cohort draws of ``pt``, from ``seed``."""
    from repro_torch.data import synthetic as syn
    rc = rc or pt.rc
    from repro_torch.sim.grid import num_clients
    rng = np.random.default_rng(seed)
    n_clients = num_clients(pt.dataset)
    out = []
    for _ in range(n):
        cids = syn.sample_cohort(rng, n_clients, rc.clients_per_round)
        out.append(syn.cohort_batch(pt.dataset, cids, rc.local_steps,
                                    rc.local_batch, rng, kind=pt.kind))
    return out


def update_gap(y0, y_card, y_cpu):
    """(||dy_card - dy_cpu||, ||dy_cpu||) over every leaf, dy = y - y0."""
    diff = step = 0.0
    for a, b, c in zip(leaves_of(y0), leaves_of(y_card), leaves_of(y_cpu)):
        a, b, c = a.double().cpu(), b.double().cpu(), c.double()
        diff += float(((b - c) ** 2).sum())
        step += float(((c - a) ** 2).sum())
    return diff ** 0.5, step ** 0.5


def check_model_round(label, pt, y0, frozen, batch, w, dev, rc=None,
                      server_opt=None, loss_rel=1e-4,
                      update_rel=UPDATE_NORM_REL, clients=None):
    """One round on the card against the same round on the CPU through
    the plain versions, from the same start, batch and round key.

    The EMNIST paths' elementwise bound on dy does not hold on these
    models: a ReLU pre-activation within the float32 reassociation noise
    of 0 (cuDNN's and the CPU's convolution and matmul orders) falls on
    the other side of the kink on the other device, which moves that
    client's step by the unit's whole gradient share, and Adam's first
    step g / (|g| + 1e-8) turns a gradient that is float noise (the SO
    key bias's, 0 in exact arithmetic) into a step of up to the learning
    rate with the noise's sign. So the update is held by norm,
    ||dy_card - dy_cpu|| <= UPDATE_NORM_REL ||dy_cpu||, with the loss within rel 1e-4 and delta_norm within rel 1e-2
    (``tests/test_torch_tokens.py`` measures 0.7e-2 by norm after two SO
    rounds against JAX); ``loss_rel`` and ``update_rel`` tighten the first
    and the last for a model without those kinks and steps. ``clients``:
    the round takes the cohort's first ``clients`` clients alone."""
    from repro_torch.bridge import from_numpy_tree, to_numpy_tree
    from repro_torch.core import fedpt
    from repro_torch.nn import threefry
    rc = rc or pt.rc
    if clients is not None:
        batch = {k: v[:clients] for k, v in batch.items()}
        w = w[:clients]
        label = f"{label} ({clients} of the cohort's clients)"
    out = []
    for d, y, z in ((dev, y0, frozen),
                    ("cpu", from_numpy_tree(to_numpy_tree(y0), "cpu"),
                     from_numpy_tree(to_numpy_tree(frozen), "cpu"))):
        sopt = server_opt() if server_opt else None
        round_fn, sopt = fedpt.make_round_fn(pt.loss_fn, rc, sopt, device=d)
        y1, _, m = round_fn(y, sopt.init(y), z, batch, w, threefry.key(0))
        out.append((float(m["loss"]), float(m["delta_norm"]), y1))
    (lg, ng, yg), (lc, nc, yc) = out
    gap, step = update_gap(y0, yg, yc)
    print(f"  {label}, round 0, card vs CPU: loss {lg:.7f} / {lc:.7f}, "
          f"delta_norm {ng:.7f} / {nc:.7f}, ||dy|| {step:.4e}, ||dy diff|| "
          f"/ ||dy|| {gap / step:.3e} (tol {update_rel:.0e}); loss rel "
          f"{abs(lg - lc) / abs(lc):.3e} (tol {loss_rel:.0e})")
    if not (abs(lg - lc) <= loss_rel * abs(lc) and abs(ng - nc) <= 1e-2 * nc
            and gap <= update_rel * step):
        raise AssertionError(f"{label}: the card's round disagrees with "
                             f"the CPU's")


def client_peak_mib(pt, y, frozen, batch, rc, dev):
    """Peak device memory (MiB) around one client's local update (tau
    steps of its optimizer) on the card, and the part above what was
    allocated before it: the counterpart of Table 4's peak memory."""
    from repro_torch.core import fedpt
    from repro_torch.optim import optimizers as opt_lib
    update = fedpt.make_client_update(
        pt.loss_fn, opt_lib.get_optimizer(rc.client_opt, rc.client_lr),
        rc.local_steps)
    cb = {k: torch.as_tensor(v[0], device=dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    delta, _ = update(y, frozen, cb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del delta
    return peak / 2 ** 20, (peak - base) / 2 ** 20


def drive_model_path(label, pt, y0, frozen, draws, expect, dev, rc=None,
                     server_opt=None, falls=True):
    """A round-engine path on a paper model: len(draws) - 1 timed rounds
    with the launch counts set to 0 just before and read just after (and
    the server tail's routes), the eval at the end, the peak memory of one
    client update, and one profiled round. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.core import fedpt, partition as part
    from repro_torch.nn import threefry
    from repro_torch.nn.basic import tree_leaves
    rc = rc or pt.rc
    round_fn, sopt = fedpt.make_round_fn(
        pt.loss_fn, rc, server_opt() if server_opt else None, device=dev)
    y, sstate = y0, sopt.init(y0)
    losses, norms, ms = [], [], []
    kernels.reset_launches()
    with tail_route_spy() as routes:
        for r, (batch, w) in enumerate(draws[:-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, sstate, m = round_fn(y, sstate, frozen, batch, w,
                                    threefry.key(r))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["delta_norm"]))
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    acc = pt.eval_fn(part.merge(y, frozen))["accuracy"]
    print(f"[main path] {label}: losses {[round(v, 4) for v in losses]}")
    print(f"  delta_norm {[round(v, 5) for v in norms]}")
    print(f"  per-round wall ms {[round(v, 3) for v in ms]} (median "
          f"{float(np.median(ms)):.3f}, first round included in the list); "
          f"{'NWP ' if pt.kind == 'tokens' else ''}accuracy after "
          f"{len(ms)} rounds {acc:.4f}; launches {counts}; server tail "
          f"routes {dict(routes)}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{label}: non-finite loss or norm")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall")
    if not all(torch.isfinite(leaf).all() for leaf in tree_leaves(y)):
        raise AssertionError(f"{label}: non-finite parameters")
    if set(routes) != {"staged"}:
        raise AssertionError(f"{label}: server tail routes {dict(routes)}")
    check_expected(label, counts, expect)
    batch, w = draws[-1]
    peak, above = client_peak_mib(pt, y0, frozen, batch, rc, dev)
    print(f"  peak device memory around one client update: {peak:.1f} MiB "
          f"({above:.1f} MiB above what was held before it)")
    profile_round(
        lambda: round_fn(y, sstate, frozen, batch, w, threefry.key(ROUNDS)))
    return counts


def so_async_task(pt):
    """The async DP path's configuration (FedBuff over pareto-mobile,
    concurrency 12, goal 6, polynomial staleness, int8, clip 0.5, noise
    multiplier 0.4) on the SO PT model: its lane rows of 1,653 blocks take
    the two-pass Q->DQ (``leaf_maxabs`` then ``qdq_kernel``) and the
    three-launch clip. Its Adam clients' lanes are held by norm without
    the flush's noise (:func:`check_async_signal`)."""
    import dataclasses
    from repro_torch.data import synthetic as syn
    from repro_torch.models import paper_models as pm
    rc = dataclasses.replace(pt.rc, uplink_bits=8, dp_clip_norm=DP_CLIP,
                             dp_noise_multiplier=DP_NOISE)
    return dict(label="SO async FedBuff, int8 + per-flush DP", rc=rc,
                loss_fn=pt.loss_fn, spec=pt.freeze_spec, kind="tokens",
                batch_fn=syn.client_batch_tokens,
                init=lambda s, device: pm.init_so_transformer(
                    s, vocab=SO_VOCAB, device=device),
                expect=("leaf_maxabs", "fake_quantize_flat",
                        "fake_quantize_flat/two_pass", "clip_flat",
                        "clip_flat/three_launch"),
                signal_rel=UPDATE_NORM_REL)


def drive_so_async(pt, dev):
    """The SO async int8 DP path; besides the async checks, no lane may
    take a cluster route (its rows hold more blocks than they fit)."""
    counts = drive_async_dp(pt.dataset, dev, so_async_task(pt))
    for name in ("fake_quantize_flat/cluster", "clip_flat/cluster"):
        if counts[name]:
            raise AssertionError(f"SO async: {name} launched {counts[name]}"
                                 " times")
    return counts


def dp_ftrl_setup(dev):
    """``examples/dp_federated_lm.py`` at vocab 10,004: the SO PT model, a
    48-client token dataset, DP-FedAvg's per-client clip at 0.3 with
    uniform weights and no round noise, and the DP-FTRL server (noise
    multiplier 2.33, tree noise keyed by its seed), and the same server
    without the tree noise."""
    import dataclasses
    from repro_torch.core import dp, fedpt
    from repro_torch.data import synthetic as syn
    from repro_torch.fl import runtime
    from repro_torch.launch import train
    from repro_torch.models import paper_models as pm
    pt = train.paper_task("stackoverflow", device=dev, so_vocab=SO_VOCAB)
    pt.dataset = syn.make_federated_tokens(DP_FTRL_CLIENTS, 64,
                                           vocab=SO_VOCAB, seed=0)
    pt.eval_fn = runtime.nwp_accuracy_eval(pm.so_transformer_forward,
                                           pt.dataset.test_tokens)
    rc = fedpt.RoundConfig(16, 2, 16, "sgd", 10 ** -0.5, "sgd", 1.0,
                           dp_clip_norm=0.3, uniform_weights=True)
    dcfg = dp.DPFTRLConfig(lr=0.3, noise_multiplier=2.33, clip_norm=0.3,
                           clients_per_round=16, momentum=0.9)
    quiet = dataclasses.replace(dcfg, noise_multiplier=0.0)
    return (pt, rc, lambda: dp.dp_ftrl_server_opt(dcfg),
            lambda: dp.dp_ftrl_server_opt(quiet))


def drive_dp_ftrl(dev):
    """The SO DP-FTRL path: DP_FTRL_ROUNDS rounds of the round engine with
    the DP-FTRL server (the clip on the staged tail, ``sumsq`` for
    delta_norm, ``tree_noise`` in the server step), first round card vs
    CPU without the tree noise (with it, the same draw on both devices,
    sigma = 2.33 * 0.3 / 16 an element, outweighs the clipped mean, of
    norm at most 0.3, ~190-fold by norm and would hide the clients), then
    ``run_federated`` as the example drives it. Returns the launch counts
    of the timed rounds."""
    from repro_torch.core import partition as part
    from repro_torch.fl import runtime
    pt, rc, sopt, quiet = dp_ftrl_setup(dev)
    label = "SO DP-FTRL (noise 2.33), clip 0.3"
    y0, frozen = part.partition(pt.init_fn(0), pt.freeze_spec)
    draws = task_draws(pt, DP_FTRL_ROUNDS + 1, rc)
    check_model_round(f"{label}, without the tree noise", pt, y0, frozen,
                      *draws[0], dev, rc, quiet)
    counts = drive_model_path(label, pt, y0, frozen, draws, ("sumsq",), dev,
                              rc, sopt, falls=False)
    res = runtime.run_federated(
        pt.init_fn, pt.loss_fn, pt.dataset, rc, DP_FTRL_ROUNDS,
        freeze_spec=pt.freeze_spec, data_kind="tokens", server_opt=sopt(),
        eval_every=DP_FTRL_ROUNDS, eval_fn=pt.eval_fn, device=dev)
    last = res.history[-1]
    print(f"  run_federated, {DP_FTRL_ROUNDS} rounds: loss "
          f"{[round(h['loss'], 4) for h in res.history]}, NWP accuracy "
          f"{last['accuracy']:.4f}, comm reduction {res.comm.reduction:.2f}x,"
          f" seconds_per_round {1e3 * res.seconds_per_round:.3f} ms")
    if not all(math.isfinite(h["loss"]) for h in res.history):
        raise AssertionError(f"{label}: run_federated's loss not finite")
    return counts


def check_categorical(dev):
    """``threefry.categorical`` on the card against the CPU port, on
    fixed logits drawn from a seed (64 rows of NeMo's 131,072-token vocab)
    in float32 and bfloat16. A row may pick another token only where its
    top two perturbed logits lie within the Gumbel bound
    (``threefry.gumbel_tolerance`` of each, plus one rounding of the sum);
    the count of such rows is printed."""
    from repro_torch.nn import threefry
    gen = torch.Generator(device="cpu").manual_seed(23)
    logits = torch.randn((64, 131072), generator=gen) * 3.0
    for dtype in (torch.float32, torch.bfloat16):
        x = logits.to(dtype)
        key = threefry.key(9)
        card = threefry.categorical(key, x.to(dev)).cpu()
        cpu = threefry.categorical(key, x)
        g = threefry.gumbel(key, tuple(x.shape), dtype)
        p = (g + x).float()
        top2 = p.topk(2, dim=-1)
        gi = g.float().gather(1, top2.indices)
        tol = (threefry.gumbel_tolerance(gi.to(dtype)).sum(-1)
               + 2 * torch.finfo(dtype).eps * top2.values.abs().max(-1).values)
        near = (top2.values[:, 0] - top2.values[:, 1]) <= tol
        differ = card != cpu
        print(f"[serving] categorical on the card vs the CPU, {dtype}, "
              f"(64, 131072): {int(differ.sum())} rows pick another token, "
              f"{int(near.sum())} rows' top two within the Gumbel bound")
        if bool((differ & ~near).any()):
            raise AssertionError(f"categorical ({dtype}): the card picks "
                                 f"other tokens than the CPU")


# --- trainability tiers: the EMNIST CNN with a three-tier plan ----------------

# examples/async_heterogeneous.py's plan: capable phones train the whole
# trainable tree, mid phones freeze conv2, weak phones conv1 as well
TIERS = {"full": (), "mid": (r"^conv2/",), "lite": (r"^conv1/", r"^conv2/")}
# the sync path's explicit tier of each of the 40 clients
TIER_ASSIGN = np.arange(N_CLIENTS) % 3
ADAPT_UPDATES, ADAPT_REFIT = 16, 4   # examples/adaptive_tiers.py's


def tier_layouts(y):
    """(compiled plan, [(tier name, the tier subtree's FlatLayout)]) of
    TIERS over the trainable tree y."""
    from repro_torch.core import flat as flat_lib, plan as plan_lib
    cp = plan_lib.compile_plan(TIERS, y)
    return cp, [(t.name, flat_lib.FlatLayout.of(cp.split(y, t)[0]))
                for t in cp.tiers]


class width_spy:
    """Counts the launches of kernel wrappers on the card by row width
    (``(name, width)``) inside a ``with``; ``targets`` are (module of
    ``repro_torch.kernels``, wrapper) pairs, by default the uplink's Q->DQ
    and clip, which the tiered lanes run at each tier's width."""

    def __init__(self, targets=(("quantize", "fake_quantize_flat"),
                                ("dp_clip", "clip_flat"))):
        self.targets = targets

    def __enter__(self):
        import importlib
        from collections import Counter
        counts = Counter()
        self.saved = []
        for modname, name in self.targets:
            mod = importlib.import_module(f"repro_torch.kernels.{modname}")
            self.saved.append((mod, name, getattr(mod, name)))
        for mod, name, real in self.saved:
            def spy(x, *a, _real=real, _name=name, **kw):
                if x.device.type == "cuda":
                    counts[(_name, int(x.shape[-1]))] += 1
                return _real(x, *a, **kw)
            setattr(mod, name, spy)
        return counts

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False


def check_tier_kernels(layouts, dev):
    """Phase 2 at the tiered async lanes' shapes: the cluster Q->DQ over
    each tier's own block map, bit for bit its plain version, and the
    cluster clip_flat, bit for bit the three-launch entry and its norms
    within ``dp_clip.norm_rtol`` of the plain version, on (GOAL, tier
    width) rows with a zero, an under-the-clip, a NaN and an Inf row (bit
    for bit); one launch each on the cluster route."""
    from repro_torch import kernels
    from repro_torch.kernels import dp_clip, quantize, ref
    gen = torch.Generator(device="cpu").manual_seed(31)
    for name, tl in layouts:
        bl, L, n = tl.block_leaf(), len(tl.sizes), tl.size
        m = clip_rows(n, gen, dev)
        kernels.reset_launches()
        got = quantize.fake_quantize_flat(m, bl, L)
        if not same_bits(got, ref.fake_quantize_flat_ref(m, bl, n_leaves=L)):
            raise AssertionError(f"fake_quantize_flat != plain version "
                                 f"(tier {name}, {tuple(m.shape)})")
        kernels.reset_launches()
        clipped, norms = dp_clip.clip_flat(m, DP_CLIP)
        routes = {k: v for k, v in kernels.ROUTES.items() if v}
        if routes != {"clip_flat/cluster": 1}:
            raise AssertionError(f"clip_flat (tier {name}) took {routes}")
        kernels.reset_launches()
        quantize.fake_quantize_flat(m, bl, L)
        routes = {k: v for k, v in kernels.ROUTES.items() if v}
        if routes != {"fake_quantize_flat/cluster": 1}:
            raise AssertionError(f"fake_quantize_flat (tier {name}) took "
                                 f"{routes}")
        three, tnorm = clip_three_launch(m)
        want, wnorm = ref.flat_clip_ref(m, DP_CLIP)
        rtol = dp_clip.norm_rtol(n)
        rel = max(abs(float(norms[r]) - float(wnorm[r])) / float(wnorm[r])
                  for r in (0, 5))
        exact = all(same_bits(clipped[r], want[r])
                    and same_bits(norms[r], wnorm[r]) for r in (1, 2, 3, 4))
        if not (same_bits(clipped, three) and same_bits(norms, tnorm)
                and rel <= rtol and exact):
            raise AssertionError(f"clip_flat off at tier {name}: norm rel "
                                 f"{rel} (bound {rtol}), edge rows exact "
                                 f"{exact}")
        print(f"  tier {name} ({tuple(m.shape)}, {L} leaves): "
              f"fake_quantize_flat == plain, bit for bit; clip_flat bit for "
              f"bit the three-launch entry, norms within rel {rel:.3e} "
              f"(bound {rtol:.3e}), zero / under-clip / NaN / Inf rows bit "
              f"for bit; one launch each, cluster route")


def tiered_async_task(dp):
    """examples/async_heterogeneous.py --tiers on the card: the async
    path's fleet (pareto-mobile, concurrency 12, goal 6, polynomial
    staleness) at int8 with TIERS assigned by capability; ``dp`` adds
    per-flush DP (clip 0.5, z 0.4), whose clip runs on each tier's lane."""
    task = emnist_async()
    expect = ("fake_quantize_flat", "fake_quantize_flat/cluster")
    if dp:
        expect += ("clip_flat", "clip_flat/cluster")
    task.update(label=f"async tiered, int8{' + per-flush DP' if dp else ''}",
                rc=quickstart_rc(8, dp=dp), grid=dict(plan=TIERS),
                expect=expect)
    return task


def tier_table(res) -> str:
    return "; ".join(
        f"{name}: {r['clients']} clients, {r['uploads']} uploads of "
        f"{r['up_bytes_per_upload']:.0f} B, compute {r['compute_seconds']:.4f}"
        f" s, rtt {r['rtt_mean']:.3f} s" for name, r in res.tier_stats.items())


def flush_steps(task, res, dev):
    """The device work of one tiered flush at the run's end state: one lane
    step of each tier (GOAL clients of that tier) and the tiered apply."""
    from repro_torch.core import dp as dp_lib, fedpt
    from repro_torch.nn import threefry
    rc, ds, cp = task["rc"], task["ds"], res.plan
    lanes = [fedpt.make_lane_step(task["loss_fn"], rc, GOAL, tier=t, plan=cp,
                                  device=dev) for t in cp.tiers]
    flush_dp = (dp_lib.FlushDPConfig(DP_CLIP, DP_NOISE, GOAL)
                if rc.dp_noise_multiplier > 0 else None)
    apply_fn = fedpt.make_buffered_apply(fedpt.resolve_server_opt(rc),
                                         flush_dp=flush_dp, plan=cp,
                                         device=dev)
    rng = np.random.default_rng(5)
    batches = [task["batch_fn"](ds, c, rc.local_steps, rc.local_batch,
                                rng)[0] for c in range(GOAL)]
    lane = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    w = np.full(GOAL, 0.7, np.float32)
    tids = np.arange(GOAL) % len(cp.tiers)
    sstate = fedpt.resolve_server_opt(rc).init(res.y)
    key = threefry.key(7) if flush_dp else None

    def flush():
        rows = [step(res.y, res.frozen, lane)[0] for step in lanes]
        mixed = torch.stack([rows[t][i] for i, t in enumerate(tids)])
        return apply_fn(res.y, sstate, mixed, w, tids, key)
    return flush


def drive_tiered_async(ds, dev, dp):
    """The tiered async path: ASYNC_UPDATES updates with the launch counts
    set to 0 just before and read just after (and the uplink kernels'
    launches by row width), beside the same fleet all-``full``; the mixed
    uplink must bill fewer bytes. Then the card against the CPU for the
    first ASYNC_CHECKED updates (:func:`check_async_against_cpu`, with
    ``tier_stats`` equal), and one flush's device work (a lane step of
    each tier and the tiered apply) timed and profiled. Returns the
    launch counts."""
    import dataclasses
    from repro_torch import kernels
    task = dict(tiered_async_task(dp), ds=ds)
    init = lambda s: task["init"](s, device=dev)  # noqa: E731
    kernels.reset_launches()
    with width_spy() as widths, tail_route_spy() as routes:
        res = async_run(ds, init, ASYNC_UPDATES, dev, task)
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    full = async_run(ds, init, ASYNC_UPDATES, dev,
                     {**task, "grid": {}, "label": "all-full"})
    label = task["label"]
    losses = [h["loss"] for h in res.history]
    print(f"[tiers] {label}: losses {[round(v, 4) for v in losses]}")
    print(f"  virtual seconds {res.virtual_seconds:.4f}, stats "
          f"{res.scheduler_stats}, dp {res.dp}")
    print(f"  tier_stats: {tier_table(res)}")
    print(f"  uplink bytes: tiered {res.comm.measured_up_bytes} in "
          f"{res.scheduler_stats['uploads']} uploads, all-full "
          f"{full.comm.measured_up_bytes} in {full.scheduler_stats['uploads']}"
          f" uploads")
    print(f"  seconds_per_round (per update, synchronized) "
          f"{1e3 * res.seconds_per_round:.3f} ms (all-full "
          f"{1e3 * full.seconds_per_round:.3f}); launches {counts}; uplink "
          f"kernels by row width {dict(sorted(widths.items()))}; server tail "
          f"routes {dict(routes)}")
    if len(res.history) != ASYNC_UPDATES or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: wrong record count or non-finite")
    if not res.comm.measured_up_bytes < full.comm.measured_up_bytes:
        raise AssertionError(f"{label}: the tiered uplink does not bill "
                             f"fewer bytes than all-full")
    sizes = {t.size for t in res.plan.tiers[1:]}
    if not {w for (_, w) in widths} & sizes:
        raise AssertionError(f"{label}: no uplink kernel ran at a mid / lite"
                             f" width {sorted(sizes)}")
    if dp and (res.dp["flushes"], res.dp["sigma"]) != (
            ASYNC_UPDATES, DP_NOISE * DP_CLIP / GOAL):
        raise AssertionError(f"{label}: DP summary {res.dp}")
    check_expected(label, counts, task["expect"])
    check_async_against_cpu(ds, dev, task)
    flush = flush_steps(task, res, dev)
    med = wall_ms(flush)
    print(f"  one tiered flush's device work (a lane step of each of the "
          f"{len(res.plan.tiers)} tiers, {GOAL} clients each, and the tiered "
          f"apply): wall median {med:.3f} ms of 10, synchronized")
    profile_round(flush, "tiered flush")
    return counts


def tier_cohorts(ds, n):
    """The quickstart's first n cohorts from seed 0, with each slot's tier
    from TIER_ASSIGN: (batch, weights, tiers)."""
    from repro_torch.data import synthetic as syn
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        cids = syn.sample_cohort(rng, ds.num_clients, CLIENTS_PER_ROUND)
        batch, w = syn.cohort_batch(ds, cids, LOCAL_STEPS, LOCAL_BATCH, rng)
        out.append((batch, w, TIER_ASSIGN[cids]))
    return out


def drive_sync_tiers(ds, ya, za, dev):
    """Sync FedAvg with TIERS (every parameter trainable, int8, clients'
    tiers from TIER_ASSIGN): round 0 card vs CPU (as the FedAvg paths);
    ROUNDS rounds on the fused route with the per-block denominator
    (block_stats, pack, the exact apply), one DP-FedAvg round on the
    coefficient route, and a lite-only round whose conv1 / conv2 leaves
    must come back bit for bit, all with the launch counts set to 0 just
    before and read just after; then one profiled round. Returns the
    launch counts."""
    from repro_torch import kernels
    from repro_torch.bridge import from_numpy_tree, to_numpy_tree
    from repro_torch.core import fedpt
    from repro_torch.nn import threefry
    from repro_torch.nn.basic import flatten_params, tree_leaves
    label = "sync FedAvg tiered, int8"
    draws = tier_cohorts(ds, ROUNDS + 1)

    def rounds(y, d, dp=False):
        return fedpt.make_round_fn(emnist_loss, quickstart_rc(8, dp),
                                   device=d, plan=tier_layouts(y)[0])
    # round 0, card vs CPU
    batch, w, tiers = draws[0]
    out = []
    for d, y, z in ((dev, ya, za),
                    ("cpu", from_numpy_tree(to_numpy_tree(ya), "cpu"),
                     from_numpy_tree(to_numpy_tree(za), "cpu"))):
        round_fn, sopt = rounds(y, d)
        y1, _, m = round_fn(y, sopt.init(y), z, batch, w, tiers,
                            threefry.key(0))
        out.append((float(m["loss"]), float(m["delta_norm"]),
                    {k: v.cpu() - y0k.cpu() for (k, v), (_, y0k) in zip(
                        flatten_params(y1), flatten_params(y))}))
    (lg, ng, dg), (lc, nc, dc) = out
    worst = max(float((dg[k] - dc[k]).abs().max()) for k in dg)
    step = max(float(v.abs().max()) for v in dc.values())
    tol = 2 * step / 127 + 1e-7   # as the int8 FedAvg paths
    print(f"  {label}, round 0, card vs CPU: loss {lg:.7f} / {lc:.7f}, "
          f"delta_norm {ng:.7f} / {nc:.7f}, max |dy| diff {worst:.3e} (tol "
          f"{tol:.3e})")
    if not (abs(lg - lc) <= 1e-4 * abs(lc) and abs(ng - nc) <= 1e-2 * nc
            and worst <= tol):
        raise AssertionError(f"{label}: the card's round disagrees with "
                             f"the CPU's")

    round_fn, sopt = rounds(ya, dev)
    dp_fn, dp_sopt = rounds(ya, dev, dp=True)
    y, sstate = ya, sopt.init(ya)
    losses, ms = [], []
    kernels.reset_launches()
    with tail_route_spy() as routes:
        for r, (batch, w, tiers) in enumerate(draws[:ROUNDS]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, sstate, m = round_fn(y, sstate, za, batch, w, tiers,
                                    threefry.key(r))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        exact = dict(routes)
        batch, w, _ = draws[ROUNDS]
        y_dp, _, m_dp = dp_fn(y, dp_sopt.init(y), za, batch, w,
                              TIER_ASSIGN[:CLIENTS_PER_ROUND],
                              threefry.key(ROUNDS))
        lite = np.full(CLIENTS_PER_ROUND, 2)
        y_lite, _, m_lite = round_fn(y, sopt.init(y), za, batch, w, lite,
                                     threefry.key(ROUNDS))
        torch.cuda.synchronize()
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    frozen_same = all(torch.equal(y_lite[k][p], y[k][p])
                      for k in ("conv1", "conv2") for p in y[k])
    moved = not torch.equal(y_lite["dense2"]["kernel"],
                            y["dense2"]["kernel"])
    print(f"[tiers] {label}: losses {[round(v, 4) for v in losses]}")
    print(f"  per-round wall ms {[round(v, 3) for v in ms]} (median "
          f"{float(np.median(ms)):.3f}, first round included in the list); "
          f"launches {counts}; server tail routes {dict(routes)} (the "
          f"{ROUNDS} tiered rounds: {exact})")
    print(f"  DP-FedAvg tiered round: delta_norm "
          f"{float(m_dp['delta_norm']):.5f}; lite-only cohort: conv1 / conv2 "
          f"bit for bit {frozen_same}, dense2 moved {moved}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: non-finite loss, or it did not fall")
    if exact != {"fused/cuda/exact": ROUNDS}:
        raise AssertionError(f"{label}: tiered rounds took {exact}")
    if dict(routes) != {"fused/cuda/exact": ROUNDS + 1,
                        "fused/cuda/coeff": 1}:
        raise AssertionError(f"{label}: DP / lite rounds took {dict(routes)}")
    if not (frozen_same and moved):
        raise AssertionError(f"{label}: the lite-only cohort moved a leaf its "
                             f"tier froze, or trained nothing")
    if not all(torch.isfinite(leaf).all()
               for leaf in tree_leaves(y) + tree_leaves(y_dp)):
        raise AssertionError(f"{label}: non-finite parameters")
    check_expected(label, counts, ("sumsq", "block_stats", "pack",
                                   "apply_coeff"))
    profile_round(lambda: round_fn(y, sstate, za, batch, w,
                                   TIER_ASSIGN[:CLIENTS_PER_ROUND],
                                   threefry.key(ROUNDS)), "tiered round")
    return counts


def drive_adaptive_tiers(ds, dev):
    """examples/adaptive_tiers.py on the card: the adaptive-capability
    policy re-tiering the pareto-mobile-diurnal fleet every ADAPT_REFIT
    updates from observed round trips, ADAPT_UPDATES updates at int8, with
    the launch counts set to 0 just before and read just after; the census
    before and after, and the example's checks (observed EMAs moved off
    their estimates, the final map the quantile split of the EMAs at the
    last refit); then one flush's device work at the end state timed and
    profiled. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.models import paper_models as pm
    from repro_torch.sim import grid
    from repro_torch.sim.devices import quantile_tiers
    from repro_torch.sim.selection import AdaptiveCapabilityPolicy
    policy = AdaptiveCapabilityPolicy(refit_every=ADAPT_REFIT, ema=0.4)
    gc = grid.GridConfig(mode="async", fleet="pareto-mobile-diurnal",
                         concurrency=CONCURRENCY, goal_count=GOAL,
                         staleness="polynomial", plan=TIERS,
                         selection=policy)
    kernels.reset_launches()
    res = grid.run_grid(lambda s: pm.init_emnist_cnn(s, device=dev),
                        emnist_loss, ds, quickstart_rc(8), ADAPT_UPDATES,
                        grid=gc, freeze_spec=pm.EMNIST_FREEZE, seed=0,
                        device=dev)
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    static, final = np.asarray(policy._tiers), np.asarray(
        policy.current_tiers())
    names = list(TIERS)
    census = [dict(zip(names, map(int, np.bincount(m, minlength=3))))
              for m in (static, final)]
    print(f"[tiers] adaptive-capability, {res.fleet.name}: loss "
          f"{res.history[0]['loss']:.4f} -> {res.history[-1]['loss']:.4f} "
          f"over {len(res.history)} updates, {res.virtual_seconds:.1f} "
          f"virtual seconds; re-tiered {policy.refits}x, "
          f"{int(np.sum(static != final))}/{len(final)} clients moved")
    print(f"  census static {census[0]} -> adapted {census[1]}")
    print(f"  tier_stats: {tier_table(res)}")
    print(f"  seconds_per_round (per update, synchronized) "
          f"{1e3 * res.seconds_per_round:.3f} ms; launches {counts}")
    seed_est = np.asarray(policy.rtt_estimate, np.float64)
    if not (policy.refits >= 1 and policy.observed.any() and not np.allclose(
            policy.ema_rtt[policy.observed], seed_est[policy.observed])):
        raise AssertionError("adaptive-capability: no refit, or the observed"
                             " round trips never moved the EMAs")
    if not np.array_equal(final, quantile_tiers(1.0 / policy.refit_ema, 3)):
        raise AssertionError("adaptive-capability: the final map is not the "
                             "split of the EMAs at the last refit")
    if not all(math.isfinite(h["loss"]) for h in res.history):
        raise AssertionError("adaptive-capability: non-finite loss")
    check_expected("adaptive-capability", counts,
                   ("fake_quantize_flat", "fake_quantize_flat/cluster"))
    flush = flush_steps(dict(tiered_async_task(False), ds=ds), res, dev)
    print(f"  one tiered flush's device work: wall median "
          f"{wall_ms(flush):.3f} ms of 10, synchronized")
    profile_round(flush, "tiered flush")
    return counts


# ---------------------------------------------------------------------------
# Phase 6: checkpoint / resume and the edge topology on the card

# tests/test_resume.py's fault rates, and examples/async_heterogeneous.py
# --regions' shocks (a region down for 1.2 virtual seconds, every 0.8)
CHAOS = dict(crash_compute=0.05, truncate_upload=0.05, corrupt_nan=0.08,
             corrupt_bitflip=0.08, duplicate_upload=0.05)
REGION_SHOCKS = dict(every=0.8, duration=1.2, residual=0.0)
REGIONS, CKPT_EVERY, WALL_RUNS = 4, 2, 10


class snapshot_timer:
    """Times the grid's snapshot calls inside a ``with`` (each wrapped in
    ``torch.cuda.synchronize``): encode (the device-to-host copies), the
    npz write, the read and the decode (the copies back to the card),
    in ms, by name."""
    NAMES = ("encode_async", "save_state", "load_state", "decode_async")

    def __enter__(self):
        from repro_torch.checkpoint import grid_state
        self.mod, self.real = grid_state, {}
        self.ms = {name: [] for name in self.NAMES}
        for name in self.NAMES:
            real = self.real[name] = getattr(grid_state, name)

            def timed(*args, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*args, **kw)
                torch.cuda.synchronize()
                self.ms[_name].append((time.perf_counter() - t0) * 1e3)
                return out
            setattr(grid_state, name, timed)
        return self.ms

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.mod, name, real)
        return False


def grid_run(ds, dev, n, mode="async", rc=None, **grid_kw):
    """The phase's runs on the full-width EMNIST CNN from seed 0: async,
    the async DP path's configuration (pareto-mobile, concurrency 12, goal
    6, polynomial staleness, int8 with per-flush DP); sync, the quickstart
    at ``uplink_bits=8``; ``grid_kw`` adds GridConfig fields."""
    from repro_torch.models import paper_models as pm
    from repro_torch.sim import grid
    if mode == "async":
        base = dict(mode="async", fleet="pareto-mobile",
                    concurrency=CONCURRENCY, goal_count=GOAL,
                    staleness="polynomial")
        rc = rc or quickstart_rc(8, dp=True)
    else:
        base = dict(mode="sync")
        rc = rc or quickstart_rc(8)
    return grid.run_grid(lambda s: pm.init_emnist_cnn(s, device=dev),
                         emnist_loss, ds, rc, n,
                         grid=grid.GridConfig(**{**base, **grid_kw}),
                         freeze_spec=pm.EMNIST_FREEZE, seed=0, device=dev)


def same_run(a, b) -> bool:
    """Bit for bit: the history (losses, norms, clock, staleness), every
    leaf of y, the scheduler stats, the measured and per-hop bytes and
    the DP summary."""
    return (a.history == b.history
            and all(torch.equal(x, z) for x, z in zip(leaves_of(a.y),
                                                      leaves_of(b.y)))
            and a.scheduler_stats == b.scheduler_stats
            and (a.comm.measured_down_bytes, a.comm.measured_up_bytes,
                 a.comm.transfers, a.comm.hop_traffic)
            == (b.comm.measured_down_bytes, b.comm.measured_up_bytes,
                b.comm.transfers, b.comm.hop_traffic)
            and a.dp == b.dp)


def kill_and_resume(label, ds, dev, tmp, straight, n, mode, faults, expect,
                    **grid_kw):
    """``straight``'s configuration killed halfway between updates (rounds)
    n // 2 and n // 2 + 1, snapshotting every CKPT_EVERY, then resumed
    from the kill's checkpoint with the launch counts set to 0 just
    before and read just after; the resumed run must equal ``straight``
    bit for bit, and launch each kernel of ``expect``. Returns the
    resumed segment's launch counts."""
    from repro_torch import kernels
    from repro_torch.sim import faults as faults_lib
    k = n // 2
    kill = 0.5 * (straight.history[k - 1]["virtual_seconds"]
                  + straight.history[k]["virtual_seconds"])
    ckdir = os.path.join(tmp, label.replace(" ", "_"))
    try:
        grid_run(ds, dev, n, mode, faults=dict(faults, server_kill_at=kill),
                 checkpoint_every=CKPT_EVERY, checkpoint_dir=ckdir,
                 **grid_kw)
        raise AssertionError(f"{label}: the server was not killed at "
                             f"{kill:.4f}")
    except faults_lib.ServerKilled as e:
        snap = e.checkpoint
    kernels.reset_launches()
    resumed = grid_run(ds, dev, n, mode, faults=faults, resume_from=snap,
                       **grid_kw)
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    same = same_run(straight, resumed)
    print(f"  {label}: killed at virtual {kill:.4f} s (between updates {k} "
          f"and {k + 1}), resumed from {os.path.basename(snap)}: history, y, "
          f"stats, bytes, hops, dp bit for bit {same}; resumed segment's "
          f"launches {counts}")
    if not same:
        raise AssertionError(f"{label}: the resumed run differs from the "
                             f"straight run")
    check_expected(label, counts, expect)
    return counts


def profiled_copies(run, n: int) -> dict:
    """Blocking copies and syncs a flush in the steady state: those of a
    profiled run of 2n updates less those of a run of n (which cancels
    the run's set-up), over n."""
    from torch.profiler import ProfilerActivity, profile
    totals = []
    for updates in (n, 2 * n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(updates)
            torch.cuda.synchronize()
        totals.append({name: sum(e.count for e in prof.key_averages()
                                 if e.key == name)
                       for name in HOST_COPY_OPS})
    return {name: round((totals[1][name] - totals[0][name]) / n, 2)
            for name in HOST_COPY_OPS}


def in_turns(runs: dict) -> None:
    """Prints each run's update wall (``seconds_per_round``,
    synchronized), WALL_RUNS times each in turns (the order reversed every
    other turn), as the median with the range, in ms."""
    n = WALL_RUNS
    walls = {label: [] for label in runs}
    order = list(runs)
    for i in range(n):
        for label in (order if i % 2 == 0 else order[::-1]):
            walls[label].append(1e3 * runs[label]().seconds_per_round)
    print("  update wall (seconds_per_round, synchronized), median [min, "
          f"max] of {n} runs in turns: " + ", ".join(
              f"{label} {float(np.median(v)):.3f} [{min(v):.3f}, "
              f"{max(v):.3f}] ms" for label, v in walls.items()))


def drive_resume_topology(ds, dev):
    """Phase 6 on the full-width EMNIST CNN, under
    ``torch.backends.cudnn.deterministic = True``, snapshots in a
    temporary directory. Returns the launch counts of the main-path
    segments (the two resumed runs and the shocked 4-region run), each
    set to 0 just before its run and read just after."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint import grid_state
    from repro_torch.sim import dynamics as dyn_lib
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    launches = {name: 0 for name in {**kernels.LAUNCHES, **kernels.ROUTES}}

    def add(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)
    lane_expect = ("fake_quantize_flat", "fake_quantize_flat/cluster",
                   "clip_flat", "clip_flat/cluster")
    shocks = dyn_lib.DynamicsConfig(
        shocks=dyn_lib.RegionShocks(**REGION_SHOCKS))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # 1. async kill -> resume, chaos faults + screen + jitter
            chaos = dict(sanitize=True, dynamics="jitter")
            print(f"[resume] async FedBuff int8 + per-flush DP, "
                  f"{ASYNC_UPDATES} updates, faults {CHAOS}, sanitize, "
                  f"jitter, snapshots every {CKPT_EVERY}")
            straight = grid_run(ds, dev, ASYNC_UPDATES, faults=CHAOS,
                                **chaos)
            with snapshot_timer() as ms:
                ckpt = grid_run(ds, dev, ASYNC_UPDATES, faults=CHAOS,
                                checkpoint_every=CKPT_EVERY,
                                checkpoint_dir=os.path.join(tmp, "every2"),
                                **chaos)
            snaps = sorted(os.listdir(os.path.join(tmp, "every2")))
            nbytes = [os.path.getsize(os.path.join(tmp, "every2", f))
                      for f in snaps]
            print(f"  straight run: losses "
                  f"{[round(h['loss'], 4) for h in straight.history]}, "
                  f"stats {straight.scheduler_stats}, dp {straight.dp}")
            again = grid_run(ds, dev, ASYNC_UPDATES, faults=CHAOS, **chaos)
            print(f"  the straight run again: bit for bit the first "
                  f"{same_run(straight, again)}")
            print(f"  the same with checkpoint_every={CKPT_EVERY}: bit for "
                  f"bit the straight run {same_run(straight, ckpt)}; "
                  f"{len(snaps)} snapshots of {nbytes} bytes; encode "
                  f"{[round(v, 3) for v in ms['encode_async']]} ms, "
                  f"save_state {[round(v, 3) for v in ms['save_state']]} ms")
            fresh = itertools.count()
            in_turns({"off": lambda: grid_run(
                ds, dev, ASYNC_UPDATES, faults=CHAOS, **chaos),
                f"checkpoint_every={CKPT_EVERY}": lambda: grid_run(
                    ds, dev, ASYNC_UPDATES, faults=CHAOS,
                    checkpoint_every=CKPT_EVERY, checkpoint_dir=os.path.join(
                        tmp, f"w{next(fresh)}"), **chaos)})
            if not (same_run(straight, ckpt) and same_run(straight, again)) \
                    or len(snaps) != ASYNC_UPDATES // CKPT_EVERY:
                raise AssertionError("async: the run is not reproducible, "
                                     "or snapshots changed it or went "
                                     "missing")
            path = os.path.join(tmp, "every2", snaps[-1])
            meta, arrays = grid_state.load_state(path)
            load_ms = wall_ms(lambda: grid_state.load_state(path), 5)
            fresh = itertools.count()
            save_ms = wall_ms(lambda: grid_state.save_state(
                os.path.join(tmp, f"copy{next(fresh)}.npz"), meta, arrays),
                5)
            up_ms = wall_ms(lambda: grid_state.unpack_tree("y", arrays,
                                                           dev), 5)
            print(f"  last snapshot ({nbytes[-1]} bytes, {len(arrays)} "
                  f"arrays): save_state {save_ms:.3f} ms, load_state "
                  f"{load_ms:.3f} ms, y back to the card {up_ms:.3f} ms "
                  f"(medians of 5)")
            with snapshot_timer() as ms:
                add(kill_and_resume("async kill -> resume", ds, dev, tmp,
                                    straight, ASYNC_UPDATES, "async", CHAOS,
                                    lane_expect, **chaos))
            print(f"  resume: load_state {[round(v, 3) for v in ms['load_state']]}"
                  f" ms, decode_async "
                  f"{[round(v, 3) for v in ms['decode_async']]} ms")

            # 2. sync kill -> resume, the quickstart at int8
            crash = {"crash_compute": 0.1}
            print(f"[resume] sync quickstart, uplink_bits=8, {ROUNDS} rounds,"
                  f" faults {crash}")
            sync = grid_run(ds, dev, ROUNDS, "sync", faults=crash)
            print(f"  straight run: losses "
                  f"{[round(h['loss'], 4) for h in sync.history]}, stats "
                  f"{sync.scheduler_stats}")
            add(kill_and_resume("sync kill -> resume", ds, dev, tmp, sync,
                                ROUNDS, "sync", crash,
                                ("sumsq", "fake_quantize_flat",
                                 "fake_quantize_flat/cluster")))

            # 3. the edge topology, async DP path
            flat = grid_run(ds, dev, ASYNC_UPDATES)
            one = grid_run(ds, dev, ASYNC_UPDATES, topology=1)
            four = grid_run(ds, dev, ASYNC_UPDATES, topology=REGIONS)
            ce = four.comm.hop_traffic["client_edge"]
            same_one = (one.history == flat.history and all(
                torch.equal(a, b) for a, b in zip(leaves_of(one.y),
                                                  leaves_of(flat.y))))
            same_four = (four.history == flat.history and all(
                torch.equal(a, b) for a, b in zip(leaves_of(four.y),
                                                  leaves_of(flat.y))))
            ledger = ((ce["down_bytes"], ce["up_bytes"], ce["transfers"])
                      == (flat.comm.measured_down_bytes,
                          flat.comm.measured_up_bytes, flat.comm.transfers))
            print(f"[topology] async DP path, {ASYNC_UPDATES} updates: one "
                  f"region bit for bit flat {same_one}; {REGIONS} regions: "
                  f"y and history bit for bit flat {same_four}, client_edge "
                  f"hop == flat ledger {ledger}; hops "
                  f"{four.comm.hop_traffic}")
            in_turns({"flat": lambda: grid_run(ds, dev, ASYNC_UPDATES),
                      "1 region": lambda: grid_run(ds, dev, ASYNC_UPDATES,
                                                   topology=1),
                      f"{REGIONS} regions": lambda: grid_run(
                          ds, dev, ASYNC_UPDATES, topology=REGIONS)})
            if not (same_one and same_four and ledger
                    and four.comm.hop_traffic["edge_server"]["uploads"]):
                raise AssertionError("topology: a region layout moved the "
                                     "model, or the hops miss the ledger")
            n_prof = ASYNC_CHECKED
            copies = {
                "flat": profiled_copies(
                    lambda n: grid_run(ds, dev, n), n_prof),
                f"{REGIONS} regions, telemetry off": profiled_copies(
                    lambda n: grid_run(ds, dev, n, topology=REGIONS),
                    n_prof),
                f"{REGIONS} regions, telemetry on": profiled_copies(
                    lambda n: grid_run(ds, dev, n, topology=REGIONS,
                                       telemetry=True), n_prof)}
            print(f"  copies and syncs a flush (profiled runs of "
                  f"{2 * n_prof} less {n_prof} updates, over {n_prof}): "
                  f"{copies}")

            # shocked regions: the card against the CPU, then kill -> resume;
            # crashes on, so that the kill's fault stream is the straight
            # run's (the shock stream is the next spawned child)
            regional = dict(topology=REGIONS, dynamics=shocks, faults=crash,
                            telemetry=True)
            task = dict(emnist_async(), label=f"{REGIONS} regions, shocked",
                        grid=regional)
            kernels.reset_launches()
            shocked = grid_run(ds, dev, ASYNC_UPDATES, **regional)
            counts = {**kernels.LAUNCHES, **kernels.ROUTES}
            add(counts)
            fired = [e for e in shocked.telemetry.events
                     if e.kind == "shock"]
            edges = [e for e in shocked.telemetry.events
                     if e.kind == "edge_flush"]
            print(f"[topology] {REGIONS} regions, shocks {REGION_SHOCKS}: "
                  f"{len(fired)} shocks fired (regions "
                  f"{[e.payload['region'] for e in fired]}), {len(edges)} "
                  f"edge flushes, stats {shocked.scheduler_stats}, virtual "
                  f"seconds {shocked.virtual_seconds:.4f}; launches {counts}")
            if not fired:
                raise AssertionError("shocked regions: no shock fired")
            check_expected(task["label"], counts, lane_expect)
            check_async_against_cpu(ds, dev, task)
            add(kill_and_resume(
                "shocked 4-region kill -> resume", ds, dev, tmp, shocked,
                ASYNC_UPDATES, "async", crash, lane_expect,
                **{k: v for k, v in regional.items() if k != "faults"}))

            # 4. profiling: torch.profiler ranges against the trace's flushes
            drive_profile_ranges(ds, dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return launches


def drive_profile_ranges(ds, dev):
    """One async run with ``TelemetryConfig(profile=True)`` inside
    ``torch.profiler.profile``: a ``grid/server_apply`` range a flush of
    the trace and a ``grid/lane_step[None]`` range a lane step; then the
    update wall with the ranges on and off, medians of WALL_RUNS runs of
    ASYNC_CHECKED updates, in turns."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import fedpt
    calls = {"lane": 0}
    make = fedpt.make_lane_step

    def counting(*args, **kw):
        step = make(*args, **kw)

        def run(*a):
            calls["lane"] += 1
            return step(*a)
        return run
    fedpt.make_lane_step = counting
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = grid_run(ds, dev, ASYNC_CHECKED,
                           telemetry={"profile": True})
            torch.cuda.synchronize()
    finally:
        fedpt.make_lane_step = make
    # the host ranges (the profiler mirrors each as device-side
    # annotations, one or more a range, which are not counted)
    from torch.autograd import DeviceType
    ranges = {name: sum(e.name == name and e.device_type == DeviceType.CPU
                        for e in prof.events())
              for name in ("grid/server_apply", "grid/lane_step[None]")}
    flushes = sum(e.kind == "flush" for e in res.telemetry.events)
    print(f"[profile] async run, {ASYNC_CHECKED} updates, profile=True: "
          f"ranges {ranges} against {flushes} trace flushes and "
          f"{calls['lane']} lane steps")
    if (ranges["grid/server_apply"], ranges["grid/lane_step[None]"]) != (
            flushes, calls["lane"]) or flushes != ASYNC_CHECKED:
        raise AssertionError("profile: the ranges do not match the flushes")
    in_turns({"profile off": lambda: grid_run(ds, dev, ASYNC_CHECKED),
              "profile on": lambda: grid_run(ds, dev, ASYNC_CHECKED,
                                             telemetry={"profile": True})})


# ---------------------------------------------------------------------------
# Phase 7: FedPT fine-tuning of Mixtral-8x7B at full width, and its serving

MIXTRAL = "mixtral-8x7b"
# of its 32 layers: reduced_config's depth for training, NeMo's serving
# cell's for serving; every width is the config's own
MIXTRAL_TRAIN_LAYERS, MIXTRAL_SERVE_LAYERS = 2, 4
MIXTRAL_ROUNDS = 8        # examples/federated_llm_finetune.py's rounds
# (trainable, total, flat size) at 2 layers: the two embedding tables
# (262,144,000), 41,984,000 a layer and the final norm (4,096) train, every
# leaf a multiple of the flat layout's 1,024; the routed experts'
# 1,409,286,144 a layer are frozen
MIXTRAL_TRAIN_SPLIT = (346_116_096, 3_164_688_384, 346_116_096)
# (trainable f32, frozen bf16) of the 4 serving layers
MIXTRAL_SERVE_SPLIT = (430_084_096, 5_637_144_576)
MOE_CHECK_TOKENS = 512
# moe_ffn against its dense oracle, float32 compute: tests/test_moe.py's
# bounds
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5
# the profiler ranges of the prefill's split: nn/moe's, nn/attention's,
# nn/ssm's and models/decoder_lm's functions (module, name), by kind
RANGES = {("moe", "router_topk"): "dispatch",
          ("moe", "_sort_dispatch"): "dispatch",
          ("moe", "_combine_local"): "dispatch",
          ("moe", "_experts"): "experts",
          ("attention", "mla_qkv"): "mla",
          ("ssm", "mamba_forward"): "mamba",
          ("ssm", "_mamba_scan"): "mamba_scan",
          ("ssm", "mlstm_forward"): "mlstm",
          ("ssm", "slstm_forward"): "slstm",
          ("decoder_lm", "encode"): "encoder",
          ("decoder_lm", "_cross_attend"): "cross_attn"}


def range_module(mod: str):
    """The port's module of a RANGES entry: ``models/decoder_lm`` or one
    of ``nn/``."""
    import importlib
    pkg = "models" if mod == "decoder_lm" else "nn"
    return importlib.import_module(f"repro_torch.{pkg}.{mod}")


class round_timer:
    """Times every round of the round functions that
    ``fedpt.make_round_fn`` builds inside a ``with`` (host clock between two
    ``torch.cuda.synchronize``), in ms."""

    def __enter__(self):
        from repro_torch.core import fedpt
        self.mod, self.real, ms = fedpt, fedpt.make_round_fn, []

        def make(*args, **kw):
            round_fn, sopt = self.real(*args, **kw)

            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = round_fn(*a, **k)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed, sopt
        fedpt.make_round_fn = make
        return ms

    def __exit__(self, *exc):
        self.mod.make_round_fn = self.real
        return False


def timed_init(init_fn):
    """``init_fn`` wrapped to record, per call, (seconds on the card, peak
    device memory in GiB since the call began)."""
    out = []

    def init(seed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_fn(seed)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated() / 2 ** 30))
        return params
    return init, out


def check_moe_full_width(params, cfg, dev):
    """``moe_ffn`` against ``moe_ffn_dense_fallback`` on MOE_CHECK_TOKENS
    Gaussian tokens through layer 0's router and experts at full width,
    float32 compute (TF32 off) and capacity factor 8.0 (capacity 1,024
    slots an expert: no token drops), within MOE_RTOL / MOE_ATOL."""
    from repro_torch.nn import basic
    from repro_torch.nn import moe as moe_lib
    p = basic.tree_map(lambda t: t[0], params["layers"]["slot0"]["moe"])
    c = cfg.with_(moe_capacity_factor=8.0, compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((MOE_CHECK_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    got, aux = moe_lib.moe_ffn(x, p, c)
    want, aux_d = moe_lib.moe_ffn_dense_fallback(x, p, c)
    err = (got - want).abs()
    worst = float((err / (MOE_ATOL + MOE_RTOL * want.abs())).max())
    print(f"  moe_ffn vs moe_ffn_dense_fallback at full width ({x.shape[0]} "
          f"tokens, float32, capacity {moe_lib.capacity(x.shape[0], c)} an "
          f"expert): max |diff| {float(err.max()):.3e}, {worst:.3f} of rtol "
          f"{MOE_RTOL} / atol {MOE_ATOL}; aux {float(aux):.6f} / "
          f"{float(aux_d):.6f}")
    if not (worst <= 1.0 and float(aux) == float(aux_d)):
        raise AssertionError("moe_ffn disagrees with its dense oracle at "
                             "full width")


def stub_note(cfg) -> str:
    """What the stubbed frontend feeds the VLM or the encoder-decoder in
    ``arch_task``'s rounds, for the phase lines."""
    if cfg.family == "vlm":
        return (f" after {cfg.num_prefix_tokens} zero patch embeddings "
                f"({cfg.num_prefix_tokens + 32} positions)")
    if cfg.is_encoder_decoder:
        return f" against {cfg.encoder_seq_len} zero frames"
    return ""


def zoo_widths(cfg) -> str:
    """A config's widths, for the phase headers."""
    from repro_torch.nn import ssm
    if cfg.family in ("vlm", "audio"):
        front = (f"{cfg.num_prefix_tokens} prefix positions from "
                 f"{cfg.num_prefix_tokens} x 1152 patch embeddings"
                 if cfg.family == "vlm" else
                 f"{cfg.encoder_layers} encoder layers over "
                 f"{cfg.encoder_seq_len} frames, cross-attention in each "
                 f"decoder layer")
        return (f"d_model {cfg.d_model}, {cfg.num_heads} heads over "
                f"{cfg.num_kv_heads} kv heads of {cfg.resolved_head_dim}, "
                f"{cfg.norm_type}, {'gated ' if cfg.gated_mlp else ''}"
                f"{cfg.act} d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {front}")
    if cfg.family == "ssm":
        d_in, nh, dh = ssm.xlstm_dims(cfg)
        return (f"d_model {cfg.d_model}, mLSTM {nh} heads of {dh} (d_in "
                f"{d_in}), an sLSTM block every {cfg.slstm_every} (gated FFN "
                f"{ssm.slstm_up_width(cfg.d_model)}), vocab {cfg.vocab_size}")
    attn = (f"MLA kv_lora {cfg.kv_lora_rank} / q_lora {cfg.q_lora_rank}, "
            f"q / k heads {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, "
            f"v heads {cfg.v_head_dim}" if cfg.use_mla else
            f"{cfg.num_kv_heads} kv heads, head_dim {cfg.resolved_head_dim}")
    shared = (f" + {cfg.num_shared_experts} shared"
              if cfg.num_shared_experts else "")
    mamba = (f"Mamba d_inner {ssm.mamba_dims(cfg)[0]}, d_state "
             f"{cfg.mamba_d_state} in {cfg.attn_period - 1} of every "
             f"{cfg.attn_period} layers, " if cfg.family == "hybrid" else "")
    return (f"d_model {cfg.d_model}, {mamba}{cfg.num_heads} heads, {attn}, "
            f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}{shared} "
            f"of {cfg.expert_d_ff}, vocab {cfg.vocab_size}, window "
            f"{cfg.sliding_window}")


def train_split(cfg):
    """(trainable, total, flat size) of ``cfg``'s FedPT split, counted on
    meta tensors."""
    from repro_torch.core import flat as flat_lib, partition as part
    from repro_torch.models import decoder_lm as dlm
    y, z = part.partition(dlm.init_model(cfg, 0, device="meta"),
                          cfg.freeze_spec)
    n_y = part.count_params(y)
    return n_y, n_y + part.count_params(z), flat_lib.FlatLayout.of(y).size


def float64_sumsq(x, piece: int = 1 << 26) -> float:
    """sum(x**2) in float64, a piece of ``x`` at a time (a float64 copy of
    1.25 G values would take 10 GB)."""
    return float(sum(x[a:a + piece].double().pow(2).sum()
                     for a in range(0, x.numel(), piece)))


def drive_zoo_training(arch, layers, rounds, split, dev, after=None,
                       by_op=True, encoder_layers=None, may_overflow=(),
                       **tols):
    """FedPT on ``arch`` at full width, ``layers`` of its layers (and
    ``encoder_layers`` of an encoder-decoder's encoder layers), the
    config's dtypes (float32 parameters, bf16 compute) and freeze spec
    (the routed experts frozen; the rest trained), ``rounds`` rounds
    through ``runtime.run_federated`` with ``run_reduced_arch``'s data and
    round configuration, the launch counts set to 0 just before and read
    just after. Gates: the (trainable, total, flat size) ``split``, a
    finite falling loss, sumsq launched once a round at the flat width and
    within ``dp_clip.sumsq_rtol`` of a float64 sum of the trained y there
    (where that sum passes float32's range: inf, the leaves whose own sums
    pass it exactly ``may_overflow``, and the bound held on the trained y
    with those leaves zeroed, at the same width); then sumsq timed
    at that width, the peak memory with the init and around one client
    update, one profiled round and (with ``by_op``; else the round's
    CUDA activity alone) its device time by op, ``after(params, cfg)`` on
    the trained parameters, and one round of the reduced config card vs
    CPU (``check_model_round`` with ``tols``). Returns the launch
    counts."""
    from types import SimpleNamespace
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import fedpt, flat as flat_lib, partition as part
    from repro_torch.fl import runtime
    from repro_torch.kernels import dp_clip, ref
    from repro_torch.launch import train
    from repro_torch.nn import basic, threefry

    # the caching allocator keeps what earlier phases freed in segments of
    # their sizes; the 1.25 G-value buffers here need them released
    torch.cuda.empty_cache()
    full = get_config(arch)
    cut = {"num_layers": layers}
    depth = f"{layers} of {full.num_layers} layers"
    if encoder_layers is not None:
        cut["encoder_layers"] = encoder_layers
        depth = (f"{encoder_layers} of {full.encoder_layers} encoder and "
                 f"{depth}")
    at = train.arch_task(full.with_(**cut), 0, dev)
    cfg = at.cfg
    n_y, n, size = train_split(cfg)
    print(f"[{arch}] FedPT, {depth} at full "
          f"width ({zoo_widths(cfg)}; {cfg.param_dtype} parameters, "
          f"{cfg.compute_dtype} compute): {n_y} of {n} trainable "
          f"({100 * n_y / n:.2f}%), flat size {size}, freeze spec "
          f"{cfg.freeze_spec}")
    if (n_y, n, size) != split:
        raise AssertionError(f"{arch}'s (trainable, total, flat size) "
                             f"{(n_y, n, size)}, not {split}")
    init_fn, init_s = timed_init(at.init_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with round_timer() as walls, width_spy((("dp_clip", "sumsq"),)) as widths:
        res = runtime.run_federated(
            init_fn, at.loss_fn, at.dataset, at.rc, rounds,
            freeze_spec=cfg.freeze_spec, seed=0, data_kind="tokens",
            device=dev)
    counts = {**kernels.LAUNCHES, **kernels.ROUTES}
    losses = [h["loss"] for h in res.history]
    print(f"[main path] {arch} FedPT, {rounds} rounds of "
          f"{at.rc.clients_per_round} clients x {at.rc.local_steps} SGD steps "
          f"x {at.rc.local_batch} sentences of 32 tokens{stub_note(cfg)}: "
          f"losses "
          f"{[round(v, 4) for v in losses]} (ln {cfg.vocab_size} = "
          f"{math.log(cfg.vocab_size):.4f})")
    print(f"  init_model on the card {init_s[0][0]:.2f} s, peak device "
          f"memory {init_s[0][1]:.2f} GiB (threefry draws in pieces of "
          f"{threefry.PIECE}); round wall ms {[round(v, 3) for v in walls]} "
          f"(median {float(np.median(walls)):.3f}, first round included); "
          f"seconds_per_round {1e3 * res.seconds_per_round:.3f} ms; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; launches {counts}; sumsq by width {dict(widths)}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch} FedPT: losses not finite or not "
                             f"falling")
    if counts["sumsq"] != rounds or \
            dict(widths) != {("sumsq", size): rounds}:
        raise AssertionError(f"{arch} FedPT: sumsq not once a round at "
                             f"{size}: {counts['sumsq']}, {dict(widths)}")

    # sumsq at the trainable width: the trained y's flat vector
    x = flat_lib.FlatLayout.of(res.y).flatten(res.y)
    got, want = float(dp_clip.sumsq(x)), float64_sumsq(x)
    top = max(((float(t.abs().max()), path)
               for path, t in basic.flatten_params(res.y)))
    print(f"  the trained y's largest |entry| {top[0]:.4e}, in {top[1]}")
    f32_max = float(torch.finfo(torch.float32).max)
    if want > f32_max:
        # the float32 sum overflows: its float32 answer is inf. Only the
        # leaves named in may_overflow may pass float32's range (PaliGemma's
        # mm_proj bias: its first step from 0 under the zero patch
        # embeddings carries 1 / sqrt(eps) a layer, as the reference's
        # does: tests/test_torch_vlm.py); the kernel is then held within
        # its bound on the trained y with those leaves zeroed
        over = sorted(path for path, t in basic.flatten_params(res.y)
                      if float64_sumsq(t.reshape(-1)) > f32_max)
        print(f"  sumsq at n = {x.numel()} of the trained y: {got!r} against "
              f"the float64 sum {want!r}, past float32's range in {over}")
        if got != math.inf or over != sorted(may_overflow):
            raise AssertionError(f"sumsq at {arch}'s width: {got!r} where "
                                 f"the float32 sum overflows, in {over} "
                                 f"(allowed: {list(may_overflow)})")
        del x
        y1 = basic.unflatten_params({
            path: torch.zeros_like(t) if path in over else t
            for path, t in basic.flatten_params(res.y)})
        x = flat_lib.FlatLayout.of(y1).flatten(y1)
        del y1
        got, want = float(dp_clip.sumsq(x)), float64_sumsq(x)
        print(f"  with {over} zeroed:")
    rtol = dp_clip.sumsq_rtol(x.numel())
    print(f"  sumsq at n = {x.numel()} (grid {dp_clip.sumsq_plan(x.numel())[0]}"
          f", chunk {dp_clip.sumsq_plan(x.numel())[1]} quads): {got!r} "
          f"against the float64 sum {want!r}, rel err "
          f"{abs(got - want) / want:.3e} (bound sumsq_rtol {rtol:.3e})")
    if not abs(got - want) <= rtol * want:
        raise AssertionError(f"sumsq off its a-priori bound at {arch}'s "
                             f"width")
    rec, = kernel_records([
        ("sumsq", "src/repro_torch/kernels/csrc/sumsq.cu",
         "src/repro/kernels/dp_clip.py:54", lambda: dp_clip.sumsq(x),
         lambda: ref.flat_sumsq_ref(x), lambda: torch.dot(x, x),
         AB_KERNELS["sumsq"], 4 * x.numel(), 2 * x.numel())],
        iters=(20, 3, 10))
    print(f"  sumsq at n = {x.numel()}: wrapper {rec['ms']:.5f} ms, device "
          f"{fmt_ms(rec['device_ms'])} ms, bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms, torch.dot "
          f"{rec['library_ms']:.5f} ms (device "
          f"{fmt_ms(rec['library_device_ms'])} ms), max abs err "
          f"{rec['max_abs_err']:.3e}")
    del x
    torch.cuda.empty_cache()

    pt = SimpleNamespace(loss_fn=at.loss_fn, rc=at.rc, dataset=at.dataset,
                         kind="tokens")
    batch, w = task_draws(pt, 1)[0]
    peak, above = client_peak_mib(pt, res.y, res.frozen, batch, at.rc, dev)
    print(f"  peak device memory around one client update: {peak:.1f} MiB "
          f"({above:.1f} MiB above what was held before it)")
    round_fn, sopt = fedpt.make_round_fn(at.loss_fn, at.rc, device=dev)
    sstate = sopt.init(res.y)
    profile_round(lambda: round_fn(res.y, sstate, res.frozen, batch, w,
                                   threefry.key(rounds)), host=by_op)
    if by_op:
        ops = device_time_by_op(lambda: round_fn(
            res.y, sstate, res.frozen, batch, w, threefry.key(rounds)))
        print(f"  a round's device ms ({sum(ops.values()):.3f}) by op: "
              f"{top_ops(ops, 12)}")
    del sstate
    if after is not None:
        after(part.merge(res.y, res.frozen), cfg)
    del res
    torch.cuda.empty_cache()
    check_reduced_round(arch, dev, **tols)
    return counts


def check_reduced_round(arch, dev, **tols):
    """One round of ``arch``'s reduced config (float32 compute), card vs
    CPU: ``check_model_round`` with ``tols``."""
    from types import SimpleNamespace
    from repro_torch.configs.base import get_config
    from repro_torch.core import partition as part
    from repro_torch.launch import train
    rat = train.arch_task(train.reduced_config(get_config(arch)), 0, dev)
    rpt = SimpleNamespace(loss_fn=rat.loss_fn, rc=rat.rc,
                          dataset=rat.dataset, kind="tokens")
    y0, frozen = part.partition(rat.init_fn(0), rat.cfg.freeze_spec)
    check_model_round(f"{arch} reduced ({zoo_widths(rat.cfg)}, float32)",
                      rpt, y0, frozen, *task_draws(rpt, 1)[0], dev, **tols)


def drive_mixtral_training(dev):
    """Phase 7's training path: ``drive_zoo_training`` on Mixtral-8x7B, 2
    of its 32 layers, MIXTRAL_ROUNDS rounds, with ``moe_ffn`` held to its
    dense oracle at full width on the trained parameters."""
    return drive_zoo_training(
        MIXTRAL, MIXTRAL_TRAIN_LAYERS, MIXTRAL_ROUNDS, MIXTRAL_TRAIN_SPLIT,
        dev, after=lambda params, cfg: check_moe_full_width(params, cfg, dev))


class routing_spy:
    """Records the expert ids of every ``nn/moe.router_topk`` call inside a
    ``with`` (``ids``, in call order); given ``replay`` (ids in the same
    call order), routes each call to those ids instead, its weights its
    own float32 probabilities there, renormalized as ``router_topk`` does,
    and counts the tokens whose own top-k differs (``flipped`` of
    ``routed``). Two bf16 computations of one model round differently,
    and a router near-tie then sends a token to another expert, which
    moves its output far more than the rounding; replaying one side's
    routing holds the rest of the two computations against each other.
    Each thread replays from the first call (a thread a rank of a
    threaded mesh, every rank routing the same tokens, or, where a rank
    routes only its rows of the batch, the tokens from ``offsets[thread
    ident]`` on)."""

    def __init__(self, replay=None):
        self.replay = replay
        self.ids, self.flipped, self.routed = [], 0, 0
        self.calls, self.offsets = {}, {}

    def __enter__(self):
        from repro_torch.nn import basic, moe as moe_lib
        self.mod, self.real = moe_lib, moe_lib.router_topk

        def spy(x, p, cfg):
            w, idx, aux = self.real(x, p, cfg)
            if self.replay is not None:
                call = self.calls.get(threading.get_ident(), 0)
                self.calls[threading.get_ident()] = call + 1
                t0 = self.offsets.get(threading.get_ident(), 0)
                want = self.replay[call][t0:t0 + idx.shape[0]].to(
                    idx.device, idx.dtype)
                self.flipped += int((idx.sort(-1).values
                                     != want.sort(-1).values).any(-1).sum())
                probs = torch.softmax(
                    basic.dense(x, p["router"], torch.float32), dim=-1)
                w = probs.gather(-1, want.long())
                w = (w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
                     ).to(x.dtype)
                idx = want
            self.routed += idx.shape[0]
            if self.replay is None:
                self.ids.append(idx)
            return w, idx, aux
        moe_lib.router_topk = spy
        return self

    def __exit__(self, *exc):
        self.mod.router_topk = self.real
        return False


def device_time_by_op(fn, launched=None):
    """Device time (ms) of one call of ``fn``, after a warm-up call, by
    (kind, op). The RANGES functions of ``nn/moe`` and ``nn/attention``
    run inside profiler ranges, and a device kernel counts for the op that
    launched it: its kind is the RANGES kind of the range that holds that
    op ("experts": the expert FFNs; "dispatch": routing, dispatch and
    combine; "mla": MLA's q, kv and up projections and RoPE; "mamba":
    Mamba's projections and conv, "mamba_scan" its time loop; "mlstm" /
    "slstm": the xLSTM blocks; "encoder": the encoder-decoder's encoder
    pass, "cross_attn" its decoder's cross-attention projections), the
    innermost one where ranges nest,
    "attention" for the swa_attention kernel, else "other"; its op is the
    launching aten op, behind the autograd function whose backward runs
    it. The ranges' device-side copies, which span their kernels, count
    for none; device time no op claims is ("other", "unattributed").
    ``launched``, a dict, gets the number of device kernels by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = {(mod, name): getattr(range_module(mod), name)
             for mod, name in RANGES}
    kinds = {f"range/{name}": kind for (_, name), kind in RANGES.items()}

    def ranged(name, real):
        def call(*a, **kw):
            with record_function(f"range/{name}"):
                return real(*a, **kw)
        return call

    def put(wrap):
        for (mod, name), real in saved.items():
            setattr(range_module(mod), name,
                    ranged(name, real) if wrap else real)
    put(True)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        put(False)
    out = {}

    def add(key, ms):
        out[key] = out.get(key, 0.0) + ms
    events = prof.events()
    total = 0.0
    for ev in events:
        if ev.device_type == DeviceType.CUDA and \
                not ev.name.startswith("range/"):
            t = (ev.time_range.end - ev.time_range.start) / 1e3
            total += t
            if "swa_kernel" in ev.name:
                add(("attention", "swa_kernel"), t)
                if launched is not None:
                    launched["attention"] = launched.get("attention", 0) + 1
    backward = "autograd::engine::evaluate_function: "
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        kind, op, parent = None, ev.name, ev.cpu_parent
        while parent is not None:
            if kind is None and parent.name in kinds:
                kind = kinds[parent.name]
            elif parent.name.startswith(backward) and op == ev.name:
                op = f"{parent.name[len(backward):]} > {ev.name}"
            parent = parent.cpu_parent
        kind = kind or "other"
        for k in ev.kernels:
            if "swa_kernel" not in k.name:
                add((kind, op), k.duration / 1e3)
                if launched is not None:
                    launched[kind] = launched.get(kind, 0) + 1
    add(("other", "unattributed"), total - sum(out.values()))
    return out


def ssm_walls(fn):
    """Host wall (ms) of one call of ``fn`` inside each recurrent block
    (``nn/ssm``'s Mamba scan, mLSTM and sLSTM forwards), the card
    synchronized before and after each block's call, by kind."""
    from repro_torch.nn import ssm
    names = {"_mamba_scan": "mamba_scan", "mlstm_forward": "mlstm",
             "slstm_forward": "slstm"}
    saved = {name: getattr(ssm, name) for name in names}
    out = {}

    def timed(name, real):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real(*a, **kw)
            torch.cuda.synchronize()
            kind = names[name]
            out[kind] = out.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
            return r
        return call
    for name, real in saved.items():
        setattr(ssm, name, timed(name, real))
    try:
        fn()
    finally:
        for name, real in saved.items():
            setattr(ssm, name, real)
    return out


def top_ops(by_op, n: int, kind=None):
    """The n largest (kind, op) entries of ``device_time_by_op`` (of one
    kind when given), as (label, ms rounded to 3 places)."""
    rows = [(f"{k}: {op}", ms) for (k, op), ms in by_op.items()
            if kind is None or k == kind]
    return [(label, round(ms, 3))
            for label, ms in sorted(rows, key=lambda r: -r[1])[:n]]


def cache_bytes(cache, slots):
    """(bytes a token of one attention layer's cache, bytes a sequence of
    the recurrent slots' states over all their layers) of an
    ``init_cache`` tree: the first grow with the length, the second do
    not."""
    kinds = [s.kind for s in slots]
    first = kinds.index("attn") if "attn" in kinds else None
    per_token = per_seq = 0
    for si, kind in enumerate(kinds):
        for t in cache["slots"][f"slot{si}"].values():
            if si == first:
                per_token += t[0, 0, 0].numel() * t.element_size()
            elif kind != "attn":
                per_seq += t[:, 0].numel() * t.element_size()
    return per_token, per_seq


def stub_inputs(cfg, rows: int, dev, seed: int = 0) -> dict:
    """The prefill batch's stubbed-frontend entries: the VLM's
    ``prefix_embeds`` (rows, num_prefix_tokens, 1152), the
    encoder-decoder's ``encoder_embeds`` (rows, encoder_seq_len, d_model),
    bf16 N(0, 1) from ``seed`` (the reference's prefill specs are bf16);
    nothing for the other families."""
    from repro_torch.models import decoder_lm as dlm
    if cfg.family == "vlm":
        shape = (rows, cfg.num_prefix_tokens, dlm.VISION_TOWER_DIM)
        name = "prefix_embeds"
    elif cfg.is_encoder_decoder:
        shape = (rows, cfg.encoder_seq_len, cfg.d_model)
        name = "encoder_embeds"
    else:
        return {}
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return {name: torch.randn(shape, generator=gen).to(dev, torch.bfloat16)}


def drive_zoo_serving(arch, layers, split, dev, consist_cf, windows=(),
                      prefill=(1, PREFILL_LEN), timed=3, profile=None,
                      stepped=None, stepped_f32=False,
                      decode_prompt=DECODE_PROMPT, consist=(1, CONSIST_LEN)):
    """Serving ``arch`` at full width, ``layers`` of its layers, from
    ``init_model(cfg, 0)`` on the card, on the serving split (trainable
    f32, frozen bf16); ``make_prefill_step`` on ``prefill`` (rows,
    tokens), with ``stub_inputs`` for the VLM (its prefix) and the
    encoder-decoder (its frames), under ``serving_config`` of prefill_32k,
    which must keep the config as it is (median of ``timed`` walls after
    one warm-up, positions/s, ``swa_attention`` once an attention call by
    the wrapper's count: once a layer, and for the encoder-decoder in each
    encoder layer and in each decoder layer's self- and cross-attention;
    at the ``profile`` shape, default the prefill's, the profiler's
    launches by kind (the kernel's among them) and a split into the
    attention kernel, expert matmuls, routing / dispatch / combine, MLA
    projections, Mamba's projections and scan, the mLSTM and sLSTM
    blocks, the encoder, cross-attention and the rest, and the host walls
    of the recurrent loops (``ssm_walls``)), then greedy ``generate``
    (batch 4, prompt ``decode_prompt``, 32 steps; an encoder-decoder
    against the encoder's K / V from ``build_cross_cache``, as a server
    runs it) with the attention cache's bytes a token, the cross cache's
    and the recurrent states' bytes a sequence, with the launch counts set
    to 0 just before and read just after; then, not counted, a
    ``consist`` (rows, tokens) prefill with the stub inputs through the
    kernel against the plain chunked attention (at the config's window and
    each of ``windows``; with attention slots only) and the step-by-step
    prefill against ``forward`` at capacity factor ``consist_cf`` (no
    drops; text only for the VLM, as its decode runs; against the cross
    cache of the same frames for the encoder-decoder), on the decode
    prompt, or with ``stepped`` (rows, tokens) on the first of the
    prefill's tokens, the second side of each routed as the first; with
    ``stepped_f32`` that check runs in float32 compute on the same
    weights, and the bf16 one on the decode prompt is printed, not gated.
    Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import partition as part
    from repro_torch.launch import serve, specs
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn import basic

    torch.cuda.empty_cache()
    full = get_config(arch)
    base = full.with_(num_layers=layers)
    slots, groups = dlm.layer_program(base)
    n_attn = groups * sum(s.kind == "attn" for s in slots)
    # the kernel's calls a prefill: the encoder's layers and the decoder's
    # cross-attention besides each attention layer's own
    n_calls = n_attn * (2 if base.is_encoder_decoder else 1) + (
        base.encoder_layers if base.is_encoder_decoder else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y, frozen = specs.serving_split(dlm.init_model(base, 0, device=dev), base)
    torch.cuda.synchronize()
    n_y, n_z = basic.tree_size(y), basic.tree_size(frozen)
    print(f"[serving] {arch}, {layers} of {full.num_layers} layers at full "
          f"width: init_model(cfg, 0) on the card and the serving split in "
          f"{time.perf_counter() - t0:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; trainable "
          f"{n_y} f32 ({basic.tree_bytes(y) / 1e9:.2f} GB), frozen {n_z} bf16 "
          f"({basic.tree_bytes(frozen) / 1e9:.2f} GB)")
    if (n_y, n_z) != split:
        raise AssertionError(f"the {arch} split {(n_y, n_z)} differs from "
                             f"{split} (trainable, frozen)")
    cfg = specs.serving_config(base, "prefill_32k")
    if cfg != base or specs.serving_config(base, "long_500k") != base:
        raise AssertionError(f"serving_config changed {arch}")
    rows, length = prefill
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, base.vocab_size, prefill, dtype=np.int64)
    prompt = rng.integers(0, base.vocab_size, (DECODE_BATCH, decode_prompt),
                          dtype=np.int64)
    step = specs.make_prefill_step(cfg, device=dev)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             **stub_inputs(cfg, rows, dev)}
    # the positions a prefill computes: the VLM's prefix and the
    # encoder's frames besides the tokens
    extra = (cfg.num_prefix_tokens if cfg.family == "vlm" else
             cfg.encoder_seq_len if cfg.is_encoder_decoder else 0)
    n_out = length + (extra if cfg.family == "vlm" else 0)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    walls = []
    for _ in range(1 + timed):   # the first call warms up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = step(y, frozen, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    per_call = kernels.LAUNCHES["swa_attention"] / len(walls)
    if logits.shape != (rows, n_out, base.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: logits not finite or of the "
                             f"wrong shape {tuple(logits.shape)}")
    del logits
    wall = float(np.median(walls[1:]))
    what = ("" if not extra else
            f" + {extra} prefix positions" if cfg.family == "vlm" else
            f" tokens + {extra} frames")
    print(f"[serving] {arch} prefill {rows} x {length}{what} (prefill_32k, "
          f"window {cfg.sliding_window}): wall ms "
          f"{[round(v, 3) for v in walls]} (median of the last {timed} "
          f"{wall:.3f} ms, {rows * (length + extra) / wall * 1e3:.1f} "
          f"positions/s); swa_attention {per_call:g} launches a call "
          f"({n_calls} attention calls); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    pbatch = batch
    if profile is not None and tuple(profile) != tuple(prefill):
        pbatch = {name: t[:profile[0], :profile[1]] if name == "tokens"
                  else t[:profile[0]] for name, t in batch.items()}
    pshape = tuple(pbatch["tokens"].shape)
    launched = {}
    by_op = device_time_by_op(lambda: step(y, frozen, pbatch), launched)
    # a trace may drop a long kernel (device_ms): the wrapper's count is
    # the gate, the profiler's must show the kernel on the card
    if per_call != n_calls or (n_calls and launched.get("attention", 0) < 1):
        raise AssertionError(f"{arch} prefill: swa_attention not once an "
                             f"attention call ({launched} recorded by the "
                             f"profiler)")
    split_ms = dict.fromkeys(("attention", "experts", "dispatch", "mla",
                              "mamba", "mamba_scan", "mlstm", "slstm",
                              "encoder", "cross_attn", "other"), 0.0)
    for (kind, _), ms in by_op.items():
        split_ms[kind] += ms
    busy = sum(split_ms.values())
    print(f"[serving] {arch} prefill {pshape[0]} x {pshape[1]}{what} device "
          f"ms by kind { {k: round(v, 3) for k, v in split_ms.items() if v} } "
          f"of {busy:.3f} ms: "
          + ", ".join(f"{k} {100 * v / busy:.1f}%"
                      for k, v in split_ms.items() if v)
          + f"; device kernels by kind {launched}")
    print(f"  device ms by op: {top_ops(by_op, 8)}; routing / dispatch / "
          f"combine by op: {top_ops(by_op, 6, 'dispatch')}; other by op: "
          f"{top_ops(by_op, 6, 'other')}")
    if any(s.kind != "attn" for s in slots):
        def per_position(slot_kind, kind):
            n = groups * sum(s.kind == slot_kind for s in slots)
            return launched.get(kind, 0) / max(1, n * pshape[1])
        loops = ssm_walls(lambda: step(y, frozen, pbatch))
        print(f"[serving] {arch} prefill {pshape[0]} x {pshape[1]}: host "
              f"wall of the recurrent blocks (synchronized at each call) "
              f"{ {k: round(v, 3) for k, v in loops.items()} } ms; launches "
              f"a Mamba scan position "
              f"{per_position('mamba', 'mamba_scan'):.3f}"
              f", an sLSTM position {per_position('slstm', 'slstm'):.3f}")

    params = part.merge(y, frozen)
    n_steps = decode_prompt + DECODE_STEPS
    cache = dlm.init_cache(cfg, DECODE_BATCH, n_steps, device=dev)
    per_token, per_seq = cache_bytes(cache, slots)
    cross_bytes = sum(t[:, 0].numel() * t.element_size() for entry in
                      cache.get("cross", {}).values() for t in entry.values())
    del cache
    cross = None
    if cfg.is_encoder_decoder:   # the encoder's K / V, made once a request
        frames = stub_inputs(cfg, DECODE_BATCH, dev, seed=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cross = dlm.build_cross_cache(params, cfg, frames["encoder_embeds"])
        torch.cuda.synchronize()
        print(f"[serving] {arch} build_cross_cache (batch {DECODE_BATCH} x "
              f"{cfg.encoder_seq_len} frames through the encoder): "
              f"{(time.perf_counter() - t1) * 1e3:.3f} ms")
    serve.generate(params, cfg, prompt, 2, device=dev, cross=cross)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seqs = serve.generate(params, cfg, prompt, DECODE_STEPS, device=dev,
                          cross=cross)
    torch.cuda.synchronize()
    gwall = (time.perf_counter() - t1) * 1e3
    counts = dict(kernels.LAUNCHES)
    print(f"[serving] {arch} generate (batch {DECODE_BATCH}, prompt "
          f"{decode_prompt}, {DECODE_STEPS} greedy steps, capacity factor "
          f"{cfg.moe_capacity_factor}"
          + (", against build_cross_cache's K / V" if cross else "")
          + f"): {gwall:.3f} ms, {gwall / n_steps:.3f} ms per decode step "
          f"({n_steps} steps with the step-by-step prefill); the cache holds "
          f"{per_token} bytes a token an attention layer ({per_token * n_attn} "
          f"over the {n_attn} layers), {cross_bytes} bytes a sequence of "
          f"cross-attention K / V and {per_seq} bytes a sequence of "
          f"recurrent state ({per_seq / 2**20:.3f} MiB, whatever the "
          f"length); row 0: {seqs[0].tolist()}; launches {counts}")
    if cfg.use_mla and \
            per_token != (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2:
        raise AssertionError(f"{arch}'s MLA cache: {per_token} bytes a "
                             f"token")
    if seqs.shape != (DECODE_BATCH, n_steps) or \
            not bool(((seqs >= 0) & (seqs < base.vocab_size)).all()):
        raise AssertionError(f"{arch} generate: tokens of the wrong shape or "
                             f"range")
    del cross

    # consistency on the card, with the same weights; the second side of
    # each pair takes the first side's routing (routing_spy)
    cbatch = {"tokens": torch.from_numpy(
        tokens[:consist[0], :consist[1]]).to(dev),
        **stub_inputs(cfg, consist[0], dev, seed=2)}
    for c in (cfg,) + tuple(cfg.with_(sliding_window=w) for w in windows):
        if not n_attn:
            break
        s = specs.make_prefill_step(c, device=dev)
        with routing_spy() as kern:
            got = s(y, frozen, cbatch)
        with routing_spy(kern.ids) as plain:
            want = plain_attention_forward(lambda: s(y, frozen, cbatch))
        rel = rel_to_max(got, want)
        print(f"[serving] {arch} prefill {consist[0]} x {consist[1]}{what} "
              f"(window {c.sliding_window}), kernel vs the plain chunked "
              f"attention on the card, routed as the kernel's side "
              f"({plain.flipped} of {plain.routed} routings would differ): "
              f"max |diff| / max |logit| {rel:.3e} (tolerance "
              f"{LOGIT_REL:.3e}), argmax agreement "
              f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.4f}")
        if not rel <= LOGIT_REL:
            raise AssertionError(f"{arch} prefill: kernel vs plain {rel}")
    sp = prompt if stepped is None else tokens[:stepped[0], :stepped[1]]
    frames = (stub_inputs(cfg, sp.shape[0], dev, seed=3)
              if cfg.is_encoder_decoder else {})
    cc = cfg.with_(moe_capacity_factor=consist_cf)
    if stepped_f32:
        check_stepped(arch, params, cc, prompt, dev, gated=False)
        cc = cc.with_(compute_dtype="float32")
    check_stepped(arch, params, cc, sp, dev, **frames)
    return counts


def check_stepped(arch, params, cfg, tokens, dev, gated=True,
                  encoder_embeds=None):
    """The step-by-step prefill (``serve.prefill_by_steps``) of ``tokens``
    against ``forward``, routed as forward (``routing_spy``), max |diff| /
    max |logit| within LOGIT_REL when ``gated``, else printed only; an
    encoder-decoder steps against ``build_cross_cache`` of
    ``encoder_embeds``, which ``forward`` encodes."""
    from repro_torch.launch import serve
    from repro_torch.models import decoder_lm as dlm
    rows, length = tokens.shape
    kw, cross = {}, None
    if encoder_embeds is not None:
        kw["encoder_embeds"] = encoder_embeds
        cross = dlm.build_cross_cache(params, cfg, encoder_embeds)
    tokens = torch.as_tensor(tokens, device=dev)
    with routing_spy() as fwd:
        full_logits, _ = dlm.forward(params, cfg, tokens, **kw)
    # decode routes (step t, layer l) in turn; forward each layer at once
    order = [ids.reshape(rows, length, -1)[:, t]
             for t in range(length) for ids in fwd.ids]
    with routing_spy(order) as dec:
        stepped, _ = serve.prefill_by_steps(params, cfg, tokens, length,
                                            device=dev, cross=cross)
    rel = rel_to_max(stepped, full_logits)
    print(f"[serving] {arch} step-by-step prefill vs forward, "
          f"{cfg.compute_dtype} compute, capacity factor "
          f"{cfg.moe_capacity_factor} (no drops), at the {length} prompt "
          f"positions of {rows} rows"
          + (f" against {encoder_embeds.shape[1]} frames' cross cache"
             if cross else "")
          + f", routed as forward ({dec.flipped} of "
          f"{dec.routed} routings would differ): max |diff| / max |logit| "
          f"{rel:.3e} ("
          + (f"tolerance {LOGIT_REL:.3e}" if gated else "not gated")
          + f"), argmax agreement "
          f"{float((stepped.argmax(-1) == full_logits.argmax(-1)).float().mean()):.4f}")
    if gated and not rel <= LOGIT_REL:
        raise AssertionError(f"{arch} decode vs forward logits: {rel}")


def drive_mixtral_serving(dev):
    """Phase 7's serving path: ``drive_zoo_serving`` on Mixtral-8x7B, 4 of
    its 32 layers at its own window of 4,096, kernel vs plain also at
    window 200, decode vs forward at capacity factor 8.0."""
    return drive_zoo_serving(MIXTRAL, MIXTRAL_SERVE_LAYERS,
                             MIXTRAL_SERVE_SPLIT, dev, 8.0, windows=(200,))


# ---------------------------------------------------------------------------
# Phase 8: DeepSeek-V2 at full width: MLA through the attention kernel at
# head dims (192, 128), FedPT with the routed experts frozen, the
# compressed-cache decode

DEEPSEEK = "deepseek-v2-236b"
# of its 60 layers: the most the card holds for training (1) and for the
# serving split beside a 32,768-token prefill (2); every width is the
# config's own
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_SERVE_LAYERS = 1, 2
DEEPSEEK_ROUNDS = 8
# (trainable, total, flat size) at 1 layer: the two embedding tables and
# the final norm (1,048,581,120) and 197,242,880 a layer (MLA's
# 149,227,520, the two norms, the router and the 2 shared experts) train;
# the routed experts' 3,774,873,600 are frozen; the flat layout pads
# kv_norm (512) and q_norm (1,536) to multiples of 1,024
DEEPSEEK_TRAIN_SPLIT = (1_245_824_000, 5_020_697_600, 1_245_825_024)
# (trainable f32, frozen bf16) of the 2 serving layers
DEEPSEEK_SERVE_SPLIT = (1_443_066_880, 7_549_747_200)
# MLA's q / k and v head dims (qk_nope 128 + qk_rope 64; v_head_dim), its
# heads, and the sequence lengths phase 2 holds the kernel at
MLA_DK, MLA_DV, MLA_HEADS = 192, 128, 128
MLA_CHECK_S = (4096, 4000)
# decode against forward at a capacity factor where nothing drops: a
# decode step's 4 tokens x 6 experts get round(4 * 6 / 160 * 32) = 5 slots
# an expert (all 4 tokens fit one), forward's 32 prompt tokens 38
DEEPSEEK_CONSIST_CF = 32.0
# the reduced config, one round card vs CPU in float32: no ReLU kinks or
# Adam steps (check_model_round's reasons for its looser bounds)
REDUCED_LOSS_REL, REDUCED_UPDATE_REL = 1e-5, 1e-3


def check_mla_kernel(dev):
    """Phase 2 at MLA's head dims: ``swa_attention`` at (1, 128, 4096,
    192 / 128) bf16 causal in the model's (B, S, H, D) layout, the
    round-once mode held by :func:`check_swa_round_p` and the float32-p
    mode by :func:`check_swa`, the same at a ragged S = 4,000, the float32
    kernel at (1, 4, 1000, 48 / 32) (the reduced config's); then the
    round-once mode timed at the prefill's (1, 128, 32768, 192 / 128)
    causal against the bound (2 (DK + DV) flops a visible pair at the
    bf16 peak), the plain version timed once and both modes held there as
    at 4,096, and ``scaled_dot_product_attention`` (its default backend)
    on the same inputs; the float32-p mode's time and SDPA's other
    backends are :func:`attention_times`' (``--kernel-times``). Returns
    the round-once mode's numbers."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device="cpu").manual_seed(24)

    def inputs(B, H, S, dk, dv, dtype):
        def one(d):
            return card_normal((B, S, H, d), gen, dev, dtype).transpose(1, 2)
        return one(dk), one(dk), one(dv)

    for S in MLA_CHECK_S:
        q, k, v = inputs(1, MLA_HEADS, S, MLA_DK, MLA_DV, torch.bfloat16)
        check_swa_round_p(q, k, v, 0)
        check_swa(q, k, v, 0)
    check_swa(*inputs(1, 4, 1000, 48, 32, torch.float32), 0)
    del q, k, v
    q, k, v = inputs(1, MLA_HEADS, PREFILL_LEN, MLA_DK, MLA_DV,
                     torch.bfloat16)
    pairs = swa.visible_pairs(PREFILL_LEN, 0)
    flops = MLA_HEADS * pairs * 2 * (MLA_DK + MLA_DV)
    # q, k and v read once, the (1, 128, S, DV) output written once
    nbytes = 2 * (q.numel() + k.numel() + 2 * v.numel())
    bound_ms, bound_by = bound(nbytes, flops, BF16_OPS_PER_S)
    out = {"bound_ms": bound_ms, "bound_by": bound_by}

    def fn():
        return swa.swa_attention(q, k, v, round_p=True)
    ms = time_ms(fn, 5, 1)
    dms = device_ms(fn, ("swa_kernel",), 5)
    out["round-once"] = (ms, dms)
    print(f"  swa_attention (round-once) at (1, {MLA_HEADS}, {PREFILL_LEN}, "
          f"{MLA_DK} / {MLA_DV}) causal: wrapper {ms:.3f} ms, device "
          f"{fmt_ms(dms)} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{flops / 1e12:.3f} TFLOP), x{(dms or ms) / bound_ms:.2f} of "
          f"the bound, {flops / (dms or ms) / 1e9:.1f} TFLOP/s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.chunked_attention_ref(q, k, v, 0, chunk=swa.BK)
    torch.cuda.synchronize()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"  swa_attention's plain version (chunked_attention_ref, chunk "
          f"64) at that shape: {out['plain_ms']:.3f} ms")
    check_swa_round_p(q, k, v, 0, want)
    del want
    check_swa(q, k, v, 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["library_ms"] = time_ms(lambda: sdpa(q, k, v, is_causal=True), 3, 1)
    print(f"  scaled_dot_product_attention (default backend) with Ev "
          f"{MLA_DV} unlike E {MLA_DK}: {out['library_ms']:.3f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return out


def check_attention_fallback(dev):
    """Phase 2: ``nn/attention.flash_attention`` with a logit softcap or an
    offset q, which the kernel does not compute, on the card: the plain
    ``chunked_attention`` on the card, no kernel launched, within rtol /
    atol 1e-5 of the CPU path on the same float32 inputs (a reduced
    NeMo's GQA at window 100; the two devices' GEMMs sum in other
    orders)."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.nn import attention
    base = reduced_config(get_config(NEMO)).with_(num_kv_heads=2,
                                                  sliding_window=100)
    gen = torch.Generator().manual_seed(4)
    for softcap, q_offset in ((30.0, 0), (0.0, 64), (30.0, 64)):
        cfg = base.with_(attn_logit_softcap=softcap)
        q = torch.randn((2, 200 - q_offset, 4, 64), generator=gen)
        k, v = (torch.randn((2, 200, 2, 64), generator=gen) for _ in "kv")
        kernels.reset_launches()
        got = attention.flash_attention(q.to(dev), k.to(dev), v.to(dev), cfg,
                                        q_offset=q_offset)
        launched = kernels.LAUNCHES["swa_attention"]
        want = attention.flash_attention(q, k, v, cfg, q_offset=q_offset)
        err = float((got.cpu() - want).abs().max())
        ok = bool(torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5))
        print(f"  flash_attention, softcap {softcap:g}, q_offset {q_offset}, "
              f"on the card: {launched} kernel launches, max |card - CPU| "
              f"{err:.3e} (rtol / atol 1e-5)")
        if launched or got.device.type != "cuda" or not ok:
            raise AssertionError(f"flash_attention with softcap {softcap} "
                                 f"and q_offset {q_offset} on the card is "
                                 f"off the CPU path")


def check_vlm_encdec_kernels(dev, shapes=None, iters: int = 50,
                              plain: tuple = (3, 1)) -> dict:
    """Phase 2 at ``shapes`` (VLM_ENCDEC_SHAPES; phase 11 (j) and (k) at a
    mesh rank's heads, ``iters`` and the plain version's ``plain`` (iters,
    warm-ups) cut there), in the model's (B, S, H, D) layout:
    each held in the round-once mode by :func:`check_swa_round_p` and in
    the float32-p mode by :func:`check_swa`, then timed in the round-once
    mode the prefills launch (wrapper by CUDA events over back-to-back
    calls, device by the profiler, and a call's span by CUDA events
    around it alone, each printed on its own) against its bound (2 (DK + DV) flops a visible pair at the
    bf16 peak, or q, k, v and the output's bytes once), the plain version
    once, and ``scaled_dot_product_attention`` on the same inputs (k, v
    repeated to q's heads; the prefix as a boolean ``attn_mask``).
    Returns {label: numbers}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cpu").manual_seed(26)
    out = {}
    for label, (B, H, KVH, SQ, SKV, DK, DV), causal, prefix in \
            shapes or VLM_ENCDEC_SHAPES:
        def one(rows, heads, d):
            return torch.randn((B, rows, heads, d), generator=gen).to(
                dev, torch.bfloat16).transpose(1, 2)
        q, k, v = one(SQ, H, DK), one(SKV, KVH, DK), one(SKV, KVH, DV)
        check_swa_round_p(q, k, v, 0, causal=causal, prefix_len=prefix)
        check_swa(q, k, v, 0, causal=causal, prefix_len=prefix)
        pairs = swa.visible_pairs(SQ, 0, causal, prefix_len=prefix, skv=SKV)
        flops = B * H * pairs * 2 * (DK + DV)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * H * SQ * DV)
        bound_ms, bound_by = bound(nbytes, flops, BF16_OPS_PER_S)

        def kernel():
            return swa.swa_attention(q, k, v, causal=causal, round_p=True,
                                     prefix_len=prefix)
        ms = time_ms(kernel, iters, 5)
        dms = device_ms(kernel, ("swa_kernel",), iters)
        # late in a whole run the profiler may record no launch of a
        # kernel of this repo (ROADMAP Queue 3): the span is measured
        # beside it
        span = span_ms(kernel, iters)
        plain_ms = time_ms(lambda: ref.chunked_attention_ref(
            q, k, v, 0, causal, chunk=swa.BK, prefix_len=prefix), *plain)
        kr, vr = ((t.repeat_interleave(H // KVH, dim=1) if H > KVH else t)
                  for t in (k, v))
        mask = None
        if causal:
            pos = torch.arange(SQ, device=dev)
            mask = (pos[:, None] >= pos[None, :]) | (pos[None, :] < prefix)
        lib_ms = time_ms(lambda: sdpa(q, kr, vr, attn_mask=mask), iters, 5)
        lib_dms = device_ms(lambda: sdpa(q, kr, vr, attn_mask=mask), None,
                            iters)
        out[label] = dict(ms=ms, device_ms=dms, span_ms=span,
                          bound_ms=bound_ms, plain_ms=plain_ms,
                          library_ms=lib_ms)
        by_dev = ("not measured" if dms is None
                  else f"x{dms / bound_ms:.2f}")
        print(f"  swa_attention (round-once) {label} "
              f"{swa_where(q, k, v, 0, causal, prefix)}: wrapper {ms:.5f} "
              f"ms, device {fmt_ms(dms)} ms (profiler), span {span:.5f} ms "
              f"(CUDA events), bound {bound_ms:.5f} ms "
              f"({bound_by}; {pairs} pairs a head, {flops / 1e9:.3f} "
              f"GFLOP); device / bound {by_dev}, span / bound "
              f"x{span / bound_ms:.2f}; plain "
              f"{plain_ms:.3f} ms; scaled_dot_product_attention "
              f"{'with a bool attn_mask ' if causal else ''}{lib_ms:.5f} ms "
              f"(device {fmt_ms(lib_dms)} ms)")
        del q, k, v, kr, vr, mask
    torch.cuda.empty_cache()
    return out


def drive_deepseek_training(dev):
    """Phase 8's training path: ``drive_zoo_training`` on DeepSeek-V2, 1
    of its 60 layers, DEEPSEEK_ROUNDS rounds, the reduced round held at
    REDUCED_LOSS_REL / REDUCED_UPDATE_REL."""
    return drive_zoo_training(
        DEEPSEEK, DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_ROUNDS, DEEPSEEK_TRAIN_SPLIT,
        dev, loss_rel=REDUCED_LOSS_REL, update_rel=REDUCED_UPDATE_REL,
        # its by-op profile of ~40 k ops left the default run for phase
        # 11's time (PERF.md keeps the breakdown it gave)
        by_op=False)


def drive_deepseek_serving(dev):
    """Phase 8's serving path: ``drive_zoo_serving`` on DeepSeek-V2, 2 of
    its 60 layers (MLA through ``swa_attention`` at q / k heads of 192 and
    v heads of 128; decode from the compressed (c_kv, k_pe) cache),
    decode vs forward at capacity factor DEEPSEEK_CONSIST_CF."""
    return drive_zoo_serving(DEEPSEEK, DEEPSEEK_SERVE_LAYERS,
                             DEEPSEEK_SERVE_SPLIT, dev, DEEPSEEK_CONSIST_CF)


# ---------------------------------------------------------------------------
# Phase 9: the SSM families at full width: xLSTM-350M trained and served at
# all 24 layers, Jamba-v0.1 served at one period of its layer program

XLSTM = "xlstm-350m"
XLSTM_LAYERS = 24          # of 24, to serve
# to train: two periods of its layer program, the depth cut to make room
# for phase 10 in the script's time (24 layers took 36-95 s, PERF.md)
XLSTM_TRAIN_LAYERS = 8
XLSTM_ROUNDS = 8
# (trainable, total, flat size) at 8 layers: the tied embedding
# (51,511,296), the mLSTM gates, convs, biases and norms and the sLSTM
# gates, convs and norms train; the mLSTM q / k / v / up / down kernels
# and the sLSTM recurrent and FFN kernels are frozen; the flat layout pads
# the small leaves to multiples of 1,024
XLSTM_TRAIN_SPLIT = (60_138_544, 183_862_320, 60_141_568)
XLSTM_SERVE_SPLIT = (77_390_992, 371_171_328)
# 16 rows of the xLSTM paper's 2,048-token training context: the other zoo
# prefills' 32,768 tokens; profiled at one mLSTM chunk, 128 tokens a row
# (the sLSTM's time loop launches 19 kernels a position a layer)
XLSTM_PREFILL, XLSTM_PROFILE = (16, 2048), (16, 128)
JAMBA = "jamba-v0.1-52b"
# of its 32 layers: one period of the layer program (4 Mamba + MoE, 3
# Mamba + dense FFN, 1 attention + dense FFN); serving only, since FedPT
# at full width needs more than the card (PERF.md, section 6)
JAMBA_LAYERS = 8
JAMBA_SERVE_SPLIT = (611_659_776, 12_683_575_296)
# prefill_32k's length at batch 1, profiled at 4,096 (the Mamba loops
# launch a kernel a position a layer)
JAMBA_PREFILL, JAMBA_PROFILE = (1, PREFILL_LEN), (1, 4096)
# decode against forward over 512 positions of one row at a capacity
# factor where nothing drops: forward's 512 tokens x 2 of 16 experts get
# round(512 * 2 / 16 * 8) = 512 slots an expert, a decode step's one token
# 1 slot in each of its 2 experts
JAMBA_CONSIST_CF = 8.0
JAMBA_STEPPED = (1, CONSIST_LEN)
# xLSTM's decode against forward, in float32: across the mLSTM's first
# chunk boundary (128 positions). In bf16 the two differ by 4e-2 of the
# largest |logit| at the first position and 1.6e-1 over 512 (one-ulp
# flips grown ~3x by each sLSTM block through 24 layers; 4.6e-5 in
# float32), so the bf16 gap is printed on the decode prompt
XLSTM_STEPPED = (1, 160)


def drive_xlstm_training(dev):
    """Phase 9's training path: ``drive_zoo_training`` on xLSTM-350M, 8
    of its 24 layers at full width, XLSTM_ROUNDS rounds, the profiled
    round's busy share and launches from its CUDA activity alone, without
    the by-op split (the profiler walks its ~39 k launches and their aten
    ops in tens of seconds), the reduced round held at
    REDUCED_LOSS_REL / REDUCED_UPDATE_REL (no MoE routing, no ReLU
    kinks)."""
    return drive_zoo_training(
        XLSTM, XLSTM_TRAIN_LAYERS, XLSTM_ROUNDS, XLSTM_TRAIN_SPLIT, dev,
        by_op=False, loss_rel=REDUCED_LOSS_REL,
        update_rel=REDUCED_UPDATE_REL)


def drive_xlstm_serving(dev):
    """Phase 9's xLSTM serving: ``drive_zoo_serving`` on all 24 layers, a
    16 x 2,048 prefill (1 warm-up, 1 timed), step-by-step prefill against
    ``forward`` over XLSTM_STEPPED in float32 (the bf16 gap printed)."""
    return drive_zoo_serving(XLSTM, XLSTM_LAYERS, XLSTM_SERVE_SPLIT, dev,
                             1.25, prefill=XLSTM_PREFILL, timed=1,
                             profile=XLSTM_PROFILE, stepped=XLSTM_STEPPED,
                             stepped_f32=True)


def drive_jamba_serving(dev):
    """Phase 9's Jamba serving: ``drive_zoo_serving`` on one period (8 of
    32 layers), a 1 x 32,768 prefill (1 warm-up, 1 timed) profiled at 1 x
    4,096, kernel vs plain at 1 x 512 and step-by-step prefill against
    ``forward`` over 512 positions at capacity factor JAMBA_CONSIST_CF;
    then one reduced round card vs CPU (``check_model_round``'s default
    bounds: a router near-tie may flip between the devices)."""
    counts = drive_zoo_serving(JAMBA, JAMBA_LAYERS, JAMBA_SERVE_SPLIT, dev,
                               JAMBA_CONSIST_CF, prefill=JAMBA_PREFILL,
                               timed=1, profile=JAMBA_PROFILE,
                               stepped=JAMBA_STEPPED)
    torch.cuda.empty_cache()
    check_reduced_round(JAMBA, dev)
    return counts


def drive_ssm(dev) -> dict:
    """Phase 9: xLSTM-350M FedPT and serving, Jamba-v0.1 serving. Returns
    the summed launch counts."""
    totals = {}
    for leg in (drive_xlstm_training, drive_xlstm_serving,
                drive_jamba_serving):
        t0 = time.perf_counter()
        for name, n in leg(dev).items():
            totals[name] = totals.get(name, 0) + n
        print(f"[ssm] {leg.__name__} took {time.perf_counter() - t0:.1f} s")
    if totals.get("sumsq", 0) < XLSTM_ROUNDS or \
            totals.get("swa_attention", 0) <= 0:
        raise AssertionError(f"phase 9: sumsq or swa_attention not "
                             f"launched: {totals}")
    return totals


# ---------------------------------------------------------------------------
# Phase 10: the VLM and the encoder-decoder at full width: PaliGemma-3B
# (a bidirectional prefix, head dim 256) and Whisper large-v3 (encoder,
# cross-attention), FedPT and serving

PALIGEMMA = "paligemma-3b"
PALIGEMMA_LAYERS = 18      # of 18, to serve
# to train: all 18 layers ran out of the card's 80 GB in the first
# round's backward (3 clients vmapped past VMAP_BYTES: their copies, the
# tied 257,216-wide embedding's gradients and casts, ~47 GB whatever the
# depth, beside ~1.7 GB a layer); 8 layers reckon to ~61 GB (PERF.md)
PALIGEMMA_TRAIN_LAYERS = 8
PALIGEMMA_ROUNDS = 8
# (trainable, total, flat size): the tied embedding (526,778,368), mm_proj,
# the attention and the norms train; the GeGLU FFN kernels, 3 x 2,048 x
# 16,384 a layer, are frozen; at 18 layers, and at the 8 trained
PALIGEMMA_FULL_SPLIT = (699_084_800, 2_511_024_128, 699_084_800)
PALIGEMMA_TRAIN_SPLIT = (604_672_000, 1_409_978_368, 604_672_000)
PALIGEMMA_SERVE_SPLIT = (699_084_800, 1_811_939_328)
# 64 rows of 256 patches + 256 tokens: the other zoo prefills' 32,768
# positions (its logits take 64 x 512 x 257,216 x 2 B = 16.9 GB); profiled
# at 8 rows; kernel vs plain on 1 x (256 + 64), the step-by-step prefill
# (text only, as decode runs) on 1 x 64
PALIGEMMA_PREFILL, PALIGEMMA_PROFILE = (64, 256), (8, 256)
PALIGEMMA_CONSIST = (1, 64)
WHISPER = "whisper-large-v3"
# to train: 3 of its 32 encoder and 3 of its 32 decoder layers over the
# full 1,500 frames. The plain chunked attention under grad keeps float32
# scores, p and rounded p, ~2.2 GB a client an encoder layer (4 sentences
# x 20 heads x 1,500 x 1,500), and the round engine vmaps the 4 clients:
# 4 + 4 layers ran out of the card's 80 GB in the first round, 2 + 2
# peaked at 47.58 GiB, so a layer pair takes >= 14.3 GiB (PERF.md)
WHISPER_TRAIN_LAYERS = 3
WHISPER_ROUNDS = 8
WHISPER_TRAIN_SPLIT = (231_124_480, 270_446_080, 231_131_136)
WHISPER_SERVE_LAYERS = 32  # of 32, with all 32 encoder layers
WHISPER_SERVE_SPLIT = (1_181_767_680, 419_430_400)
# 16 rows of 1,500 frames and 448 tokens (Whisper's text context),
# profiled at 4 rows; decode with a 4-token prompt; kernel vs plain and
# the stepped decode against the cross cache on 1 x (1,500 frames, 64
# tokens)
WHISPER_PREFILL, WHISPER_PROFILE = (16, 448), (4, 448)
WHISPER_PROMPT = 4
WHISPER_CONSIST = (1, 64)
# The VLM's and the encoder-decoder's swa_attention calls at the prefills'
# own shapes, bf16: (label, (B, H, KVH, Sq, Skv, DK, DV), causal, prefix):
# PaliGemma's (64 rows, 8 q heads over one kv head of 256, 256 patches
# before 256 tokens: the (256, 128) instance in two v slices), Whisper's
# encoder (16 rows, 20 heads of 64 over 1,500 frames) and its
# cross-attention (448 tokens, its text context, against the 1,500 frames)
VLM_ENCDEC_SHAPES = (
    ("PaliGemma prefix", (PALIGEMMA_PREFILL[0], 8, 1, 512, 512, 256, 256),
     True, 256),
    ("Whisper encoder", (WHISPER_PREFILL[0], 20, 20, 1500, 1500, 64, 64),
     False, 0),
    ("Whisper cross", (WHISPER_PREFILL[0], 20, 20, 448, 1500, 64, 64),
     False, 0))


def drive_paligemma_training(dev):
    """Phase 10's PaliGemma FedPT: the 18-layer split asserted on meta
    tensors, then ``drive_zoo_training`` at 8 of the 18 layers, full
    width, ``arch_task``'s zero patch embeddings (256 + 32 positions a
    sentence), PALIGEMMA_ROUNDS rounds, the reduced round at
    REDUCED_LOSS_REL / REDUCED_UPDATE_REL (no MoE routing, no ReLU
    kinks)."""
    from repro_torch.configs.base import get_config
    full = train_split(get_config(PALIGEMMA))
    print(f"[{PALIGEMMA}] FedPT split at all {PALIGEMMA_LAYERS} layers, on "
          f"meta tensors: {full[0]} of {full[1]} trainable "
          f"({100 * full[0] / full[1]:.2f}%), flat size {full[2]}")
    if full != PALIGEMMA_FULL_SPLIT:
        raise AssertionError(f"{PALIGEMMA}'s 18-layer split {full}, not "
                             f"{PALIGEMMA_FULL_SPLIT}")
    return drive_zoo_training(
        PALIGEMMA, PALIGEMMA_TRAIN_LAYERS, PALIGEMMA_ROUNDS,
        PALIGEMMA_TRAIN_SPLIT, dev, may_overflow=("mm_proj/bias",),
        loss_rel=REDUCED_LOSS_REL, update_rel=REDUCED_UPDATE_REL)


def drive_paligemma_serving(dev):
    """Phase 10's PaliGemma serving: ``drive_zoo_serving`` at all 18
    layers, a 64 x (256 + 256) prefill through ``swa_attention`` with the
    bidirectional prefix at head dim 256 (1 warm-up, 1 timed), profiled
    at 8 rows, greedy text decode, kernel vs plain on 1 x (256 + 64) and
    the step-by-step prefill against ``forward`` on 1 x 64."""
    return drive_zoo_serving(
        PALIGEMMA, PALIGEMMA_LAYERS, PALIGEMMA_SERVE_SPLIT, dev, 1.25,
        prefill=PALIGEMMA_PREFILL, timed=1, profile=PALIGEMMA_PROFILE,
        stepped=PALIGEMMA_CONSIST, consist=PALIGEMMA_CONSIST)


def drive_whisper_training(dev):
    """Phase 10's Whisper FedPT: ``drive_zoo_training`` at 3 + 3 layers,
    full width, ``arch_task``'s 1,500 zero frames a sentence,
    WHISPER_ROUNDS rounds, the reduced round at REDUCED_LOSS_REL /
    REDUCED_UPDATE_REL."""
    return drive_zoo_training(
        WHISPER, WHISPER_TRAIN_LAYERS, WHISPER_ROUNDS, WHISPER_TRAIN_SPLIT,
        dev, encoder_layers=WHISPER_TRAIN_LAYERS, loss_rel=REDUCED_LOSS_REL,
        update_rel=REDUCED_UPDATE_REL)


def drive_whisper_serving(dev):
    """Phase 10's Whisper serving: ``drive_zoo_serving`` at 32 + 32
    layers, a 16 x (1,500 frames, 448 tokens) prefill (``swa_attention``
    96 times: 32 encoder, 32 decoder, 32 cross calls; 1 warm-up, 1 timed),
    profiled at 4 rows; decode against ``build_cross_cache`` (batch 4, a
    4-token prompt, 32 greedy steps); kernel vs plain and the stepped
    decode against ``forward`` on 1 x (1,500 frames, 64 tokens)."""
    return drive_zoo_serving(
        WHISPER, WHISPER_SERVE_LAYERS, WHISPER_SERVE_SPLIT, dev, 1.25,
        prefill=WHISPER_PREFILL, timed=1, profile=WHISPER_PROFILE,
        stepped=WHISPER_CONSIST, decode_prompt=WHISPER_PROMPT,
        consist=WHISPER_CONSIST)


def drive_vlm_encdec(dev) -> dict:
    """Phase 10: PaliGemma-3B and Whisper large-v3 FedPT and serving.
    Returns the summed launch counts."""
    totals = {}
    for leg in (drive_paligemma_training, drive_paligemma_serving,
                drive_whisper_training, drive_whisper_serving):
        t0 = time.perf_counter()
        for name, n in leg(dev).items():
            totals[name] = totals.get(name, 0) + n
        print(f"[vlm-encdec] {leg.__name__} took "
              f"{time.perf_counter() - t0:.1f} s")
    if totals.get("sumsq", 0) < PALIGEMMA_ROUNDS + WHISPER_ROUNDS or \
            totals.get("swa_attention", 0) <= 0:
        raise AssertionError(f"phase 10: sumsq or swa_attention not "
                             f"launched: {totals}")
    return totals


# ---------------------------------------------------------------------------
# Phase 11: the mesh. The 1-rank NCCL "single" mesh runs the EMNIST main
# paths through the meshed code, bit for bit the unmeshed runs with the
# same launches; the tensor-parallel train step (StableLM-2-1.6B) and
# prefill (Mixtral-8x7B) on it, bit for bit; Mixtral-8x7B, Jamba-v0.1,
# xLSTM-350M, PaliGemma-3B and Whisper large-v3 on a 4-rank "model" axis
# of threads on the one card; DeepSeek-V2 on a (2, 2) ("data", "model")
# mesh of threads, its experts in the 2-D layout; one dry run in a fake
# (16, 16) world on the host

STABLELM = "stablelm-1.6b"
# train_4k's sequence; its global batch of 256 cut to 1 client x tau 2 x 1
# sequence (one card)
TRAIN_4K_SEQ = 4096
# depth cut 24 -> 2: at 4,096 positions the plain chunked attention keeps
# ~11 GB a layer under grad (the float32 scores, masked scores, p and
# bf16 p of 8 chunks of 512 keys, 32 heads), and 24 and 6 layers ran out
# of the card's memory (PERF.md)
STABLELM_TRAIN_LAYERS = 2
DRYRUN = ("mixtral-8x7b", "train_4k")
DRYRUN_TIMEOUT = 900
# (f): a 4-rank "model" axis of threads on the one card, Mixtral-8x7B at
# full width and 2 of its layers (phase 7's training depth); its round:
# 2 clients x tau 2 x 2 sequences of 256 tokens
TP_RANKS = 4
TP_LAYERS = MIXTRAL_TRAIN_LAYERS
TP_ROUND = (2, 2, 2, 256)
TP_TIMEOUT = 600          # seconds the threads may take, all together
# (f)'s train step against the unmeshed round by update norm, in float32
# compute: the ranks' partial products, each its own GEMM, are summed in
# another order than one GEMM sums them, over 4,096 to 14,336 terms (about
# sqrt(K) u = 7e-6 of a product), through 2 layers, 2 local steps and the
# server's momentum; tests/test_torch_tp.py holds 1e-5 at its reduced
# widths (measured ~2e-6), and at full width the step measured 2.4e-5
# on the H100 (PERF.md): 1e-4. (In bf16 compute a router near-tie can
# flip between two roundings and move a token's whole expert output, and
# the round's routing under vmap and grad is not replayed, so no bound
# there would be tighter than the bf16 round's own distance from float32.)
TP_F32_UPDATE_REL = 1e-4
# a bf16 tensor-parallel prefill held in float32 (TPLeg.prefill_f32) is
# also held in bf16 within this many times the gap that a second bf16
# rounding of the unmeshed prefill makes (ulp_moved_mlstm)
WITNESS_X = 4.0
# (c): the gathered train layout, which no zoo config at its own settings
# reaches: Mixtral-8x7B with its experts in the ``2d_swapped`` mode (item
# 16.7 of ROADMAP.md), at phase 7's training depth, 2 of its 32 layers
GATHERED_LAYERS, GATHERED_OVER = MIXTRAL_TRAIN_LAYERS, {
    "expert_shard": "2d_swapped"}
# (g): DeepSeek-V2-236B at full width, DEEPSEEK_TRAIN_LAYERS (1) of its 60
# layers (phase 8's training depth), on a (2, 2) ("data", "model") mesh of
# threads on the one card: its 160 experts in the 2-D layout (80 a data
# rank, each on 768 of its 1,536 FFN columns: a quarter of the bank a
# rank), MLA's 128 heads 64 a "model" rank. The prefill: prefill_32k's
# 32,768 positions, 2 rows, one a data rank (each rank fills only its 80
# experts' (80, 6,144, 5,120) bf16 slots, 5.0 GB, from both data ranks'
# tokens; while each built the batch's whole buffer, 2 x 32,768 ran out of
# the card's memory and the rows were cut to 16,384 positions); the train
# step's clients x tau x sequences x tokens, as (f)'s
DS_TP_SHAPE = (2, 2)
DS_TP_PREFILL = (2, PREFILL_LEN)
DS_TP_ROUND = TP_ROUND
# (h): Jamba-v0.1 at full width on a (1, 4) mesh of threads, 2 of its 32
# layers, as Mixtral's (f) takes 2. Its layer program has a period of 8
# (attention at the 5th layer, the MoE at every 2nd), which no depth
# under 8 keeps, and 8 layers' float32 round (the 4 MoE layers' experts
# cast to float32 and saved for the backward, 11.3 GB a layer, beside
# 24.1 GB of frozen bf16) does not fit the card beside the meshed worlds:
# so the attention period is cut to 2, and the 2 layers are Mamba with the
# dense FFN, then attention (no RoPE) with the MoE, every block kind of
# the model once; prefill_32k's length at batch 1; the train step as
# (f)'s
JAMBA_TP_LAYERS, JAMBA_TP_OVER = 2, {"attn_period": 2}
JAMBA_TP_PREFILL = (1, PREFILL_LEN)
# (i): xLSTM-350M at full width on a (1, 4) mesh of threads, one period
# of its 24 layers (3 mLSTM blocks, 1 sLSTM); the prefill phase 9's 16 x
# 2,048 (the sLSTM steps a position at a time on every rank)
XLSTM_TP_LAYERS = 4
# (j): PaliGemma-3B at full width on a (1, 4) mesh of threads, 2 of its 18
# layers: 8 q heads 2 a rank, its one kv head of 256 split in 64-column
# quarters and gathered, mm_proj whole on every rank; the prefill 16 x
# (256 patch embeddings + 256 tokens) (phase 10's 64 rows make 16.9 GB of
# logits whole; 16 rows' 4.2 GB are kept on the host beside a rank's
# 1.05 GB vocab piece); the step as (f)'s, 256 patch embeddings a sentence
PALIGEMMA_TP_LAYERS = 2
PALIGEMMA_TP_PREFILL = (16, 256)
# (k): Whisper large-v3 at full width on (1, 4) threads, 2 + 2 of its 32 +
# 32 layers: its 20 heads 5 a rank in the encoder, the decoder's
# self-attention and the cross-attention, its vocab of 51,866 whole on
# every rank (it does not divide 4); the prefill phase 10's 16 x (1,500
# frames + 448 tokens); the step as (f)'s, 1,500 frames a sentence
WHISPER_TP_LAYERS = 2
WHISPER_TP_PREFILL = WHISPER_PREFILL
# swa_attention at (j)'s and (k)'s rank's heads, held to the plain version
# and timed as phase 2's VLM_ENCDEC_SHAPES are (fewer repeats)
TP_VLM_SHAPES = (
    ("(j) PaliGemma prefix, a rank's heads",
     (PALIGEMMA_TP_PREFILL[0], 2, 1, 512, 512, 256, 256), True, 256),)
TP_WHISPER_SHAPES = (
    ("(k) Whisper encoder, a rank's heads",
     (WHISPER_TP_PREFILL[0], 5, 5, 1500, 1500, 64, 64), False, 0),
    ("(k) Whisper cross, a rank's heads",
     (WHISPER_TP_PREFILL[0], 5, 5, 448, 1500, 64, 64), False, 0))
TP_SHAPE_ITERS = 10


def start_dryrun():
    """(d) ``launch/dryrun`` on DRYRUN in a fake (16, 16) world, as a
    subprocess on the host's CPU (no card), run beside the card's work;
    :func:`finish_dryrun` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN[0], "--shape", DRYRUN[1]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_dryrun(proc, dev):
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the dry run failed:\n{err[-3000:]}")
    r = json.loads(out.strip().splitlines()[-1])
    if r["status"] != "ok" or r["cost"]["flops"] <= 0 or \
            r["memory"]["peak_bytes"] <= 0:
        raise AssertionError(f"the dry run: {r}")
    total = torch.cuda.get_device_properties(dev).total_memory
    mem = r["memory"]
    print(f"[mesh] (d) dry run {DRYRUN[0]} x {DRYRUN[1]} on a fake "
          f"{r['mesh']} world (traced counts, per rank, not measured): "
          f"peak {mem['peak_bytes']} B ({mem['peak_bytes'] / total:.2f} x "
          f"this card's total_memory {total} B), arguments "
          f"{mem['argument_bytes']} B, outputs {mem['output_bytes']} B, "
          f"{r['cost']['flops']} FLOPs, collectives {r['collectives']}, "
          f"{r['clients']} clients, traced in {r['trace_s']} s; step "
          f"layout: {r['layout']}")
    print(f"  what holds the peak: {mem['near_peak_bytes']} B live within "
          f"1% of it; its largest groups (op, dtype, shape: bytes, count):")
    for label, nbytes, n in mem["near_peak_top"]:
        print(f"    {label}: {nbytes} B, {n}")
    return r


def mesh_pair(label, run, expect):
    """``run(mesh)`` with no mesh and with the "single" preset, the launch
    counts set to 0 just before each and read just after; both must give
    the same bits and launch the same kernels as often. ``run`` returns
    (losses, y). Returns the two runs' counts, added."""
    from repro_torch import kernels
    outs, counts = [], []
    for mesh in (None, "single"):
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs.append(run(mesh))
        torch.cuda.synchronize()
        counts.append({**kernels.LAUNCHES, **kernels.ROUTES})
        print(f"[mesh] {label}, mesh={mesh}: {time.perf_counter() - t0:.2f} "
              f"s, losses {[round(v, 4) for v in outs[-1][0]]}")
    (la, ya), (lb, yb) = outs
    same = la == lb and all(torch.equal(a, b) for a, b in
                            zip(leaves_of(ya), leaves_of(yb)))
    used = {k: v for k, v in counts[0].items() if v}
    print(f"  bit for bit {same}; launches equal {counts[0] == counts[1]}: "
          f"{used}")
    if not same or counts[0] != counts[1]:
        raise AssertionError(f"{label}: the single mesh differs from the "
                             f"unmeshed run")
    check_expected(label, counts[1], expect)
    return {k: counts[0][k] + counts[1][k] for k in counts[0]}


def mesh_rounds(ys, zs, bits, dp, draws, dev):
    """The quickstart's round (``dp``: DP-FedAvg with the screen) for ROUNDS
    rounds, as ``run(mesh)`` for :func:`mesh_pair`."""
    from repro_torch.core import fedpt, sanitize
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.nn import threefry

    def run(mesh):
        kw = {}
        if mesh is not None:
            m = mesh_lib.resolve_mesh(mesh, dev)
            kw = dict(constrain_flat_fn=shard_lib.flat_constrainer(m))
        round_fn, sopt = fedpt.make_round_fn(
            emnist_loss, quickstart_rc(bits, dp), device=dev,
            sanitize=sanitize.SanitizeConfig() if dp else None, **kw)
        y, ss, losses = ys, sopt.init(ys), []
        for r, (batch, w) in enumerate(draws[:ROUNDS]):
            y, ss, met = round_fn(y, ss, zs, batch, w, threefry.key(r))
            losses.append(float(met["loss"]))
        return losses, y
    return run


def update_rel(y0, ya, yb, dev=None) -> float:
    """||yb - ya|| / ||ya - y0|| over the leaves, in float64 (on ``dev``,
    each leaf moved there in turn, where the trees lie on the host)."""
    gap = upd = 0.0
    for a0, a, b in zip(leaves_of(y0), leaves_of(ya), leaves_of(yb)):
        a0, a, b = (t.to(dev or t.device).double() for t in (a0, a, b))
        gap += float(((a - b) ** 2).sum())
        upd += float(((a - a0) ** 2).sum())
    return gap ** 0.5 / max(upd ** 0.5, 1e-30)


def drive_mesh_train_step(dev, label, arch, layers, over, tp):
    """``specs.make_train_step`` for ``arch`` (with ``over``) at full width,
    ``layers`` of its layers, on the "single" mesh (y and the server state
    DTensors placed by the reference's rules), against the same round
    from ``make_round_fn`` with no mesh, bit for bit with equal launches:
    (c) a config that keeps the gathered layout (``tp`` False), (e) one
    that takes the tensor-parallel step (``tp`` True; on a 1-rank "model"
    axis its wiring alone: the pieces are whole and no layer splits).
    Returns the two runs' launch counts, added."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import fedpt
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch import specs
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn.basic import tree_map
    torch.cuda.empty_cache()
    seq = TRAIN_4K_SEQ
    cfg = get_config(arch).with_(num_layers=layers, **over)
    mesh = mesh_lib.resolve_mesh("single", dev)
    layout = (specs.TP_LAYOUT if shard_lib.tensor_parallel_ok(cfg, mesh)
              else specs.GATHERED_LAYOUT)
    t0 = time.perf_counter()
    y, z = specs.serving_split(dlm.init_model(cfg, 0, device=dev), cfg)
    print(f"[mesh] {label} {arch}{' ' + str(over) if over else ''}: "
          f"{cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}; "
          f"{sum(v.numel() for v in leaves_of(y))} trainable (f32), "
          f"{sum(v.numel() for v in leaves_of(z))} frozen (bf16), made in "
          f"{time.perf_counter() - t0:.1f} s; one client x tau 2 x 1 "
          f"sequence of {seq} (train_4k's 256 x 4,096 cut to one card); "
          f"step layout: {layout}")
    if (layout == specs.TP_LAYOUT) != tp:
        raise AssertionError(f"{label} {arch}: the step's layout is "
                             f"{layout}")
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 2, 1, seq)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}
    for k, v in stub_inputs(cfg, 2, dev).items():   # (1, tau 2, 1, ...)
        batch[k] = v.reshape((1, 2, 1) + tuple(v.shape[1:]))
    w = torch.ones(1, device=dev)
    rc = fedpt.RoundConfig(clients_per_round=0, local_steps=2, local_batch=0,
                           client_opt="sgd", client_lr=0.02,
                           server_opt="sgdm", server_lr=0.5)
    round_fn, sopt = fedpt.make_round_fn(
        lambda p, mb: dlm.train_loss(p, cfg, mb), rc, device=dev)
    counts = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    y_ref, _, m_ref = round_fn(y, sopt.init(y), z, batch, w, None)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    counts.append(dict(kernels.LAUNCHES))
    step, sopt = specs.make_train_step(cfg, mesh, y, device=dev)
    place = shard_lib.param_shardings(y, cfg, mesh)
    yd = tree_map(lambda x, pl: shard_lib.distribute(x, mesh, pl), y, place)
    ssd = tree_map(lambda x, pl: shard_lib.distribute(x, mesh, pl),
                   sopt.init(y), place)
    kernels.reset_launches()
    t0 = time.perf_counter()
    y_new, _, m = step(yd, ssd, z, batch, w)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    counts.append(dict(kernels.LAUNCHES))
    y_mesh = shard_lib.gathered(y_new)
    rel = update_rel(y, y_ref, y_mesh)
    bits = all(torch.equal(a, b) for a, b in zip(leaves_of(y_ref),
                                                  leaves_of(y_mesh)))
    print(f"  unmeshed round {t_ref:.2f} s, loss {float(m_ref['loss']):.4f}; "
          f"meshed step {t_mesh:.2f} s, loss {float(m['loss']):.4f}; bit for "
          f"bit {bits}; gap by update norm {rel:.3e}; "
          f"launches {counts[1]}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (math.isfinite(float(m["loss"])) and bits
            and counts[0] == counts[1] and counts[1]["sumsq"] > 0):
        raise AssertionError(f"{label} {arch}: the meshed step is off the "
                             f"unmeshed round")
    return {k: counts[0][k] + counts[1][k] for k in counts[0]}


def drive_gathered_train_step(dev):
    """(c) the gathered layout: Mixtral-8x7B with its experts in the
    ``2d_swapped`` mode (which the tensor-parallel step does not take),
    GATHERED_LAYERS layers."""
    return drive_mesh_train_step(dev, "(c)", MIXTRAL, GATHERED_LAYERS,
                                 GATHERED_OVER, tp=False)


def drive_tp_single_train_step(dev):
    """(e) the tensor-parallel step's wiring on one rank: StableLM-2-1.6B,
    STABLELM_TRAIN_LAYERS layers."""
    return drive_mesh_train_step(dev, "(e)", STABLELM, STABLELM_TRAIN_LAYERS,
                                 {}, tp=True)


def drive_tp_single_prefill(dev):
    """(e) ``specs.make_tp_prefill_step`` for Mixtral-8x7B at full width,
    phase 7's MIXTRAL_SERVE_LAYERS layers, on the 1-rank "single" mesh
    against ``make_prefill_step`` with no mesh, 1 x PREFILL_LEN tokens at
    its window: bit for bit, ``swa_attention`` once a layer in each.
    Returns the two runs' launch counts, added."""
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import decoder_lm as dlm
    torch.cuda.empty_cache()
    cfg = get_config(MIXTRAL).with_(num_layers=MIXTRAL_SERVE_LAYERS)
    y, z = specs.serving_split(dlm.init_model(cfg, 0, device=dev), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_LEN))).to(dev)
    mesh = mesh_lib.resolve_mesh("single", dev)
    outs, counts, walls = [], [], []
    for step in (specs.make_prefill_step(cfg, device=dev),
                 specs.make_tp_prefill_step(cfg, mesh, device=dev)):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(y, z, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(dict(kernels.LAUNCHES))
        outs.append(out if isinstance(out, torch.Tensor)
                    and not hasattr(out, "placements") else out.to_local())
    same = torch.equal(outs[0], outs[1])
    print(f"[mesh] (e) {MIXTRAL} tensor-parallel prefill on the 1-rank "
          f"mesh, {cfg.num_layers} layers, 1 x {PREFILL_LEN} at window "
          f"{cfg.sliding_window}: unmeshed {walls[0]:.2f} s, meshed "
          f"{walls[1]:.2f} s (first calls); bit for bit {same}; launches "
          f"equal {counts[0] == counts[1]}: "
          f"{ {k: v for k, v in counts[1].items() if v} }")
    if not (same and counts[0] == counts[1]
            and counts[1]["swa_attention"] == cfg.num_layers
            and bool(torch.isfinite(outs[1]).all())):
        raise AssertionError("(e) the tensor-parallel prefill differs from "
                             "the unmeshed one")
    return {k: counts[0][k] + counts[1][k] for k in counts[0]}


def frozen_seen():
    """``FrozenSeen`` of the test helper ``tests/_torch_seen.py`` (the
    element counts of the leaves that the decoder LM's loss and forward
    receive), with ``tests/`` put on ``sys.path``."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from _torch_seen import FrozenSeen
    return FrozenSeen


def threaded_world(n: int, fn, timeout: float):
    """``fn(rank)`` on ``n`` threads of this process, each rank of a
    threaded process group (``torch.testing._internal.distributed.
    multi_threaded_pg``: collectives copy tensors between the threads, on
    the card too). An exception in one rank wakes the others and is
    raised here; so is a rank still running at ``timeout``. Returns the
    ranks' results."""
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    out = [None] * n
    errors = []
    # each thread's groups live in its thread-local world, dropped with the
    # threads and the world at the end
    mt._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    cur = torch.cuda.current_device() if torch.cuda.is_initialized() \
        else None

    def rank_main(rank):
        if cur is not None:
            torch.cuda.set_device(cur)
        dist.init_process_group("threaded", rank=rank, world_size=n,
                                store=store)
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — raised by the caller
            errors.append((rank, e))
            mt.ProcessLocalGroup.exception_handle(e)
    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True)
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        t_end = time.perf_counter() + timeout
        for t in threads:
            t.join(max(0.0, t_end - time.perf_counter()))
        alive = [r for r, t in enumerate(threads) if t.is_alive()]
        if alive:
            mt.ProcessLocalGroup.exception_handle(TimeoutError())
            raise TimeoutError(f"ranks {alive} still running after "
                               f"{timeout} s")
        if errors:
            raise RuntimeError(f"rank {errors[0][0]} failed") from \
                errors[0][1]
    finally:
        mt.ProcessLocalGroup.reset()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mt._uninstall_threaded_pg()
    return out


# the card's peak allocated bytes over each threaded leg's meshed prefill
# world, by leg ((f), (g), (h), (i)), as the legs ran
PREFILL_PEAKS = {}


def drive_tp_threads(dev):
    """(f) Mixtral-8x7B at full width, TP_LAYERS layers, on a (1,
    TP_RANKS) mesh of threads on the one card (``threaded_world``): each
    rank's y and frozen pieces as DTensors placed by the reference's
    rules (the ``model`` expert mode: 2 experts a rank). Its tensor-
    parallel prefill (1 x PREFILL_LEN at window 4,096; ``swa_attention``
    on each rank's 8 q / 2 kv heads) against the unmeshed prefill, routed
    as it (``routing_spy``), within LOGIT_REL of the largest |logit|; one
    tensor-parallel train step (TP_ROUND) in float32 compute against the
    unmeshed float32 round by update norm (TP_F32_UPDATE_REL). The frozen
    leaves that the model's loss and forward receive on every rank
    (``FrozenSeen``) are each rank's pieces: a split leaf's elements over
    TP_RANKS. Returns the meshed runs' launch counts."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import fedpt
    FrozenSeen = frozen_seen()
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch import specs
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn import basic
    from repro_torch.nn.basic import tree_map
    torch.cuda.empty_cache()
    cfg = get_config(MIXTRAL).with_(num_layers=TP_LAYERS)
    cfg32 = cfg.with_(compute_dtype="float32")
    y, z = specs.serving_split(dlm.init_model(cfg, 0, device=dev), cfg)
    rng = np.random.default_rng(0)
    clients, tau, b, seq = TP_ROUND
    tok = rng.integers(0, cfg.vocab_size, (clients, tau, b, seq),
                       dtype=np.int32)
    batch = {"tokens": tok, "labels": tok}
    w = torch.ones(clients, device=dev)
    ptok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, PREFILL_LEN))).to(dev)
    # the unmeshed runs: the round in float32 compute, the prefill
    rc = fedpt.RoundConfig(clients_per_round=0, local_steps=tau,
                           local_batch=0, client_opt="sgd", client_lr=0.02,
                           server_opt="sgdm", server_lr=0.5)
    round_fn, sopt = fedpt.make_round_fn(
        lambda p, mb: dlm.train_loss(p, cfg32, mb), rc, device=dev)
    y_ref = round_fn(y, sopt.init(y), z, batch, w, None)[0]
    with routing_spy() as rec:
        want = specs.make_prefill_step(cfg, device=dev)(y, z,
                                                        {"tokens": ptok})
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    def placed_pieces():
        mesh = init_device_mesh(torch.device(dev).type, (1, TP_RANKS),
                                mesh_dim_names=("data", "model"))

        def placed(tree):
            pl = shard_lib.param_shardings(tree, cfg, mesh)
            return tree_map(lambda x, p: shard_lib.distribute(x, mesh, p),
                            tree, pl)
        return mesh, placed

    def train_rank(rank):
        mesh, placed = placed_pieces()
        yd, zd = placed(y), placed(z)
        step, sopt = specs.make_train_step(cfg32, mesh, y, device=dev)
        t0 = time.perf_counter()
        y_new, _, m = step(yd, placed(sopt.init(y)), zd, batch, w)
        torch.cuda.synchronize()
        out = (shard_lib.gathered(y_new), float(m["loss"]),
               time.perf_counter() - t0)
        local = {p: (v.to_local().numel(), v.numel())
                 for p, v in basic.flatten_params(zd)}
        return (out, local) if rank == 0 else None

    def prefill_rank(rank):
        mesh, placed = placed_pieces()
        prefill = specs.make_tp_prefill_step(cfg, mesh, device=dev)
        yd, zd = placed(y), placed(z)
        t0 = time.perf_counter()
        logits = prefill(yd, zd, {"tokens": ptok})
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        whole = logits.full_tensor()
        return (whole, logits.placements, t_pre) if rank == 0 else None

    paths = [p for p, _ in basic.flatten_params(z)]
    t0 = time.perf_counter()
    with FrozenSeen(paths) as train_seen:
        (y_tp, loss, t_step), local = threaded_world(
            TP_RANKS, train_rank, TP_TIMEOUT)[0]
    peak_step = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    replay = routing_spy(rec.ids)
    with replay, FrozenSeen(paths) as prefill_seen:
        logits, placements, t_pre = threaded_world(TP_RANKS, prefill_rank,
                                                   TP_TIMEOUT)[0]
    PREFILL_PEAKS["(f)"] = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    rel = update_rel(y, y_ref, y_tp)
    rel_l = rel_to_max(logits, want)
    split = {p for p, (n, whole) in local.items() if n != whole}
    pieces = all(n * (TP_RANKS if p in split else 1) == whole
                 and train_seen.seen.get(p) == {n}
                 and prefill_seen.seen.get(p) == {n}
                 for p, (n, whole) in local.items())
    experts = all(any(p.endswith(k) for p in split)
                  for k in ("/moe/wi_gate", "/moe/wi_up", "/moe/wo"))
    print(f"[mesh] (f) {MIXTRAL}, {cfg.num_layers} layers at full width on "
          f"a (1, {TP_RANKS}) mesh of threads on the one card: the train "
          f"step ({clients} clients x tau {tau} x {b} x {seq}) in float32 "
          f"compute {t_step:.2f} s on rank 0, loss {loss:.4f}, against the "
          f"unmeshed float32 round by update norm {rel:.3e} (bound "
          f"{TP_F32_UPDATE_REL:g}); the prefill 1 x {PREFILL_LEN} "
          f"{t_pre:.2f} s on rank 0, logits {placements}, against the "
          f"unmeshed prefill routed alike ({replay.flipped} of "
          f"{replay.routed} routings would differ): max |diff| / max |logit| "
          f"{rel_l:.3e} (tolerance {LOGIT_REL:.3e}); {len(split)} of "
          f"{len(local)} frozen leaves split a rank (the experts "
          f"{experts}), and the loss and forward received each rank's "
          f"pieces {pieces}; both worlds {wall:.1f} s; card memory peak "
          f"{peak_step / 2 ** 30:.2f} GiB over the step's world, "
          f"{PREFILL_PEAKS['(f)'] / 2 ** 30:.2f} GiB over the meshed "
          f"prefill's; launches {({k: v for k, v in counts.items() if v})}")
    if not (rel <= TP_F32_UPDATE_REL and rel_l <= LOGIT_REL
            and math.isfinite(loss) and pieces and experts
            and counts["swa_attention"] > 0 and counts["sumsq"] > 0):
        raise AssertionError("(f) the 4-rank tensor-parallel Mixtral is "
                             "off the unmeshed runs")
    swa_local_heads(dev)
    return counts


def swa_local_heads(dev, label="(f)", heads=32, kv_heads=8,
                    window=MIXTRAL_WINDOW):
    """``swa_attention`` (round-once) at a (1, TP_RANKS) rank's local
    heads of a prefill (Mixtral's by default: (1, 8 q / 2 kv, PREFILL_LEN,
    128) at window 4,096): wrapper and device ms, the bound, its plain
    version (``chunked_attention_ref``, once) and
    ``scaled_dot_product_attention`` (with a (1, 1, S, S) boolean window
    mask where there is a window, else causal), k and v repeated to q's
    heads."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator().manual_seed(0)
    hq, hk = heads // TP_RANKS, kv_heads // TP_RANKS
    q, k, v = swa_inputs((1, hq, PREFILL_LEN, 128), hk, gen, dev)

    def call():
        return ops.swa_attention(q, k, v, window=window, causal=True,
                                 round_p=True)
    pairs = swa.visible_pairs(PREFILL_LEN, window)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    bnd = bound(nbytes, 4 * hq * 128 * pairs, BF16_OPS_PER_S)
    ms = time_ms(call, 10, 2)
    dms = device_ms(call, ("swa_kernel",), 10)
    plain_ms = time_ms(lambda: ref.chunked_attention_ref(
        q, k, v, window, chunk=swa.BK), 1, 0)
    kr, vr = (t.repeat_interleave(hq // hk, dim=1) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = {"is_causal": True}
    if window:
        pos = torch.arange(PREFILL_LEN, device=dev)
        kw = {"attn_mask": ((pos[:, None] >= pos[None, :])
                            & (pos[:, None] - pos[None, :] < window))[
                                None, None]}
    lib_ms = time_ms(lambda: sdpa(q, kr, vr, **kw), 10, 2)
    lib_dms = device_ms(lambda: sdpa(q, kr, vr, **kw), None, 10)
    print(f"[mesh] {label} swa_attention (round-once) at a rank's local heads "
          f"(1, {hq} q / {hk} kv, {PREFILL_LEN}, 128), window "
          f"{window}: wrapper {ms:.4f} ms, device {fmt_ms(dms)} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}); plain (chunked_attention_ref, "
          f"chunk {swa.BK}) {plain_ms:.3f} ms; scaled_dot_product_attention "
          f"({'a (1, 1, S, S) bool window mask' if window else 'causal'}, "
          f"k / v repeated) {lib_ms:.4f} ms (device {fmt_ms(lib_dms)} ms)")
    del q, k, v, kr, vr, kw
    torch.cuda.empty_cache()


class swa_shapes:
    """Inside a ``with``, records the (q, v) shapes of every
    ``kernels/ops.swa_attention`` call, on every thread."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.mod, self.real, self.seen = ops, ops.swa_attention, []

        def spy(q, k, v, **kw):
            self.seen.append((tuple(q.shape), tuple(v.shape)))
            return self.real(q, k, v, **kw)
        ops.swa_attention = spy
        return self

    def __exit__(self, *exc):
        self.mod.swa_attention = self.real
        return False


class TPLeg(NamedTuple):
    """A tensor-parallel leg of phase 11 on a ("data", "model") mesh of
    threads on the one card (:func:`drive_tp_world`): the config at full
    width and ``layers`` of its layers, the mesh's ``shape``, the
    ``prefill`` (rows, positions; the rows split over "data"), the float32
    train step's ``round`` (clients, tau, rows, positions); ``split``: the
    leaves (path suffixes, frozen or trainable) the rules split, each
    with the pieces a rank holds 1 / n of, every other frozen leaf whole;
    ``swa``: the ``swa_attention`` (q, v) shapes the prefill launches (a
    launch a rank an attention layer); ``over``: the config's overrides
    besides its depth; ``prefill_f32``: both prefills in float32 compute
    (bf16 by default, the serving path's), held within LOGIT_REL, and
    then also both in bf16, held within WITNESS_X times the gap a second
    bf16 rounding of the unmeshed prefill makes (``ulp_moved_mlstm``);
    ``whole``: trainable leaves (path suffixes) that no rule splits, each
    whole on every rank and the same on every rank after the step. The
    VLM's prefill and round take ``stub_inputs``' patch embeddings, the
    encoder-decoder's its frames, their rows placed as the tokens'."""
    label: str
    arch: str
    layers: int
    shape: tuple
    prefill: tuple
    round: tuple
    split: dict
    swa: frozenset = frozenset()
    what: str = ""
    over: dict = {}
    prefill_f32: bool = False
    whole: tuple = ()


class ulp_moved_mlstm:
    """Inside a ``with``: every mLSTM block's output (``nn/ssm.
    mlstm_forward``; bf16 at full width) moved one ulp away from zero at a random
    half of its elements (seeded): a second rounding of the same function,
    as the tensor-parallel ``down_proj`` (partial products summed in
    float32, then rounded once) is. The unmeshed prefill under it against
    the plain unmeshed prefill is the witness of how far two bf16
    roundings of the block's output move the logits."""

    def __enter__(self):
        from repro_torch.nn import ssm
        self.mod, self.real, gen = ssm, ssm.mlstm_forward, {}

        def moved(*a, **kw):
            out, state = self.real(*a, **kw)
            bits = {2: torch.int16, 4: torch.int32}[out.element_size()]
            if out.device not in gen:
                gen[out.device] = torch.Generator(out.device).manual_seed(0)
            up = torch.randint(0, 2, out.shape, generator=gen[out.device],
                               device=out.device, dtype=bits)
            return (out.view(bits) + up).view(out.dtype), state
        ssm.mlstm_forward = moved
        return self

    def __exit__(self, *exc):
        self.mod.mlstm_forward = self.real
        return False


def logit_gap(got, want, dev, rows=(0, None), cols=(0, None)):
    """max |got - want[rows, :, cols]| over the (B, S, V) logits, ``want``
    on the host, a slice of 4,096 positions at a time on the card."""
    gap = 0.0
    for c in range(0, got.shape[1], 4096):
        ref_c = want[rows[0]:rows[1], c:c + 4096, cols[0]:cols[1]].to(dev)
        gap = max(gap, float((got[:, c:c + 4096].float()
                              - ref_c.float()).abs().max()))
        del ref_c
    return gap


def drive_tp_world(dev, leg: TPLeg):
    """``leg`` on its mesh of threads (``threaded_world``): each rank's y
    and frozen pieces as DTensors placed by the reference's rules. Its
    tensor-parallel prefill against the unmeshed prefill, routed as it
    (``routing_spy``), within LOGIT_REL of the largest |logit|: each rank
    holds its piece of the logits (its rows, its vocab columns) against
    the same piece of the unmeshed ones (with ``leg.prefill_f32`` also
    the bf16 pair, at the witness's bound). One train step in float32
    compute against the unmeshed float32 round by update norm
    (TP_F32_UPDATE_REL). The unmeshed runs go first, their y and the new
    y are kept on the host, and the whole trees are freed once the ranks'
    pieces are made (the data ranks of one "model" index share their y
    pieces; the zero server state is a view), so the card holds one copy
    of the parameters beside the ranks' work. ``FrozenSeen``: the frozen
    leaves the loss and forward receive on every rank, and the split
    trainable ones the forward receives, are its pieces (``leg.split``).
    Returns the meshed runs' launch counts."""
    from repro_torch import kernels
    from repro_torch.configs.base import ATTN, get_config
    from repro_torch.core import fedpt
    from repro_torch.launch import mesh as mesh_lib
    FrozenSeen = frozen_seen()
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch import specs
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn import basic
    from repro_torch.nn.basic import tree_map
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    D, M = leg.shape
    cfg = get_config(leg.arch).with_(num_layers=leg.layers, **leg.over)
    cfg32 = cfg.with_(compute_dtype="float32")
    cfg_pre = cfg32 if leg.prefill_f32 else cfg
    t0 = time.perf_counter()
    y, z = specs.serving_split(dlm.init_model(cfg, 0, device=dev), cfg)
    rng = np.random.default_rng(0)
    clients, tau, b, seq = leg.round
    tok = rng.integers(0, cfg.vocab_size, (clients, tau, b, seq),
                       dtype=np.int32)
    batch = {"tokens": tok, "labels": tok}
    w = torch.ones(clients, device=dev)
    # the VLM's patch embeddings, the encoder-decoder's frames: a
    # sentence's each in the round, a row's each in the prefill
    for k, v in stub_inputs(cfg, clients * tau * b, dev).items():
        batch[k] = v.reshape((clients, tau, b) + tuple(v.shape[1:]))
    rows, plen = leg.prefill
    ptok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (rows, plen))).to(dev)
    pstub = stub_inputs(cfg, rows, dev, seed=1)
    # the unmeshed runs, their results kept on the host: the prefill (and
    # the bf16 pair's, with its witness), the round in float32 compute
    def unmeshed_prefill(c):
        with routing_spy() as rec:
            out = specs.make_prefill_step(c, device=dev)(
                y, z, {"tokens": ptok, **pstub})
        lo, hi = torch.aminmax(out)
        return out.cpu(), max(-float(lo), float(hi)), rec
    # (config, unmeshed logits, their largest |logit|, routing, bound)
    holds = [(cfg_pre, *unmeshed_prefill(cfg_pre), LOGIT_REL)]
    witness = None
    if leg.prefill_f32:
        want16, lmax16, rec16 = unmeshed_prefill(cfg)
        with ulp_moved_mlstm():
            moved = specs.make_prefill_step(cfg, device=dev)(
                y, z, {"tokens": ptok, **pstub})
        witness = logit_gap(moved, want16, dev) / lmax16
        del moved
        holds.append((cfg, want16, lmax16, rec16, WITNESS_X * witness))
    torch.cuda.empty_cache()
    mem = {"unmeshed prefill": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    rc = fedpt.RoundConfig(clients_per_round=0, local_steps=tau,
                           local_batch=0, client_opt="sgd", client_lr=0.02,
                           server_opt="sgdm", server_lr=0.5)
    round_fn, sopt = fedpt.make_round_fn(
        lambda p, mb: dlm.train_loss(p, cfg32, mb), rc, device=dev)
    y_ref = tree_map(lambda t: t.cpu(), round_fn(y, sopt.init(y), z, batch,
                                                 w, None)[0])
    del round_fn
    torch.cuda.empty_cache()
    mem["unmeshed round"] = torch.cuda.max_memory_allocated()
    t_unmeshed = time.perf_counter() - t0
    # each rank's pieces, then the whole trees freed
    struct, zstruct = (tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), tree) for tree in (y, z))
    abstract = mesh_lib.AbstractMesh(leg.shape, ("data", "model"))
    pl_y = shard_lib.param_shardings(struct, cfg, abstract)
    pl_z = shard_lib.param_shardings(zstruct, cfg, abstract)
    y0 = tree_map(lambda t: t.cpu(), y)

    def pieces(tree, pl, coord):       # the rank at coord's, contiguous
        return tree_map(lambda x, p: shard_lib.local_piece(
            x, abstract, p, coord).contiguous(), tree, pl)
    ypieces = [pieces(y, pl_y, (0, m)) for m in range(M)]
    # the server state starts at zero: a zero element expanded to each
    # piece's shape (a view), so the ranks hold no copy of it
    sspieces = [tree_map(lambda t: t.new_zeros(()).expand(t.shape), yp)
                for yp in ypieces]
    zpieces = {(d, m): pieces(z, pl_z, (d, m))
               for d in range(D) for m in range(M)}
    del y, z
    torch.cuda.empty_cache()
    mem["pieces"] = torch.cuda.memory_allocated()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    def world_of():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        mesh = init_device_mesh(torch.device(dev).type, leg.shape,
                                mesh_dim_names=("data", "model"))
        d, m = mesh.get_coordinate()

        def placed(pieces, pl, st):
            return tree_map(lambda x, p, s: DTensor.from_local(
                x, mesh, p, run_check=False, shape=s.shape,
                stride=s.stride()), pieces, pl, st)
        return (mesh, placed(ypieces[m], pl_y, struct),
                placed(sspieces[m], pl_y, struct),
                placed(zpieces[d, m], pl_z, zstruct))

    def prefill_rank(rank):
        from torch.distributed.tensor import Replicate, Shard
        mesh, yd, _, zd = world_of()
        prefill = specs.make_tp_prefill_step(hold[0], mesh, device=dev)
        tokd, *stubd = (shard_lib.distribute(t, mesh, (Shard(0), Replicate()))
                        for t in (ptok, *pstub.values()))
        # this rank's rows' routing in the unmeshed prefill's
        replay.offsets[threading.get_ident()] = shard_lib.local_range(
            rows, mesh, tokd.placements, 0)[0] * plen
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(yd, zd, {"tokens": tokd, **dict(zip(pstub, stubd))})
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        local = logits.to_local()
        r0, r1 = shard_lib.local_range(rows, mesh, logits.placements, 0)
        v0, v1 = shard_lib.local_range(cfg.vocab_size, mesh,
                                       logits.placements, 2)
        gap = logit_gap(local, hold[1], dev, (r0, r1), (v0, v1))
        return gap, bool(torch.isfinite(local).all()), \
            repr(logits.placements), t_pre

    def train_rank(rank):
        mesh, yd, ssd, zd = world_of()
        step, _ = specs.make_train_step(cfg32, mesh, struct, device=dev)
        t0 = time.perf_counter()
        y_new, _, met = step(yd, ssd, zd, batch, w)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        whole = {}                      # rank 0's copy, on the host
        mine = {}                       # this rank's leg.whole pieces
        for path, v in basic.flatten_params(y_new):
            if leg.whole and path.endswith(leg.whole):
                mine[path] = v.to_local().cpu()
            t = v.full_tensor()         # a leaf at a time, every rank
            if rank == 0:
                whole[path] = t.cpu()
            del t
        return (basic.unflatten_params(whole), float(met["loss"]), t_step,
                mine)

    zpaths = [p for p, _ in basic.flatten_params(zstruct)]
    ysplit = [p for p, _ in basic.flatten_params(struct)
              if p.endswith(tuple(leg.split))]
    print(f"[mesh] {leg.label} card memory (GiB): "
          f"{mem['unmeshed prefill'] / 2 ** 30:.2f} and "
          f"{mem['unmeshed round'] / 2 ** 30:.2f} at the unmeshed "
          f"prefill's and round's peaks, {mem['pieces'] / 2 ** 30:.2f} held "
          f"in the ranks' pieces before the worlds start", flush=True)
    t0 = time.perf_counter()
    pres = []                     # (gap / max |logit|, bound, rank results)
    with swa_shapes() as shapes, \
            FrozenSeen(zpaths + ysplit) as prefill_seen:
        for hold in holds:
            replay = routing_spy(hold[3].ids)
            with replay:
                pre = threaded_world(D * M, prefill_rank, TP_TIMEOUT)
            pres.append((max(g for g, *_ in pre) / hold[2], hold[4], pre,
                         replay))
    del holds, hold
    torch.cuda.empty_cache()
    mem["meshed prefill"] = torch.cuda.max_memory_allocated()
    PREFILL_PEAKS[leg.label] = mem["meshed prefill"]
    print(f"[mesh] {leg.label} the meshed prefill's peak "
          f"{mem['meshed prefill'] / 2 ** 30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held after it",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with FrozenSeen(zpaths) as train_seen:
        trained = threaded_world(D * M, train_rank, TP_TIMEOUT)
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    mem["meshed step"] = torch.cuda.max_memory_allocated()
    y_tp, loss, t_step, mine = trained[0]
    # the leaves no rule splits: whole on every rank, the same bits
    same = bool(mine) == bool(leg.whole) and all(
        sorted(r[3]) == sorted(mine) and all(
            torch.equal(r[3][p], t) and t.shape == dict(
                basic.flatten_params(struct))[p].shape
            for p, t in mine.items())
        for r in trained)
    rel = update_rel(y0, y_ref, y_tp, dev)
    rel_l, _, pre, replay = pres[0]
    finite = all(f for _, _, pre_i, _ in pres for _, f, *_ in pre_i)
    bf16_pair = ("" if witness is None else
                 f"; in bf16 compute: max |diff| / max |logit| "
                 f"{pres[1][0]:.3e}, the witness (the unmeshed bf16 prefill "
                 f"with each mLSTM output moved one ulp at half its "
                 f"elements) {witness:.3e}, tolerance WITNESS_X x witness "
                 f"{pres[1][1]:.3e}")

    def parts(path):
        return next((n for k, n in leg.split.items() if path.endswith(k)), 1)
    local = {p: (v.numel(), s.numel()) for (p, v), (_, s) in zip(
        basic.flatten_params(zpieces[0, 0]), basic.flatten_params(zstruct))}
    local.update({p: (v.numel(), s.numel()) for (p, v), (_, s) in zip(
        basic.flatten_params(ypieces[0]), basic.flatten_params(struct))
        if p in ysplit})
    split = sorted({k for k in leg.split
                    if any(p.endswith(k) for p in local)})
    pieces = (split == sorted(leg.split) and all(
        n * parts(p) == whole and prefill_seen.seen.get(p) == {n}
        and (p in ysplit or train_seen.seen.get(p) == {n})
        for p, (n, whole) in local.items()))
    heads = frozenset(shapes.seen)
    print(f"[mesh] {leg.label} {leg.arch}, {cfg.num_layers} layers at full "
          f"width{leg.what} on a {leg.shape} ('data', 'model') mesh of "
          f"threads on the one card: the unmeshed round and prefill "
          f"{t_unmeshed:.1f} s; the train step ({clients} clients x tau "
          f"{tau} x {b} x {seq}) in float32 compute {t_step:.2f} s on rank "
          f"0, loss {loss:.4f}, against the unmeshed float32 round by update "
          f"norm {rel:.3e} (bound {TP_F32_UPDATE_REL:g}); the prefill {rows} "
          f"x {plen} in {cfg_pre.compute_dtype} compute "
          f"{max(t for *_, t in pre):.2f} s, logits {pre[0][2]}, "
          f"against the unmeshed prefill routed alike ({replay.flipped} of "
          f"{replay.routed} routings would differ): max |diff| / max |logit| "
          f"{rel_l:.3e} (tolerance {LOGIT_REL:.3e}){bf16_pair}; "
          f"swa_attention's (q, v) shapes {sorted(heads)}; the split leaves "
          f"{ {k: f'1/{n}' for k, n in leg.split.items()} } and every other "
          f"frozen leaf whole a rank, and the loss and forward received each "
          f"rank's pieces {pieces}"
          + (f"; {sorted(mine)} whole and the same on every rank after "
             f"the step {same}" if leg.whole else "")
          + f"; both worlds {wall:.1f} s; launches "
          f"{({k: v for k, v in counts.items() if v})}; card memory (GiB, "
          f"peaks, and the pieces held before the worlds) "
          f"{ {k: round(v / 2 ** 30, 2) for k, v in mem.items()} }")
    # a call a rank an attention layer a prefill; an encoder-decoder's
    # decoder layers add their cross-attention, its encoder a call a layer
    calls = sum(k == ATTN for k in cfg.block_kinds())
    if cfg.is_encoder_decoder:
        calls = 2 * calls + cfg.encoder_layers
    if not (rel <= TP_F32_UPDATE_REL and finite
            and all(r <= b for r, b, *_ in pres)
            and math.isfinite(loss) and pieces and same
            and heads == leg.swa
            and counts["swa_attention"] == D * M * calls * len(pres)
            and counts["sumsq"] > 0):
        raise AssertionError(f"{leg.label} the {leg.shape} tensor-parallel "
                             f"{leg.arch} is off the unmeshed runs")
    return counts


def ds_tp_leg() -> TPLeg:
    """(g): DeepSeek-V2 on DS_TP_SHAPE, the routed experts a quarter of
    the bank a rank, ``swa_attention`` on a rank's MLA heads."""
    from repro_torch.configs.base import get_config
    rows, plen = DS_TP_PREFILL
    D, M = DS_TP_SHAPE
    heads = get_config(DEEPSEEK).num_heads // M
    return TPLeg("(g)", DEEPSEEK, DEEPSEEK_TRAIN_LAYERS, DS_TP_SHAPE,
                 DS_TP_PREFILL, DS_TP_ROUND,
                 {k: D * M for k in ("/moe/wi_gate", "/moe/wi_up", "/moe/wo")},
                 frozenset({((rows // D, heads, plen, MLA_DK),
                             (rows // D, heads, plen, MLA_DV))}),
                 ", the routed experts in the 2-D layout")


def drive_deepseek_tp_threads(dev):
    """(g) DeepSeek-V2-236B at full width, DEEPSEEK_TRAIN_LAYERS layer, on
    a DS_TP_SHAPE ("data", "model") mesh of threads (:func:`drive_tp_world`):
    its 160 routed experts in the 2-D layout (expert dim on "data", FFN
    dim on "model"), each MoE layer's buffer exchanged over "data"; the
    prefill's rows one a data rank; ``swa_attention`` on each rank's 64
    heads at (192, 128), then timed there (:func:`mla_local_heads`)."""
    counts = drive_tp_world(dev, ds_tp_leg())
    mla_local_heads(dev)
    return counts


def drive_jamba_tp_threads(dev):
    """(h) Jamba-v0.1 at full width, JAMBA_TP_LAYERS layers (Mamba with the
    dense FFN, then attention with the MoE), on a (1, TP_RANKS) mesh of
    threads (:func:`drive_tp_world`): Mamba on each rank's 2,048 of its
    8,192 channels (``in_proj``'s column block moved to them by an
    all-to-all), the 16 experts 4 a rank, the dense FFN and the vocab
    split, ``swa_attention`` on each rank's 8 q / 2 kv heads (causal, no
    window), then timed there (:func:`swa_local_heads`)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(JAMBA)
    mamba = {f"/mamba/{k}": TP_RANKS for k in (
        "in_proj/kernel", "out_proj/kernel", "x_proj/kernel",
        "dt_proj/kernel", "conv_w", "conv_b", "A_log", "D")}
    ffn = {k: TP_RANKS for k in ("/moe/wi_gate", "/moe/wi_up", "/moe/wo",
                                 "/ffn/wi_gate/kernel", "/ffn/wi_up/kernel",
                                 "/ffn/wo/kernel")}
    rows, plen = JAMBA_TP_PREFILL
    hd = cfg.resolved_head_dim
    heads = ((rows, cfg.num_heads // TP_RANKS, plen, hd),
             (rows, cfg.num_kv_heads // TP_RANKS, plen, hd))
    counts = drive_tp_world(dev, TPLeg(
        "(h)", JAMBA, JAMBA_TP_LAYERS, (1, TP_RANKS), JAMBA_TP_PREFILL,
        TP_ROUND, {**mamba, **ffn}, frozenset({heads}),
        ", Mamba on each rank's channels", JAMBA_TP_OVER))
    swa_local_heads(dev, "(h)", cfg.num_heads, cfg.num_kv_heads,
                    cfg.sliding_window)
    return counts


def drive_xlstm_tp_threads(dev):
    """(i) xLSTM-350M at full width, one period of its layer program (3
    mLSTM blocks, 1 sLSTM), on a (1, TP_RANKS) mesh of threads
    (:func:`drive_tp_world`): the mLSTM's ``up_proj`` column- and
    ``down_proj`` row-parallel around its cell, run whole on every rank,
    the sLSTM whole, the tied embedding split by vocab; no attention.
    Its prefill is held in float32 compute within LOGIT_REL: in bf16 the
    meshed prefill measured 7.714e-02 of the largest |logit| off the
    unmeshed one (over 2^-4; PERF.md), the sLSTM growing the two sides'
    one-ulp bf16 flips over 2,048 positions, as phase 9 found between
    decode and forward. The bf16 pair is held as well, within WITNESS_X
    times the gap the unmeshed bf16 prefill makes against itself with
    each mLSTM output moved one ulp (``ulp_moved_mlstm``)."""
    return drive_tp_world(dev, TPLeg(
        "(i)", XLSTM, XLSTM_TP_LAYERS, (1, TP_RANKS), XLSTM_PREFILL,
        TP_ROUND, {"/mlstm/up_proj/kernel": TP_RANKS,
                   "/mlstm/down_proj/kernel": TP_RANKS},
        what=", the mLSTM's projections split", prefill_f32=True))


def drive_paligemma_tp_threads(dev):
    """(j) PaliGemma-3B at full width, PALIGEMMA_TP_LAYERS of its layers,
    on a (1, TP_RANKS) mesh of threads (:func:`drive_tp_world`): the
    prefill of PALIGEMMA_TP_PREFILL rows of 256 patch embeddings and 256
    tokens, ``swa_attention`` on each rank's 2 q heads against its one kv
    head of 256 (split in 64-column quarters and gathered) with the
    256-key bidirectional prefix, the (256, 128) instance's two v slices;
    ``mm_proj`` whole on every rank and the same after the step; the
    frozen GeGLU FFN and the tied embedding split by vocab. Then the
    kernel at that rank's shape, held to the plain version and timed
    (TP_VLM_SHAPES)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(PALIGEMMA)
    rows, plen = PALIGEMMA_TP_PREFILL
    seq = cfg.num_prefix_tokens + plen
    hd = cfg.resolved_head_dim
    heads = ((rows, cfg.num_heads // TP_RANKS, seq, hd), (rows, 1, seq, hd))
    split = {k: TP_RANKS for k in (
        "/ffn/wi_gate/kernel", "/ffn/wi_up/kernel", "/ffn/wo/kernel",
        "/attn/wq/kernel", "/attn/wk/kernel", "/attn/wv/kernel",
        "embed/embedding")}
    counts = drive_tp_world(dev, TPLeg(
        "(j)", PALIGEMMA, PALIGEMMA_TP_LAYERS, (1, TP_RANKS),
        PALIGEMMA_TP_PREFILL, TP_ROUND, split, frozenset({heads}),
        ", 256 patch embeddings a sequence",
        whole=("mm_proj/kernel", "mm_proj/bias")))
    check_vlm_encdec_kernels(dev, TP_VLM_SHAPES, TP_SHAPE_ITERS, (1, 0))
    return counts


def drive_whisper_tp_threads(dev):
    """(k) Whisper large-v3 at full width, WHISPER_TP_LAYERS + as many
    encoder layers, on a (1, TP_RANKS) mesh of threads
    (:func:`drive_tp_world`): the prefill of WHISPER_TP_PREFILL rows of
    1,500 frames and 448 tokens; ``swa_attention`` on each rank's 5 of 20
    heads in the encoder (non-causal, 1,500 x 1,500), the decoder's
    self-attention and the cross-attention (448 queries against the
    1,500 frames, k and v from the encoder's output, which every rank
    holds whole); the frozen encoder FFN split, the vocab of 51,866 whole
    on every rank (it does not divide 4) and the same after the step.
    Then the kernel at the encoder's and the cross-attention's rank
    shapes, held to the plain version and timed (TP_WHISPER_SHAPES)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(WHISPER)
    rows, plen = WHISPER_TP_PREFILL
    e, h, hd = cfg.encoder_seq_len, cfg.num_heads // TP_RANKS, \
        cfg.resolved_head_dim
    enc, dec = (rows, h, e, hd), (rows, h, plen, hd)
    split = {k: TP_RANKS for k in (
        "/ffn/wi/kernel", "/ffn/wo/kernel", "/attn/wq/kernel",
        "/attn/wo/kernel", "/cross_attn/wq/kernel", "/cross_attn/wk/kernel",
        "/cross_attn/wv/kernel", "/cross_attn/wo/kernel")}
    counts = drive_tp_world(dev, TPLeg(
        "(k)", WHISPER, WHISPER_TP_LAYERS, (1, TP_RANKS), WHISPER_TP_PREFILL,
        TP_ROUND, split, frozenset({(enc, enc), (dec, dec), (dec, enc)}),
        f", {WHISPER_TP_LAYERS} encoder layers, 1,500 frames a sequence",
        {"encoder_layers": WHISPER_TP_LAYERS},
        whole=("embed/embedding", "unembed/kernel")))
    check_vlm_encdec_kernels(dev, TP_WHISPER_SHAPES, TP_SHAPE_ITERS, (1, 0))
    return counts


def mla_local_heads(dev):
    """``swa_attention`` (round-once) at a (2, 2) mesh rank's heads of
    DeepSeek-V2's prefill: (1, 64, PREFILL_LEN, 192 / 128) causal, 64 kv
    heads (wrapper and device ms, the bound), its plain version
    (``chunked_attention_ref``, once) and ``scaled_dot_product_attention``
    (default backend) on the same inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator().manual_seed(0)
    h = MLA_HEADS // DS_TP_SHAPE[1]

    def one(d):
        return torch.randn((1, PREFILL_LEN, h, d), generator=gen).to(
            dev, torch.bfloat16).transpose(1, 2)
    q, k, v = one(MLA_DK), one(MLA_DK), one(MLA_DV)

    def call():
        return swa.swa_attention(q, k, v, round_p=True)
    pairs = swa.visible_pairs(PREFILL_LEN, 0)
    flops = h * pairs * 2 * (MLA_DK + MLA_DV)
    nbytes = 2 * (q.numel() + k.numel() + 2 * v.numel())
    bnd = bound(nbytes, flops, BF16_OPS_PER_S)
    ms = time_ms(call, 5, 1)
    dms = device_ms(call, ("swa_kernel",), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref.chunked_attention_ref(q, k, v, 0, chunk=swa.BK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True), 5, 1)
    lib_dms = device_ms(lambda: sdpa(q, k, v, is_causal=True), None, 5)
    print(f"[mesh] (g) swa_attention (round-once) at a rank's heads (1, {h}, "
          f"{PREFILL_LEN}, {MLA_DK} / {MLA_DV}) causal: wrapper {ms:.4f} ms, "
          f"device {fmt_ms(dms)} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
          f"x{(dms or ms) / bnd[0]:.2f}; plain (chunked_attention_ref, chunk "
          f"{swa.BK}) {plain_ms:.3f} ms; scaled_dot_product_attention "
          f"{lib_ms:.4f} ms (device {fmt_ms(lib_dms)} ms)")
    del q, k, v
    torch.cuda.empty_cache()


def drive_mesh(ds, y0, frozen, ya, za, dev):
    """Phase 11: (a) the 1-rank NCCL group and the "single" mesh; (b) the
    quickstart at int8, FedAvg B (fused coefficient route, DP, screen) and
    the async DP FedBuff grid, each with and without the mesh, bit for bit
    with equal launches (cuDNN deterministic); (e) StableLM-2-1.6B's
    train step and Mixtral-8x7B's prefill, tensor-parallel on the 1-rank
    mesh; (c) Mixtral-8x7B's train step in the gathered layout (its
    experts in the ``2d_swapped`` mode) on the 1-rank mesh; (f)
    Mixtral-8x7B on a 4-rank "model" axis of threads; (g) DeepSeek-V2 on
    a (2, 2) mesh of threads, 2-D experts; (h) Jamba-v0.1, (i)
    xLSTM-350M, (j) PaliGemma-3B and (k) Whisper large-v3 on a 4-rank
    "model" axis of threads; (d) the dry run, started first and read
    last. Returns the launch counts of (b), (c) and (e) to (k)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    proc = start_dryrun()
    try:
        mesh = mesh_lib.resolve_mesh("single", dev)
        t = torch.ones(4, device=dev)
        dist.all_reduce(t, group=mesh.get_group("data"))
        torch.cuda.synchronize()
        print(f"[mesh] (a) backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {mesh_lib.axis_sizes(mesh)}; "
              f"an all-reduce over 'data' gave {t.tolist()}")
        if dist.get_backend() != "nccl" or t.tolist() != [1.0] * 4:
            raise AssertionError("(a) the 1-rank NCCL group")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        launches = {}
        try:
            draws = cohorts(ds, ROUNDS)
            task = emnist_async()

            def async_mesh(mesh):
                task["grid"] = {"mesh": mesh}
                res = async_run(ds, lambda s: task["init"](s, device=dev),
                                ASYNC_UPDATES, dev, task)
                return [h["loss"] for h in res.history], res.y
            for counts in (
                    mesh_pair("(b) quickstart, uplink_bits=8",
                              mesh_rounds(y0, frozen, 8, False, draws, dev),
                              ("sumsq", "fake_quantize_flat",
                               "fake_quantize_flat/cluster")),
                    mesh_pair("(b) FedAvg B, int8 DP-FedAvg + screen",
                              mesh_rounds(ya, za, 8, True, draws, dev),
                              ("block_stats", "pack", "apply_coeff")),
                    mesh_pair(f"(b) {task['label']}, {ASYNC_UPDATES} "
                              f"updates", async_mesh, task["expect"])):
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
        finally:
            torch.backends.cudnn.deterministic = deterministic
        for leg in (drive_gathered_train_step, drive_tp_single_train_step,
                    drive_tp_single_prefill,
                    drive_tp_threads, drive_deepseek_tp_threads,
                    drive_jamba_tp_threads, drive_xlstm_tp_threads,
                    drive_paligemma_tp_threads, drive_whisper_tp_threads):
            t0 = time.perf_counter()
            for k, v in leg(dev).items():
                launches[k] = launches.get(k, 0) + v
            torch.cuda.empty_cache()
            print(f"[mesh] {leg.__name__} took "
                  f"{time.perf_counter() - t0:.1f} s")
        peaks = {k: round(v / 2 ** 30, 2) for k, v in PREFILL_PEAKS.items()}
        print(f"[mesh] the card's peak over each meshed prefill (GiB): "
              f"{peaks}")
        finish_dryrun(proc, dev)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the examples. Each examples_torch/ twin's main, in this process,
# on the card, at the reference CI's invocations (.github/workflows/ci.yml's
# examples, telemetry and chaos jobs), the quickstart and dp_federated_lm
# at their defaults, federated_llm_finetune on one id of each family and
# serve_longcontext as is

EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
QDQ = ("fake_quantize_flat", "fake_quantize_flat/cluster")
# the async grid at uplink_bits=8: delta_norm's sumsq and the lane's Q->DQ
ASYNC_KERNELS = ("sumsq",) + QDQ
# the golden gate of the CI's telemetry job
FAIL_ON = ("counter.dispatches", "counter.uploads", "counter.dropouts",
           "counter.crashes", "counter.truncated", "counter.duplicates",
           "counter.corrupted", "counter.quarantined")
# one id of each family: MoE, MLA, the SSMs (xLSTM, Jamba), the VLM and
# the encoder-decoder; each reference run's loss falls over 8 rounds on
# the CPU
FINETUNE_ARCHS = ("mixtral-8x7b", "deepseek-v2-236b", "xlstm-350m",
                  "jamba-v0.1-52b", "paligemma-3b", "whisper-large-v3")
# (CI job, twin, argv, kernels that must launch, schema checks: argv of
# repro_torch.obs.schema, relative to the run's directory)
EXAMPLE_RUNS = [
    ("examples", "async_heterogeneous",
     ["--rounds", "4", "--trace", "trace.json", "--trace-jsonl",
      "trace.jsonl"], ASYNC_KERNELS, []),
    ("examples", "async_heterogeneous", ["--tiers", "--rounds", "4"],
     ASYNC_KERNELS, []),
    ("examples", "async_heterogeneous", ["--regions", "--rounds", "4"],
     ASYNC_KERNELS, []),
    ("examples", "async_heterogeneous", ["--chaos", "--rounds", "4"],
     ASYNC_KERNELS, []),
    ("examples", "adaptive_tiers", ["--rounds", "8"], QDQ, []),
    ("telemetry", "async_heterogeneous",
     ["--rounds", "3", "--trace", "t3.json", "--trace-jsonl", "t3.jsonl"],
     ASYNC_KERNELS,
     [["t3.jsonl", "--perfetto", "t3.json", "--require", "dispatch",
       "upload", "flush"], ["t3.jsonl", "--require-ids"]]),
    ("telemetry", "async_heterogeneous",
     ["--regions", "--rounds", "6", "--trace", "regions.json",
      "--trace-jsonl", "regions.jsonl"], ASYNC_KERNELS,
     [["regions.jsonl", "--perfetto", "regions.json", "--require",
       "dispatch", "upload", "flush", "edge_flush", "shock"],
      ["regions.jsonl", "--require-ids"]]),
    ("telemetry", "async_heterogeneous",
     ["--chaos", "--regions", "--rounds", "4", "--trace-jsonl",
      "combined.jsonl", "--report", "report.md", "--metrics-out",
      "metrics.json"], ASYNC_KERNELS,
     [["combined.jsonl", "--require-ids", "--require", "dispatch",
       "upload", "flush", "edge_flush", "fault", "quarantine"]]),
    ("chaos", "async_heterogeneous",
     ["--chaos", "--rounds", "4", "--trace", "chaos.json", "--trace-jsonl",
      "chaos.jsonl"], ASYNC_KERNELS,
     [["chaos.jsonl", "--perfetto", "chaos.json", "--require", "fault",
       "quarantine", "checkpoint"]]),
    ("default", "quickstart", [], ("sumsq",), []),
    ("default", "dp_federated_lm", [], ("sumsq",), []),
] + [("family", "federated_llm_finetune",
      ["--arch", arch, "--rounds", "8"], ("sumsq",), [])
     for arch in FINETUNE_ARCHS] + [
    ("default", "serve_longcontext", [], (), []),
]


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (its main not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive_examples(dev) -> dict:
    """Phase 12: every run of EXAMPLE_RUNS from a directory of its own
    (the relative file arguments land there), the launch counts set to 0
    just before its main and read just after; its kernels, schema checks
    and wall time; the golden gate on the hostile hierarchical run's
    metrics; serve_longcontext's caches and decoded lengths. Returns the
    launch counts summed over the runs."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.obs import compare, schema
    total = {name: 0 for name in {**kernels.LAUNCHES, **kernels.ROUTES}}
    here = os.getcwd()
    walls = []
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        for i, (job, name, argv, expect, checks) in enumerate(EXAMPLE_RUNS):
            label = " ".join([f"examples_torch/{name}.py"] + argv)
            run_dir = os.path.join(tmp, f"run{i}")
            os.makedirs(run_dir)
            main = load_example(name).main
            os.chdir(run_dir)
            try:
                print(f"[examples] {label} ({job})")
                kernels.reset_launches()
                t0 = time.perf_counter()
                out = main(list(argv) + ["--device", str(dev)])
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = {**kernels.LAUNCHES, **kernels.ROUTES}
                for check in checks:
                    if schema.main(list(check)) != 0:
                        raise AssertionError(f"{label}: schema check "
                                             f"{check} failed")
                if "--metrics-out" in argv:
                    gate = [os.path.join(ROOT,
                                         "GOLDEN_telemetry_metrics.json"),
                            "metrics.json", "--changed-only", "-o",
                            "metrics_diff.md"]
                    for counter in FAIL_ON:
                        gate += ["--fail-on", counter]
                    if compare.main(gate) != 0:
                        raise AssertionError(f"{label}: the metrics drift "
                                             f"from the golden")
                    print("  golden gate: every --fail-on counter within "
                          "tolerance")
            finally:
                os.chdir(here)
            check_expected(label, counts, expect)
            if name == "serve_longcontext":
                for arch, rec in out.items():
                    if rec["decoded"] != 48 or rec["tokens"].shape != (2, 56):
                        raise AssertionError(f"{label}: {arch} decoded "
                                             f"{rec['tokens'].shape}")
            # the unscreened chaos run is meant to NaN-poison; the twin
            # asserts the screened one finite
            runs = out.get("runs", {"": out})
            losses = [v for run, r in runs.items() if run != "async unscreened"
                      for v in r.get("losses", [])]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{label}: non-finite loss")
            print(f"[examples] {label}: {wall:.1f} s wall; launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
            walls.append((label, wall))
            for k in total:
                total[k] += counts[k]
    print(f"[examples] {len(walls)} runs in "
          f"{sum(w for _, w in walls):.1f} s of wall time")
    return total


def profiler_probe() -> int:
    """``--profiler-probe``: the launches that profiler sessions record as
    the process ages (ROADMAP Queue 3). ``swa_attention`` at (k)'s encoder
    shape, sessions of 10 and 50 calls without and with the pads, at the
    start and after each of 4 spells of 30 s of matrix products."""
    global PAD_LAUNCHES
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import swa_attention as swa
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[probe] card {card_line()}")
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((16, 1500, 5, 64), generator=gen).to(
        dev, torch.bfloat16).transpose(1, 2) for _ in range(3))

    def fn():
        return swa.swa_attention(q, k, v, causal=False, round_p=True)
    a = torch.randn(8192, 8192, device=dev)
    pad, t0 = PAD_LAUNCHES, time.perf_counter()
    try:
        for spell in range(5):
            got = {}
            for padded in (False, True):
                PAD_LAUNCHES = pad if padded else 0
                for iters in (10, 50):
                    got[f"{iters}{' padded' if padded else ''}"] = \
                        recorded_launches(fn, "swa_kernel", iters)
            print(f"[probe] {time.perf_counter() - t0:.1f} s in: "
                  f"swa_kernel launches recorded of a session's calls "
                  f"{got}")
            t1 = time.perf_counter()
            while spell < 4 and time.perf_counter() - t1 < 30:
                a = (a @ a).clamp_(-1, 1)
                torch.cuda.synchronize()
    finally:
        PAD_LAUNCHES = pad
    return 0


def mesh_only() -> int:
    """``--mesh``: build the kernels and drive phase 11 (the mesh) alone."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import reconstruct
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.models import paper_models as pm
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    print(f"[mesh] card {card_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t11 = time.perf_counter()
    ds = syn.make_federated_images(N_CLIENTS, EXAMPLES, (28, 28, 1), 62,
                                   alpha=1.0, seed=0)
    y0, frozen = reconstruct.init_partitioned(pm.init_emnist_cnn, 0,
                                              pm.EMNIST_FREEZE, device=dev)
    ya, za = reconstruct.init_partitioned(pm.init_emnist_cnn, 0, (),
                                          device=dev)
    print(f"[mesh] launches {drive_mesh(ds, y0, frozen, ya, za, dev)}")
    print(f"[mesh] phase 11 took {time.perf_counter() - t11:.1f} s")
    return 0


def examples_only() -> int:
    """``--examples``: build the kernels and drive phase 12 (the
    examples) alone."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    print(f"[examples] card {card_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t12 = time.perf_counter()
    print(f"[examples] launches {drive_examples(dev)}")
    print(f"[examples] phase 12 took {time.perf_counter() - t12:.1f} s")
    return 0


def other_tree(src: str, what: str) -> int:
    """``--kernel-times SRC`` / ``--dp-ftrl SRC``: build the kernels of the
    package under SRC (another tree, unpacked with ``git archive``, run in
    the same call as this one) and print :func:`ab_times`, or drive
    :func:`drive_dp_ftrl`, for it alone."""
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {src}: {time.perf_counter() - t0:.1f} s; card "
          f"{card_line()}")
    if what == "--kernel-times":
        ab_times(dev, os.path.abspath(src))
        attention_times(dev)
    else:
        drive_dp_ftrl(dev)
    return 0


def mixtral_only() -> int:
    """``--mixtral``: build the kernels and drive phase 7 (Mixtral-8x7B's
    FedPT training and serving at full width) alone, with its gates."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    print(f"[mixtral] card {card_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t7 = time.perf_counter()
    drive_mixtral_training(dev)
    drive_mixtral_serving(dev)
    print(f"[mixtral] phase 7 took {time.perf_counter() - t7:.1f} s")
    return 0


def deepseek_only() -> int:
    """``--deepseek``: build the kernels and drive phase 8 (DeepSeek-V2's
    MLA kernel check, FedPT training and serving at full width) alone,
    with its gates."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    logs = _build.build_all()
    print(f"[deepseek] card {card_line()}")
    for name, info in ptxas_summary(logs.get("swa_attention.cu", ""),
                                    "swa_kernel").items():
        print(f"  ptxas {name}: {info}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t8 = time.perf_counter()
    check_mla_kernel(dev)
    drive_deepseek_training(dev)
    drive_deepseek_serving(dev)
    print(f"[deepseek] phase 8 took {time.perf_counter() - t8:.1f} s")
    return 0


def ssm_only() -> int:
    """``--ssm``: build the kernels and drive phase 9 (xLSTM-350M's FedPT
    training and serving, Jamba-v0.1's serving, at full width) alone, with
    its gates."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    print(f"[ssm] card {card_line()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t9 = time.perf_counter()
    drive_ssm(dev)
    print(f"[ssm] phase 9 took {time.perf_counter() - t9:.1f} s")
    return 0


def vlm_encdec_only() -> int:
    """``--vlm-encdec``: build the kernels, hold and time ``swa_attention``
    at the VLM's and the encoder-decoder's shapes (phase 2's part) and
    drive phase 10 (PaliGemma-3B's and Whisper large-v3's FedPT training
    and serving at full width) alone, with its gates."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    logs = _build.build_all()
    print(f"[vlm-encdec] card {card_line()}")
    for name, info in ptxas_summary(logs.get("swa_attention.cu", ""),
                                    "swa_kernel").items():
        print(f"  ptxas {name}: {info}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t10 = time.perf_counter()
    check_vlm_encdec_kernels(dev)
    print(f"[vlm-encdec] kernel checks took {time.perf_counter() - t10:.1f} s")
    t10 = time.perf_counter()
    drive_vlm_encdec(dev)
    print(f"[vlm-encdec] phase 10 took {time.perf_counter() - t10:.1f} s")
    return 0


def sweep() -> int:
    """``--sweep``: the launch choices behind this tree's one-launch
    kernels, through their C entry points: sumsq's grid at 89,088 and
    1,695,744 (the wrapper's plan beside other grids), the cluster
    route's (CTAs, thread groups, float4s a thread) at (10 | 6, 89,088)
    beside the two-pass route and a plain copy of the buffer (each output
    checked against the plain version), the clip's cluster route's (CTAs,
    warps) at (6 | 40, 89,088) beside its three-launch route (each output
    bit for bit the three-launch entry's), max-abs' plan at (10,
    1,695,744) beside twice and half its pieces a warp (warm and cold)
    and a copy of that buffer, and at (10, 89,088) 1 to 8 pieces a warp
    (each output bit for bit the plain version), and what a wrapper's
    host steps cost. Prints one JSON line: wall (CUDA
    events) and device ms (the named kernels' mean per launch, but for
    the copy: the whole call's)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, dp_clip, quantize, ref
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    print(f"[sweep] card {card_line()}")
    lib_s = _build.load("sumsq.cu", dp_clip._SIGNATURES)
    lib_q = _build.load("quantize.cu", quantize._SIGNATURES)
    out = {}

    def rec(key, fn, device=True, names=None):
        """wall and device time of fn; the device time of the named
        kernels' mean per recorded launch where ``names`` are given (a
        trace that drops a launch does not lower it), else of the call."""
        out[key] = {"wall_ms": time_ms(fn),
                    "device_ms": device_ms(fn, names) if device else None}

    gen = torch.Generator(device="cpu").manual_seed(12)
    x = torch.randn(89_088, generator=gen).to(dev)
    rec("host: torch.cuda.current_stream().cuda_stream",
        lambda: torch.cuda.current_stream(x.device).cuda_stream, False)
    rec("host: _build.stream_ptr", lambda: _build.stream_ptr(x), False)
    rec("host: _build.check_cuda",
        lambda: _build.check_cuda("x", x, torch.float32, 1), False)
    rec("host: torch.empty(())", lambda: torch.empty(
        (), dtype=torch.float32, device=dev), False)
    rec("host: x.new_empty(())", lambda: x.new_empty(()), False)
    scratch = torch.zeros(1025, dtype=torch.int32, device=dev)
    res = torch.empty((), device=dev)
    base, stream = scratch.data_ptr(), _build.stream_ptr(x)
    for n, grids in ((89_088, (11, 22, 44, 87, 132)),
                     (1_695_744, (66, 132, 264, 414, 828))):
        v = torch.randn(n, generator=gen).to(dev)
        want = float((v.double() ** 2).sum())
        rec(f"sumsq n={n} wrapper, plan {dp_clip.sumsq_plan(n)}",
            lambda v=v: dp_clip.sumsq(v), names=AB_KERNELS["sumsq"])
        for grid in grids:
            chunk = -(-(n // 4) // grid)

            def call(v=v, grid=grid, chunk=chunk):
                return lib_s.sumsq_f32(v.data_ptr(), n, grid, chunk, base,
                                       base + 4 * 1024, res.data_ptr(),
                                       stream)
            if call() or not math.isclose(float(res), want, rel_tol=1e-5):
                raise AssertionError(f"sumsq sweep: grid {grid} at n={n}")
            rec(f"sumsq n={n} grid={grid}", call, names=AB_KERNELS["sumsq"])
    bl = torch.as_tensor(np.repeat(np.arange(8, dtype=np.int32),
                                   [1, 1, 1, 50, 1, 31, 1, 1]), device=dev)
    for rows in (CLIENTS_PER_ROUND, GOAL):
        m = (torch.randn((rows, 89_088), generator=gen) * 1e-2).to(dev)
        want = ref.fake_quantize_flat_ref(m, bl, n_leaves=8)
        y = torch.empty_like(m)
        rec(f"Q->DQ ({rows}, 89088) wrapper, split "
            f"{quantize.cluster_split(87)}",
            lambda m=m: quantize.fake_quantize_flat(m, bl, 8),
            names=AB_KERNELS["fake_quantize_flat"])

        def two_pass(m=m, y=y, rows=rows):
            mx = quantize.leaf_maxabs(m, bl, 8)
            return lib_q.fake_quantize_flat_f32(
                m.data_ptr(), bl.data_ptr(), mx.data_ptr(), rows, 89_088,
                1024, 8, 127.0, y.data_ptr(), stream)
        for label, fn in [("two-pass", two_pass)] + [
                (f"cluster ctas={c} groups={g} per_thread={p}",
                 lambda m=m, y=y, rows=rows, c=c, g=g, p=p:
                 lib_q.fake_quantize_cluster_f32(
                     m.data_ptr(), bl.data_ptr(), rows, 89_088, c, g, p, 8,
                     127.0, y.data_ptr(), stream))
                for c, g, p in ((8, 2, 8), (12, 2, 4), (16, 1, 8),
                                (16, 2, 4))]:
            y.zero_()
            if fn() or not same_bits(y, want):
                raise AssertionError(f"Q->DQ sweep: {label} ({rows} rows)")
            rec(f"Q->DQ ({rows}, 89088) {label}", fn,
                names=AB_KERNELS["fake_quantize_flat"])
        rec(f"copy ({rows}, 89088)", lambda m=m, y=y: y.copy_(m))
    # max-abs at (10, 1,695,744): the plan's grid beside 2x and 1/2x the
    # pieces a warp, one launch each through the C entry, warm and after
    # a 128 MB write (cold), each output bit for bit the plain version
    bla = torch.as_tensor(np.repeat(np.arange(10, dtype=np.int32),
                                    [1, 1, 1, 50, 1, 1568, 1, 31, 1, 1]),
                          device=dev)
    na = bla.numel() * 1024
    m = (torch.randn((CLIENTS_PER_ROUND, na), generator=gen) * 1e-2).to(dev)
    want = ref.leaf_maxabs_ref(m, bla, 10)
    mx = torch.empty((CLIENTS_PER_ROUND, 10), dtype=torch.int32, device=dev)
    grid0, pw0 = quantize.maxabs_plan(CLIENTS_PER_ROUND, na)
    pieces = CLIENTS_PER_ROUND * bla.numel()
    flush = flush_buffer(dev)
    for pw in (pw0, 2 * pw0, max(1, pw0 // 2)):
        grid = -(-pieces // (quantize.MAXABS_WARPS * pw))

        def fn(grid=grid, pw=pw):
            return lib_q.leaf_maxabs_f32(
                m.data_ptr(), bla.data_ptr(), CLIENTS_PER_ROUND, na, 1024,
                10, grid, pw, mx.data_ptr(), stream)
        if fn() or not same_bits(mx.view(torch.float32), want):
            raise AssertionError(f"max-abs sweep: grid {grid} x {pw}")
        key = (f"max-abs ({CLIENTS_PER_ROUND}, {na}) grid={grid} "
               f"per_warp={pw}" + (" (plan)" if pw == pw0 else ""))
        rec(key, fn, names=AB_KERNELS["leaf_maxabs"])
        out[key]["cold_span_ms"] = span_ms(fn, flush=flush)
        out[key]["cold_read_span_ms"] = span_ms(fn, flush=flush, read=True)
    rec(f"copy ({CLIENTS_PER_ROUND}, {na})", lambda: flush[:m.numel()]
        .view(m.shape).copy_(m))
    # and at (10, 89,088): pieces a warp
    m = (torch.randn((CLIENTS_PER_ROUND, 89_088), generator=gen)
         * 1e-2).to(dev)
    want = ref.leaf_maxabs_ref(m, bl, 8)
    mx = torch.empty((CLIENTS_PER_ROUND, 8), dtype=torch.int32, device=dev)
    pieces = CLIENTS_PER_ROUND * 87
    for pw in (1, 2, 4, 8):
        grid = -(-pieces // (quantize.MAXABS_WARPS * pw))

        def fn(grid=grid, pw=pw):
            return lib_q.leaf_maxabs_f32(
                m.data_ptr(), bl.data_ptr(), CLIENTS_PER_ROUND, 89_088, 1024,
                8, grid, pw, mx.data_ptr(), stream)
        if fn() or not same_bits(mx.view(torch.float32), want):
            raise AssertionError(f"max-abs sweep: grid {grid} x {pw}")
        key = f"max-abs ({CLIENTS_PER_ROUND}, 89088) grid={grid} " \
              f"per_warp={pw}" + (" (plan)" if pw == 1 else "")
        rec(key, fn, names=AB_KERNELS["leaf_maxabs"])
        out[key]["call_device_ms"] = device_ms(fn)
        out[key]["span_ms"] = span_ms(fn)
    lib_c = _build.load("dp_clip.cu", dp_clip._CLIP_SIGNATURES)
    for rows in (GOAL, 40):
        m = clip_rows(89_088, gen, dev, rows)
        want, wnorm = clip_three_launch(m)
        y, norms = torch.empty_like(m), torch.empty(rows, device=dev)
        rec(f"clip ({rows}, 89088) wrapper, split {dp_clip.clip_split(87)}",
            lambda m=m: dp_clip.clip_flat(m, DP_CLIP),
            names=AB_KERNELS["clip_flat"])
        rec(f"clip ({rows}, 89088) three-launch",
            lambda m=m: clip_three_launch(m), names=AB_KERNELS["clip_flat"])
        for c, w in ((16, 8), (12, 8), (11, 8), (8, 16), (6, 16), (4, 32),
                     (16, 16)):
            def fn(m=m, y=y, norms=norms, rows=rows, c=c, w=w):
                return lib_c.dp_clip_cluster_f32(
                    m.data_ptr(), rows, 89_088, c, w, DP_CLIP,
                    norms.data_ptr(), y.data_ptr(), stream)
            y.zero_()
            if fn() or not (same_bits(y, want) and same_bits(norms, wnorm)):
                raise AssertionError(f"clip sweep: ctas={c} warps={w} "
                                     f"({rows} rows)")
            rec(f"clip ({rows}, 89088) cluster ctas={c} warps={w}", fn,
                names=AB_KERNELS["clip_flat"])
    print("[sweep] " + json.dumps(out))
    return 0


def timed(what: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed on a line of its own:
    a phase's breakdown."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"[time] {what}: {time.perf_counter() - t0:.1f} s")
    return out


def phase_seconds(n: int, what: str, t0: float) -> float:
    """Print phase ``n``'s seconds since ``t0`` on a line of its own;
    returns the time now, the next phase's start."""
    now = time.perf_counter()
    print(f"[phase {n}] {what} took {now - t0:.1f} s")
    return now


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    if argv[:1] in (["--kernel-times"], ["--dp-ftrl"]) and len(argv) == 2:
        return other_tree(argv[1], argv[0])
    if argv == ["--sweep"]:
        return sweep()
    if argv == ["--mixtral"]:
        return mixtral_only()
    if argv == ["--deepseek"]:
        return deepseek_only()
    if argv == ["--ssm"]:
        return ssm_only()
    if argv == ["--vlm-encdec"]:
        return vlm_encdec_only()
    if argv == ["--mesh"]:
        return mesh_only()
    if argv == ["--examples"]:
        return examples_only()
    if argv == ["--profiler-probe"]:
        return profiler_probe()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py "
              f"[--kernel-times SRC | --dp-ftrl SRC | --sweep | --mixtral | "
              f"--deepseek | --ssm | --vlm-encdec | --mesh | --examples | "
              f"--profiler-probe]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels
    from repro_torch.core import flat as flat_lib
    from repro_torch.core import partition as part
    from repro_torch.core import reconstruct
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.models import paper_models as pm

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- phase 1: build and identify -------------------------------------
    t_run = t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} sources, {len(logs)} compiled in "
          f"{time.perf_counter() - t0:.1f} s (nvcc -gencode "
          f"arch=compute_90a,code=sm_90a)")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  {source}: {line.strip()}")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # --- the main paths' model and data ----------------------------------
    ds = syn.make_federated_images(N_CLIENTS, EXAMPLES, (28, 28, 1), 62,
                                   alpha=1.0, seed=0)
    y0, frozen = reconstruct.init_partitioned(pm.init_emnist_cnn, 0,
                                              pm.EMNIST_FREEZE, device=dev)
    n_y, n_z = part.count_params(y0), part.count_params(frozen)
    layout = flat_lib.FlatLayout.of(y0)
    print(f"[model] EMNIST CNN: {n_y + n_z} params, {n_y} trainable "
          f"({100 * n_y / (n_y + n_z):.2f}%), flat size {layout.size} in "
          f"{layout.num_blocks} blocks over {len(layout.sizes)} leaves")
    if (n_y, n_y + n_z, layout.size) != (84_030, 1_690_174, 89_088):
        raise AssertionError("EMNIST partition/layout differs from the "
                             "reference's 84,030 / 1,690,174 / 89,088")
    ya, za = reconstruct.init_partitioned(pm.init_emnist_cnn, 0, (),
                                          device=dev)
    layout_a = flat_lib.FlatLayout.of(ya)
    print(f"[model] FedAvg baseline (every parameter trainable): "
          f"{part.count_params(ya)} trainable, flat size {layout_a.size} in "
          f"{layout_a.num_blocks} blocks over {len(layout_a.sizes)} leaves")
    if (part.count_params(ya), layout_a.size) != (1_690_174, 1_695_744):
        raise AssertionError("the FedAvg layout differs from 1,690,174 / "
                             "1,695,744")
    t0 = phase_seconds(1, "build and identify", t0)

    # --- phase 2: kernels against their plain versions -------------------
    print("[kernels] against their plain versions at the main paths' shapes")
    records = (timed("check_kernels", check_kernels, layout, layout_a, dev)
               + timed("check_fused_kernels", check_fused_kernels, layout_a,
                       dev)
               + timed("check_clip_kernels", check_clip_kernels, layout,
                       layout_a, dev)
               + timed("check_serving_kernels", check_serving_kernels, dev,
                       logs))
    timed("check_tier_kernels", check_tier_kernels,
          tier_layouts(y0)[1][1:], dev)
    timed("check_mla_kernel", check_mla_kernel, dev)
    timed("check_vlm_encdec_kernels", check_vlm_encdec_kernels, dev)
    timed("check_attention_fallback", check_attention_fallback, dev)
    # the redesigned kernels' A/B timings (ab_times) and the attention
    # kernel's repeated timings (attention_times) left the default run for
    # phase 11's time: `chip_smoke.py --kernel-times src` prints them
    free_flush()
    t0 = phase_seconds(2, "kernels against their plain versions", t0)

    # --- phase 3: the main paths -----------------------------------------
    paths = [  # label, bits, dp, (y, frozen), kernels that must launch
        ("quickstart, uplink_bits=0", 0, False, (y0, frozen), ("sumsq",)),
        ("quickstart, uplink_bits=8", 8, False, (y0, frozen),
         ("sumsq", "fake_quantize_flat", "fake_quantize_flat/cluster")),
        ("FedAvg A, int8", 8, False, (ya, za),
         ("sumsq", "block_stats", "pack")),
        ("FedAvg B, int8 DP-FedAvg + screen", 8, True, (ya, za),
         ("block_stats", "pack", "apply_coeff")),
    ]
    for label, bits, dp, (ys, zs), _ in paths:
        check_against_cpu(label, bits, dp, ds, ys, zs, dev)
    launches = {name: 0 for name in {**kernels.LAUNCHES, **kernels.ROUTES}}
    draws = cohorts(ds, ROUNDS + 1)
    torch.cuda.reset_peak_memory_stats()
    for label, bits, dp, (ys, zs), expect in paths:
        counts = drive_path(label, bits, dp, ys, zs, draws, expect, dev)
        for name in launches:
            launches[name] += counts[name]
    for counts in (drive_run_federated(ds, y0, frozen, dev),
                   drive_async_dp(ds, dev)):
        for name in launches:
            launches[name] += counts.get(name, 0)
    print(f"[main path] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    tail_routes((("quickstart", layout), ("FedAvg", layout_a)), dev)
    counts = drive_serving(dev)
    for name in launches:
        launches[name] += counts.get(name, 0)
    if counts["swa_attention"] <= 0:
        raise AssertionError("swa_attention never launched on the serving "
                             "path")
    check_categorical(dev)
    t0 = phase_seconds(3, "the main paths", t0)

    # --- phase 4: the paper's ResNet-18-GN and SO transformer ------------
    bl_so, _, _ = so_lane_block_leaf("cpu")
    for path in MODEL_SHAPES:
        pt, ys, zs = timed(f"model_task {path}", model_task, path, dev)
        if path == "SO PT" and not np.array_equal(
                bl_so.numpy(), flat_lib.FlatLayout.of(ys).block_leaf()):
            raise AssertionError("so_lane_block_leaf differs from the SO "
                                 "PT layout's map")
        draws = task_draws(pt, ROUNDS + 1)
        timed(f"check_model_round {path}", check_model_round, path, pt, ys,
              zs, *draws[0], dev, clients=RESNET_CHECK_CLIENTS
              if path.startswith("ResNet") else None)
        with sumsq_seen() as seen:
            counts = timed(f"drive_model_path {path}", drive_model_path,
                           path, pt, ys, zs, draws, ("sumsq",), dev)
        check_path_sumsq(path, seen)
        if path == "SO PT":
            counts = {k: counts[k] + v for k, v in
                      timed("drive_so_async", drive_so_async, pt,
                            dev).items()}
        for name in launches:
            launches[name] += counts[name]
        del pt, ys, zs
    counts = timed("drive_dp_ftrl", drive_dp_ftrl, dev)
    for name in launches:
        launches[name] += counts[name]
    t0 = phase_seconds(4, "ResNet-18-GN and the SO transformer", t0)

    # --- phase 5: trainability tiers on the EMNIST CNN -------------------
    for counts in (drive_tiered_async(ds, dev, dp=False),
                   drive_tiered_async(ds, dev, dp=True),
                   drive_sync_tiers(ds, ya, za, dev),
                   drive_adaptive_tiers(ds, dev)):
        for name in launches:
            launches[name] += counts[name]
    t0 = phase_seconds(5, "trainability tiers", t0)

    # --- phase 6: checkpoint / resume and the edge topology -------------
    counts = drive_resume_topology(ds, dev)
    for name in launches:
        launches[name] += counts[name]
    t0 = phase_seconds(6, "checkpoint / resume and the edge topology", t0)

    # --- phase 7: Mixtral-8x7B, FedPT fine-tuning and serving ------------
    for leg in (drive_mixtral_training, drive_mixtral_serving):
        t1 = time.perf_counter()
        for name, n in leg(dev).items():
            launches[name] += n
        print(f"[mixtral] {leg.__name__} took "
              f"{time.perf_counter() - t1:.1f} s")
    t0 = phase_seconds(7, "Mixtral-8x7B", t0)

    # --- phase 8: DeepSeek-V2 (MLA), FedPT fine-tuning and serving -------
    for leg in (drive_deepseek_training, drive_deepseek_serving):
        t1 = time.perf_counter()
        for name, n in leg(dev).items():
            launches[name] += n
        print(f"[deepseek] {leg.__name__} took "
              f"{time.perf_counter() - t1:.1f} s")
    t0 = phase_seconds(8, "DeepSeek-V2", t0)

    # --- phase 9: the SSM families: xLSTM-350M and Jamba-v0.1 ------------
    for name, n in drive_ssm(dev).items():
        launches[name] += n
    t0 = phase_seconds(9, "the SSM families", t0)

    # --- phase 10: the VLM and the encoder-decoder ----------------------
    for name, n in drive_vlm_encdec(dev).items():
        launches[name] += n
    t0 = phase_seconds(10, "the VLM and the encoder-decoder", t0)

    # --- phase 11: the mesh ----------------------------------------------
    for name, n in drive_mesh(ds, y0, frozen, ya, za, dev).items():
        launches[name] += n
    t0 = phase_seconds(11, "the mesh", t0)

    # --- phase 12: the examples ------------------------------------------
    for name, n in drive_examples(dev).items():
        launches[name] += n
    t0 = phase_seconds(12, "the examples", t0)

    # --- phase 13: summary -----------------------------------------------
    if len(records) != 10:
        raise AssertionError(f"{len(records)} kernel records, not 10")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["launches"] <= 0 and rec["name"] not in NO_ENGINE:
            raise AssertionError(f"kernel {rec['name']} never launched on "
                                 f"a main path")
    print(f"[main path] launches by route: "
          f"{ {k: v for k, v in launches.items() if '/' in k} }")
    print(f"[phase 13] the script took {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
