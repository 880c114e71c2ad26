#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX nor of the JAX
package. Phases, in order, each failing the run on error:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and identify the card;
2. hold every kernel against its plain torch version on the card at the
   main path's shapes — the EMNIST round's (10, 89,088) delta buffer
   with its 8-leaf block map — plus a ragged layout and the edge cases
   (an all-zero leaf, a NaN and an Inf in one row): max-abs and Q->DQ
   bit for bit, sumsq within rtol 1e-5 of a float64 sum; then time
   each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function;
3. drive the main path: the quickstart's synchronous FedPT round on the
   full-width EMNIST CNN (init from seed 0 through the threefry port,
   ``EMNIST_FREEZE``), 10 rounds of 10 clients x 2 local SGD steps x
   batch 16, once with ``uplink_bits=0`` and once with 8; check finite
   losses that fall, that every kernel of each path was launched, and
   that the first round agrees with the same round run on the CPU
   through the plain versions; time every round, and profile one more
   (device-busy share, host ops by self time);
4. print the ``kernels`` JSON line, the card's name and power limit,
   and, last, the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_CLIENTS, EXAMPLES, CLIENTS_PER_ROUND, LOCAL_STEPS, LOCAL_BATCH = 40, 50, 10, 2, 16
ROUNDS = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal NaN positions, and identical float32 bits everywhere else."""
    a, b = a.float().cpu(), b.float().cpu()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if a.shape != b.shape or not torch.equal(nan_a, nan_b):
        return False
    return torch.equal(a[~nan_a].view(torch.int32), b[~nan_b].view(torch.int32))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def time_ms(fn, iters: int = 200) -> float:
    """Mean time per call over back-to-back calls, by CUDA events."""
    for _ in range(5):
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


def device_ms(fn, kernel_names, iters: int = 50):
    """Mean device time (ms) per call of the named CUDA kernels, from the
    profiler; None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(k in ev.key for k in kernel_names):
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / 1e3 / iters if total > 0 else None


def bound(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def emnist_loss(params, batch):
    from repro_torch.models import paper_models as pm
    logits = pm.emnist_cnn_forward(params, batch["images"])
    lp = torch.log_softmax(logits, -1)
    return -lp.gather(1, batch["labels"].long()[:, None]).mean(), {}


def check_kernels(layout, dev):
    """Phase 2: every kernel against its plain version; returns the
    per-kernel records (all keys but ``launches``)."""
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
    if not torch.isnan(quantize.fake_quantize_flat(edge, bl, L)[3]).any():
        raise AssertionError("the NaN row lost its NaN")
    if quantize.fake_quantize_flat(edge, bl, L)[0, z0:z1].abs().max() != 0:
        raise AssertionError("the all-zero leaf did not stay zero")

    vec = mat[0].contiguous()
    for name, v in (("main", vec),
                    ("ragged", torch.randn(N + 77, generator=gen).to(dev))):
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

    records = []
    # (name, source, replaces, kernel call, plain call, library call,
    #  kernel names for the profiler, bytes, ops)
    nb = bl.size
    specs = [
        ("sumsq", "src/repro_torch/kernels/csrc/sumsq.cu",
         "src/repro/kernels/dp_clip.py:25",
         lambda: dp_clip.sumsq(vec), lambda: ref.flat_sumsq_ref(vec),
         lambda: torch.dot(vec, vec),
         ("sumsq_partials_kernel", "sum_partials_kernel"),
         N * 4 + 4, 2 * N),
        ("leaf_maxabs", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:35",
         lambda: quantize.leaf_maxabs(mat, bl_dev, L),
         lambda: ref.leaf_maxabs_ref(mat, bl_dev, L), None,
         ("leaf_maxabs_kernel",),
         K * N * 4 + nb * 4 + K * L * 4, 2 * K * N),
        ("fake_quantize_flat", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:52",
         lambda: quantize.fake_quantize_flat(mat, bl_dev, L),
         lambda: ref.fake_quantize_flat_ref(mat, bl_dev, n_leaves=L), None,
         ("leaf_maxabs_kernel", "qdq_kernel"),
         2 * K * N * 4 + nb * 4, 5 * K * N),
    ]
    for (name, source, replaces, kern, plain, lib, knames, nbytes,
         nops) in specs:
        err = max_abs_diff(kern(), plain())
        bound_ms, bound_by = bound(nbytes, nops)
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib) if lib is not None else None,
            "device_ms": device_ms(kern, knames),
        })
    return records


def make_round(bits, dev):
    """The quickstart's round: 10 clients x 2 local SGD steps x batch 16,
    client lr 0.05, server SGD lr 0.5, at ``uplink_bits``."""
    from repro_torch.core import fedpt
    rc = fedpt.RoundConfig(clients_per_round=CLIENTS_PER_ROUND,
                           local_steps=LOCAL_STEPS, local_batch=LOCAL_BATCH,
                           client_opt="sgd", client_lr=0.05,
                           server_opt="sgd", server_lr=0.5, uplink_bits=bits)
    return fedpt.make_round_fn(emnist_loss, rc, device=dev)


def cohorts(ds, n):
    """The quickstart's first n (batch, weights) draws, from seed 0."""
    from repro_torch.data import synthetic as syn
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        cids = syn.sample_cohort(rng, ds.num_clients, CLIENTS_PER_ROUND)
        out.append(syn.cohort_batch(ds, cids, LOCAL_STEPS, LOCAL_BATCH, rng))
    return out


def profile_round(step):
    """One round under the profiler: wall ms, device-busy ms (the sum of
    the kernels' device time; one stream, so they do not overlap),
    kernel launches, and the host ops with the most self time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels_run = 0.0, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            busy += dev_us / 1e3
            kernels_run += ev.count
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top = [(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count)
           for e in host[:6]]
    return wall, busy, kernels_run, top


def check_against_cpu(bits, ds, y0, frozen, dev):
    """One round on the card against the same round on the CPU through
    the plain versions, from the same start and batch."""
    from repro_torch.bridge import from_numpy_tree, to_numpy_tree
    from repro_torch.nn.basic import flatten_params
    batch, w = cohorts(ds, 1)[0]
    out = {}
    for d, y, z in ((dev, y0, frozen),
                    ("cpu", from_numpy_tree(to_numpy_tree(y0), "cpu"),
                     from_numpy_tree(to_numpy_tree(frozen), "cpu"))):
        round_fn, sopt = make_round(bits, d)
        y1, _, m = round_fn(y, sopt.init(y), z, batch, w)
        out[str(torch.device(d).type)] = (
            float(m["loss"]), float(m["delta_norm"]),
            {k: v.cpu() - y0k.cpu() for (k, v), (_, y0k) in zip(
                flatten_params(y1), flatten_params(y))})
    (lg, ng, dg), (lc, nc, dc) = out["cuda"], out["cpu"]
    worst = max(float((dg[k] - dc[k]).abs().max()) for k in dg)
    step = max(float(v.abs().max()) for v in dc.values())
    # bits 0: float reassociation only (cuDNN's and the CPU's convolution
    # orders, TF32 off), measured at ~1e-3 of max|dy| on an H100, so 1e-2;
    # bits 8: besides, a client value on a rounding boundary may flip by
    # one quantization step, which the weighted mean and server_lr shrink
    # to well under max|dy| / 127 at 10 clients; allow two such steps
    tol = (1e-2 * step if bits == 0 else 2 * step / 127) + 1e-7
    ok = (abs(lg - lc) <= 1e-4 * abs(lc)
          and abs(ng - nc) <= (1e-3 if bits == 0 else 1e-2) * nc
          and worst <= tol)
    print(f"  bits={bits} round 0, card vs CPU: loss {lg:.7f} / {lc:.7f}, "
          f"delta_norm {ng:.7f} / {nc:.7f}, max |dy| diff {worst:.3e} "
          f"(tol {tol:.3e})")
    if not ok:
        raise AssertionError(f"bits={bits}: the card's round disagrees with "
                             f"the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels
    from repro_torch.core import flat as flat_lib
    from repro_torch.core import partition as part
    from repro_torch.core import reconstruct
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.models import paper_models as pm
    from repro_torch.nn.basic import tree_leaves

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- phase 1: build and identify -------------------------------------
    t0 = time.perf_counter()
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

    # --- the main path's model and data ---------------------------------
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

    # --- phase 2: kernels against their plain versions -------------------
    print("[kernels] against their plain versions at the main path's shapes")
    records = check_kernels(layout, dev)

    # --- phase 3: the main path ------------------------------------------
    for bits in (0, 8):
        check_against_cpu(bits, ds, y0, frozen, dev)
    launches = {name: 0 for name in kernels.LAUNCHES}
    expect = {0: ("sumsq",), 8: ("sumsq", "leaf_maxabs", "fake_quantize_flat")}
    draws = cohorts(ds, ROUNDS + 1)
    torch.cuda.reset_peak_memory_stats()
    for bits in (0, 8):
        round_fn, server_opt = make_round(bits, dev)
        y, sstate = y0, server_opt.init(y0)
        losses, norms, ms = [], [], []
        kernels.reset_launches()
        for batch, w in draws[:ROUNDS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, sstate, m = round_fn(y, sstate, frozen, batch, w)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["delta_norm"]))
        counts = dict(kernels.LAUNCHES)
        print(f"[main path] uplink_bits={bits}: losses "
              f"{[round(v, 4) for v in losses]}")
        print(f"  delta_norm {[round(v, 5) for v in norms]}")
        print(f"  per-round wall ms {[round(v, 3) for v in ms]} (median "
              f"{float(np.median(ms)):.3f}, first round included in the "
              f"list); launches {counts}")
        if not all(math.isfinite(v) for v in losses + norms):
            raise AssertionError(f"bits={bits}: non-finite loss or norm")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"bits={bits}: loss did not fall")
        if not all(torch.isfinite(leaf).all() for leaf in tree_leaves(y)):
            raise AssertionError(f"bits={bits}: non-finite parameters")
        for name in expect[bits]:
            if counts[name] <= 0:
                raise AssertionError(f"bits={bits}: kernel {name} was not "
                                     f"launched on its path")
        for name in launches:
            launches[name] += counts[name]
        # one more round, under the profiler (its launches are not counted)
        wall, busy, n_kernels, top = profile_round(
            lambda: round_fn(y, sstate, frozen, *draws[ROUNDS]))
        print(f"  profiled round: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}%), {n_kernels} device ops; "
              f"host ops by self time (name, ms, calls): {top}")
    print(f"[main path] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # --- phase 4: summary ------------------------------------------------
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
