"""Multi-pod dry run, port of ``repro/launch/dryrun.py``.

Traces one step of every (architecture x input-shape) pair against the
production mesh, (16, 16) single-pod and (2, 16, 16) multi-pod, in a
*fake* world: ``init_process_group("fake", ...)`` at the mesh's size
(this process plays rank 0; collectives return without moving data),
``FakeTensorMode`` (no memory is allocated, no kernel runs), and every
argument a DTensor placed by ``launch/specs.build_job``. The step runs on
the CPU's plain paths, as the reference lowers on CPU host devices; the
train step's loss takes the plain ``chunked_attention``.

A fake world is process-wide, so the dry run owns its process, as the
reference forces its host device count before JAX starts.

Each result carries the reference's keys that torch can produce, per
rank:

* ``memory``: ``argument_bytes`` and ``output_bytes`` (the local pieces of
  the step's arguments and results), ``peak_bytes`` (the most bytes of
  live storage at any op, arguments included, from a dispatch mode that
  follows each fake storage until its last tensor dies), and what holds
  it: ``near_peak_bytes``, the live bytes kept within 1% of the peak,
  and ``near_peak_top``, the largest groups of those storages by the op
  that made them, dtype and shape;
* ``cost.flops`` from ``torch.utils.flop_counter.FlopCounterMode``;
* ``collectives``: count and result bytes by kind, from a dispatch mode
  over the ``_c10d_functional`` ops (DTensor redistributes, the flat
  plane's explicit collectives, the tensor-parallel sums and the 2-D
  experts' exchange over "data", all-to-alls);
* ``clients``, ``status`` and, for a skipped pair, ``reason``
  (``specs.skip_reason``);
* ``layout``: the layout the traced step ran in (``specs.build_job``'s).
  ``specs.TP_LAYOUT`` for the tensor-parallel train steps and prefills
  (every family: GQA or MLA attention, the VLM's prefix, the encoder and
  cross-attention, Mamba, the mLSTM and the sLSTM, dense or MoE FFNs,
  DeepSeek-V2's 2-D experts included): every rank computes on its pieces
  of the parameters, placed by the reference's rules, so the per-rank
  argument bytes are the rule sum (``rule_argument_bytes``, also in
  ``memory``). ``specs.GATHERED_LAYOUT`` for the rest (an MoE in the
  ``2d_swapped`` mode, and every decode): the step runs
  data-parallel with the parameters gathered whole on every rank; only
  the flat aggregation plane is sharded, so its per-rank bytes and
  collectives are not comparable to the reference's dry run.

Left out, as torch cannot produce them: XLA's ``transcendentals`` and
``bytes accessed`` costs, ``temp_bytes``, and the collectives'
``in_loop_bytes`` (no while-loop bodies: the step is traced unrolled),
and the compile time (nothing is compiled; ``trace_s`` is the trace's).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--timeout S]
  PYTHONPATH=<tree>/src python src/repro_torch/launch/dryrun.py \\
      --arch jamba-v0.1-52b --shape train_4k --layers 8

``--layers N`` traces the first N of each config's layers (one period of
the SSM families' layer programs, whose full depth steps 28 Mamba or 6
sLSTM loops a position at a time), and of an encoder-decoder's encoder
layers as many (N + N); a pair the config skips stays skipped. Run as a
file with another tree's ``src`` on ``PYTHONPATH`` (a
parent unpacked by ``git archive``), this ``main`` traces that tree's
package.

``--timeout S`` stops a pair's trace after S seconds (status ``error``,
``TimeoutError``): the SSM families' 32,768-position prefills trace a
position at a time and would hold the matrix for hours.
"""
from __future__ import annotations

import argparse
import json
import math
import signal
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, get_config, load_all
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.nn import basic

# _c10d_functional op name -> the reference's collective kind
KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"exists; the dry run needs {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def fake_mesh(shape, axes):
    """A mesh of ``shape`` over a fake world of its size (made here)."""
    fake_world(math.prod(shape))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(tree) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class LiveBytes(TorchDispatchMode):
    """The bytes of live storage: each op's outputs are followed until the
    last tensor on their storage dies; ``peak`` is the most at any op.
    The live storages are kept (``at_peak``) each time the total passes
    the last kept total by PEAK_STEP, so the kept set is within that
    share of the peak; :meth:`peak_top` groups it."""

    PEAK_STEP = 1.01

    def __init__(self):
        super().__init__()
        self.live = {}
        self.now = self.peak = 0
        self.at_peak, self.at_peak_bytes = {}, 0

    def track(self, t, op="argument") -> None:
        if not isinstance(t, torch.Tensor):
            return
        t = _local(t)
        st = t.untyped_storage()
        key = st._cdata
        rec = self.live.get(key)
        if rec is None:
            rec = self.live[key] = [st.nbytes(), 0,
                                    (op, t.dtype, tuple(t.shape))]
            self.now += rec[0]
            self.peak = max(self.peak, self.now)
            if self.now > self.at_peak_bytes * self.PEAK_STEP:
                self.at_peak, self.at_peak_bytes = dict(self.live), self.now
        rec[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        rec = self.live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            del self.live[key]
            self.now -= rec[0]

    def peak_top(self, n: int = 10):
        """The storages live near the peak, grouped by the op that made
        them, their dtype and shape, the n largest groups first:
        [label, bytes, count]."""
        groups = {}
        for nbytes, _, (op, dtype, shape) in self.at_peak.values():
            label = f"{op} {str(dtype).replace('torch.', '')} {list(shape)}"
            g = groups.setdefault(label, [label, 0, 0])
            g[1] += nbytes
            g[2] += 1
        return sorted(groups.values(), key=lambda g: -g[1])[:n]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            self.track(t, func)
        return out


class Collectives(TorchDispatchMode):
    """Count and result bytes of each ``_c10d_functional`` collective."""

    def __init__(self):
        super().__init__()
        self.stats = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            kind = KINDS.get(func._opname)
            if kind is not None:
                rec = self.stats.setdefault(kind, {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += _nbytes(out)
        return out


def _fake_args(args, shardings, mesh):
    """Meta structures -> fake DTensors of their placements (non-tensor
    leaves as they are); call inside ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor

    def one(struct, pl):
        if not isinstance(struct, torch.Tensor):
            return struct
        shape = tuple(struct.shape)
        local = [b - a for a, b in (shard_lib.local_range(n, mesh, pl, d)
                                    for d, n in enumerate(shape))]
        t = torch.empty(local, dtype=struct.dtype)
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    return tuple(basic.tree_map(one, a, s) for a, s in zip(args, shardings))


def rule_argument_bytes(job, mesh) -> int:
    """The per-rank bytes of the job's arguments by its placements: each
    leaf's bytes over the product of the sizes of the mesh axes that shard
    it (every rule divides its dim)."""
    sizes = mesh_lib.mesh_shape(mesh)
    total = 0
    for arg, pl_tree in zip(job.args, job.in_shardings):
        structs = dict(basic.flatten_params(arg)) if isinstance(arg, dict) \
            else {"": arg}
        pls = dict(basic.flatten_params(pl_tree)) if isinstance(arg, dict) \
            else {"": pl_tree}
        for path, t in structs.items():
            if not isinstance(t, torch.Tensor):
                continue
            split = math.prod(n for n, p in zip(sizes, pls[path])
                              if p.is_shard())
            total += t.numel() * t.element_size() // split
    return total


def run_one(arch: str, shape: str, multi_pod: bool = False, mesh=None,
            verbose: bool = True, cfg_override=None):
    reason = specs_lib.skip_reason(arch, shape)
    if reason and cfg_override is None:
        return {"arch": arch, "shape": shape, "status": "skip",
                "reason": reason}
    if mesh is None:
        name = "production-multipod" if multi_pod else "production"
        mesh = fake_mesh(*mesh_lib.PRESETS[name])
    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        job = specs_lib.build_job(arch, shape, mesh, cfg_override=cfg_override)
        live, colls = LiveBytes(), Collectives()
        flops = FlopCounterMode(display=False)
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = _fake_args(job.args, job.in_shardings, mesh)
            with mesh_lib.use_mesh(mesh), flops, colls, live:
                for t in tree_leaves(args):
                    live.track(t)
                out = job.fn(*args)
                out_bytes = _nbytes(out)
                peak = live.peak
        res = {
            "arch": arch, "shape": shape, "status": "ok",
            "mesh": list(mesh_lib.mesh_shape(mesh)),
            "trace_s": round(time.time() - t0, 1),
            "memory": {"argument_bytes": _nbytes(args),
                       "rule_argument_bytes": rule_argument_bytes(job, mesh),
                       "output_bytes": out_bytes, "peak_bytes": peak,
                       "near_peak_bytes": live.at_peak_bytes,
                       "near_peak_top": live.peak_top()},
            "cost": {"flops": flops.get_total_flops()},
            "collectives": colls.stats,
            "clients": job.clients,
            "layout": job.layout,
        }
        if verbose:
            print(f"[ok] {arch} x {shape} mesh={res['mesh']} "
                  f"trace={res['trace_s']}s flops={res['cost']['flops']} "
                  f"peak={peak} layout: {job.layout}")
        return res
    except Exception as e:  # noqa: BLE001 — report, don't crash the matrix
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "elapsed_s": round(time.time() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="seconds a pair may trace (0: no limit)")
    ap.add_argument("--layers", type=int, default=0,
                    help="trace the first N of the config's layers (0: all)")
    args = ap.parse_args(argv)

    load_all()
    name = "production-multipod" if args.multi_pod else "production"
    mesh = fake_mesh(*mesh_lib.PRESETS[name])
    print(f"mesh: {mesh_lib.axis_sizes(mesh)} in a fake world of "
          f"{dist.get_world_size()} ranks")

    def timed_out(*_):
        raise TimeoutError(f"traced past --timeout {args.timeout:g} s")
    signal.signal(signal.SIGALRM, timed_out)

    def one(arch, shape):
        # the alarm repeats each second past the limit: a TimeoutError
        # raised inside a weakref finalizer (the live-bytes mode's) is
        # printed and dropped by Python, and the next one lands
        t0 = time.time()
        signal.setitimer(signal.ITIMER_REAL, args.timeout,
                         1.0 if args.timeout else 0.0)
        cut = None
        if args.layers and not specs_lib.skip_reason(arch, shape):
            base = get_config(arch)
            cut = base.with_(num_layers=args.layers, encoder_layers=min(
                base.encoder_layers, args.layers))
        try:
            res = run_one(arch, shape, mesh=mesh, cfg_override=cut)
            if cut is not None:
                res["layers"] = args.layers
            return res
        except TimeoutError as e:
            return {"arch": arch, "shape": shape, "status": "error",
                    "error": f"TimeoutError: {e}",
                    "elapsed_s": round(time.time() - t0, 1)}
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)

    results = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in specs_lib.SHAPES:
                results.append(one(arch, shape))
    else:
        get_config(args.arch)
        results.append(one(args.arch, args.shape))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    bad = [r for r in results if r["status"] == "error"]
    print(f"{len(results)} jobs: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skip' for r in results)} skip, "
          f"{len(bad)} error")
    print(json.dumps(results[-1]))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
