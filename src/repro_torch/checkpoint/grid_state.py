"""Mid-run snapshot / resume of the grid's full execution state, port of
``repro/checkpoint/grid_state.py``.

``checkpoint.checkpoint`` stores a *model* (trainable tree + seed +
server optimizer state) — enough to warm-start a new run, not to continue
an interrupted one. This module snapshots everything an interrupted
``sim/grid.py`` run needs to pick up exactly where it died:

* the server model ``y`` and server-optimizer state,
* the async event heap (every in-flight client, with its computed delta),
  the carry-over buffer, the virtual clock and the insertion counter,
* the data / device / dynamics / fault RNG stream positions
  (``numpy.random.Generator.bit_generator.state`` round-trips exactly
  through JSON — Python ints are arbitrary precision),
* the FlushAccountant's RDP composition ledger,
* the selection policy's mutable state,
* the metrics registry (so end-of-run wire billing, which reads the
  scheduler counters, is exact),
* the topology's meta and the region-shock process,
* the history records so far.

Snapshots are only taken at *flush boundaries* (async) or *round
boundaries* (sync): the one points where no lane work is pending, so
every in-flight completion event holds a resolved tensor. Packing copies
the tensors to the host (one synchronization a snapshot); unpacking puts
them back on the run's device.

The format is the reference's, key for key: one ``.npz`` holding the
arrays (``y/<path>``, ``s/<i>``, ``ev<i>/delta|loss``,
``buf<i>/delta|loss``) plus a single JSON blob under ``__grid_meta__``
(``grid_state_version`` 1), so a snapshot written by either package
resumes in the other. Model checkpoints (``__meta__`` key) are rejected
with a pointer to ``checkpoint.load``.
"""
from __future__ import annotations

import glob
import heapq
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.sim import scheduler as sched_lib

GRID_STATE_VERSION = 1
META_KEY = "__grid_meta__"


# ---------------------------------------------------------------------------
# low-level helpers


def rng_state(gen: np.random.Generator) -> Dict[str, Any]:
    """A Generator's exact stream position (JSON-serializable: the PCG64
    state ints are Python ints, which json keeps at full precision)."""
    return gen.bit_generator.state


def set_rng_state(gen: np.random.Generator, state: Dict[str, Any]) -> None:
    gen.bit_generator.state = state


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def checkpoint_path(directory: str, applied: int, mode: str) -> str:
    """Canonical snapshot filename: zero-padded so lexical sort ==
    chronological sort (what :func:`latest` relies on)."""
    return os.path.join(directory, f"grid_{mode}_{applied:06d}.npz")


def latest(directory: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(directory, "grid_*.npz")))
    return paths[-1] if paths else None


def save_state(path: str, meta: Dict[str, Any],
               arrays: Dict[str, np.ndarray]) -> str:
    path = ckpt_lib.with_suffix(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{META_KEY: json.dumps(meta, default=_json_default)},
             **arrays)
    return path


def load_state(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(meta, arrays) of a grid-state snapshot; raises on model
    checkpoints and on version mismatch."""
    with np.load(ckpt_lib.with_suffix(path), allow_pickle=False) as z:
        if META_KEY not in z.files:
            raise ValueError(
                f"{path!r} is not a grid-state checkpoint (no "
                f"{META_KEY!r} entry) — model checkpoints load via "
                "repro_torch.checkpoint.checkpoint.load")
        meta = json.loads(str(z[META_KEY]))
        arrays = {k: z[k] for k in z.files if k != META_KEY}
    v = meta.get("grid_state_version")
    if v != GRID_STATE_VERSION:
        raise ValueError(f"grid-state version {v!r} is not supported "
                         f"(this build reads {GRID_STATE_VERSION})")
    return meta, arrays


def pack_tree(prefix: str, tree) -> Dict[str, np.ndarray]:
    return ckpt_lib.tree_arrays(prefix, tree)


def unpack_tree(prefix: str, arrays: Dict[str, np.ndarray],
                dev: torch.device):
    return ckpt_lib.arrays_tree(prefix, arrays, dev)


def pack_leaves(prefix: str, tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}/{i}": ckpt_lib.leaf_to_numpy(l)
            for i, l in enumerate(ckpt_lib.state_leaves(tree))}


def unpack_leaves(prefix: str, arrays: Dict[str, np.ndarray], template,
                  dev: torch.device):
    n = len(ckpt_lib.state_leaves(template))
    return ckpt_lib.state_from_leaves(
        template, [arrays[f"{prefix}/{i}"] for i in range(n)], dev)


# ---------------------------------------------------------------------------
# async snapshots


def _work_meta(work: Dict[str, Any]) -> Dict[str, Any]:
    m = {"weight": float(work["weight"]),
         "up_bytes": int(work["up_bytes"]),
         "cid": int(work["cid"]),
         "tier": None if work.get("tier") is None else int(work["tier"]),
         "lane": "cell" in work}
    if "fault" in work:
        m["fault"] = work["fault"]
    return m


def _work_arrays(work: Dict[str, Any]):
    """The concrete (delta, loss) of a completed client — snapshots only
    happen at flush boundaries, where every lane cell is resolved."""
    cell = work.get("cell")
    if cell is not None:
        delta, loss = cell.resolve()
        if delta is None:
            raise RuntimeError("unresolved lane cell at snapshot time — "
                               "snapshots must be taken at flush "
                               "boundaries only")
    else:
        delta, loss = work["delta"], work["loss"]
    return ckpt_lib.leaf_to_numpy(delta), ckpt_lib.leaf_to_numpy(loss)


def _restore_work(wm: Dict[str, Any], delta, loss, make_cell,
                  dev: torch.device) -> Dict[str, Any]:
    work = {"weight": wm["weight"], "up_bytes": wm["up_bytes"],
            "cid": wm["cid"], "tier": wm["tier"]}
    if wm["lane"]:
        if make_cell is None:
            raise ValueError("snapshot was taken with client lanes "
                             "(GridConfig.lanes > 0); resume with lanes "
                             "enabled too")
        cell = make_cell()
        cell.delta = ckpt_lib.to_device(delta, dev)
        cell.loss = ckpt_lib.to_device(loss, dev)
        work["cell"] = cell
    else:
        work["delta"] = ckpt_lib.to_device(delta, dev)
        work["loss"] = ckpt_lib.to_device(loss, dev)
    if "fault" in wm:
        work["fault"] = wm["fault"]
    return work


def _topology_meta(topo) -> Optional[Dict[str, int]]:
    return (None if topo is None
            else {"regions": int(topo.num_regions),
                  "clients": int(topo.num_clients)})


def _check_topology(meta: Dict[str, Any], topo, shocks) -> None:
    """A snapshot taken under a topology / shock model must resume under
    the same one: the region counters, hop ledger and shock RNG stream
    in the snapshot are meaningless otherwise."""
    tm = meta.get("topology")
    if (tm is not None) != (topo is not None) or (
            tm is not None and tm["regions"] != int(topo.num_regions)):
        raise ValueError(
            f"checkpointed topology {tm!r} does not match this run's "
            "GridConfig.topology — resume with the same region layout")
    if (meta.get("shocks") is not None) != (shocks is not None):
        raise ValueError(
            "checkpointed shock state does not match this run's "
            "DynamicsConfig.shocks — resume with the same shock model")
    if shocks is not None:
        shocks.load_state(meta["shocks"])


def encode_async(*, state: Dict[str, Any], sched, rngs, accountant,
                 policy, registry, shocks=None,
                 topo=None) -> Tuple[Dict[str, Any],
                                     Dict[str, np.ndarray]]:
    """Snapshot a BufferedAsyncScheduler run at a flush boundary.

    ``rngs`` maps stream names to the run's live Generators (data /
    device / dynamics / faults); the same names must be passed to
    :func:`decode_async`. The event heap is saved in raw list order and
    re-heapified on restore — the total (time, seq) order makes the pop
    sequence identical either way.
    """
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(pack_tree("y", state["y"]))
    arrays.update(pack_leaves("s", state["sstate"]))
    events: List[Dict[str, Any]] = []
    for i, ev in enumerate(sched.q._heap):
        em: Dict[str, Any] = {"time": float(ev.time), "seq": int(ev.seq),
                              "kind": ev.kind}
        if ev.kind == "complete":
            em.update(cid=int(ev.payload["cid"]),
                      version=int(ev.payload["version"]),
                      tier=ev.payload.get("tier"),
                      rtt=float(ev.payload["rtt"]),
                      work=_work_meta(ev.payload["work"]))
            d, l = _work_arrays(ev.payload["work"])
            arrays[f"ev{i}/delta"] = d
            arrays[f"ev{i}/loss"] = l
        elif ev.kind == "failed":
            em.update(cid=int(ev.payload["cid"]),
                      tier=ev.payload.get("tier"),
                      cause=ev.payload.get("cause"))
        events.append(em)
    buffer: List[Dict[str, Any]] = []
    for i, e in enumerate(sched.buffer):
        buffer.append({"weight": float(e.weight),
                       "staleness": int(e.staleness),
                       "work": _work_meta(e.work)})
        d, l = _work_arrays(e.work)
        arrays[f"buf{i}/delta"] = d
        arrays[f"buf{i}/loss"] = l
    meta = {
        "grid_state_version": GRID_STATE_VERSION,
        "mode": "async",
        "applied": int(state["applied"]),
        "version": int(sched.version),
        "now": float(sched.q.now),
        "next_seq": int(sched.q._next_seq),
        "consecutive_retries": int(sched._consecutive_retries),
        "dark_since": sched._dark_since,
        "events": events,
        "buffer": buffer,
        "history": sched.records,
        "rng": {name: rng_state(g) for name, g in rngs.items()},
        "accountant": (accountant.state_dict()
                       if accountant is not None else None),
        "policy": policy.state_dict(),
        "metrics": registry.state_dict(),
        "topology": _topology_meta(topo),
        "shocks": shocks.state_dict() if shocks is not None else None,
    }
    return meta, arrays


def decode_async(meta: Dict[str, Any], arrays: Dict[str, np.ndarray], *,
                 state: Dict[str, Any], sched, sstate_template, rngs,
                 accountant, policy, registry, dev: torch.device,
                 shocks=None, topo=None,
                 make_cell=None) -> List[Dict[str, Any]]:
    """Restore a snapshot into a freshly-constructed scheduler + state
    dict on ``dev``, before ``sched.run`` is called. Returns the restored
    history (``sched.records`` — run() appends to it until
    ``num_updates``)."""
    if meta["mode"] != "async":
        raise ValueError(f"cannot resume a {meta['mode']!r} snapshot in "
                         "async mode — GridConfig.mode must match")
    if (meta["accountant"] is not None) != (accountant is not None):
        raise ValueError("checkpointed DP state does not match this "
                         "run's dp_* settings — resume with the same "
                         "RoundConfig DP configuration")
    _check_topology(meta, topo, shocks)
    state["y"] = unpack_tree("y", arrays, dev)
    state["sstate"] = unpack_leaves("s", arrays, sstate_template, dev)
    state["applied"] = int(meta["applied"])
    sched.version = int(meta["version"])
    q = sched_lib.EventQueue()
    q.now = float(meta["now"])
    q._next_seq = int(meta["next_seq"])
    heap = []
    for i, em in enumerate(meta["events"]):
        payload: Dict[str, Any] = {}
        if em["kind"] == "complete":
            payload = {"cid": em["cid"], "version": em["version"],
                       "tier": em["tier"], "rtt": em["rtt"],
                       "work": _restore_work(em["work"],
                                             arrays[f"ev{i}/delta"],
                                             arrays[f"ev{i}/loss"],
                                             make_cell, dev)}
        elif em["kind"] == "failed":
            payload = {"cid": em["cid"], "tier": em["tier"]}
            if em.get("cause") is not None:
                payload["cause"] = em["cause"]
        heap.append(sched_lib.Event(time=em["time"], seq=em["seq"],
                                    kind=em["kind"], payload=payload))
    heapq.heapify(heap)
    q._heap = heap
    sched.q = q
    sched.buffer = [
        sched_lib.BufferEntry(
            work=_restore_work(bm["work"], arrays[f"buf{i}/delta"],
                               arrays[f"buf{i}/loss"], make_cell, dev),
            weight=float(bm["weight"]), staleness=int(bm["staleness"]))
        for i, bm in enumerate(meta["buffer"])]
    sched.records = list(meta["history"])
    sched._consecutive_retries = int(meta["consecutive_retries"])
    sched._dark_since = meta["dark_since"]
    for name, g in rngs.items():
        set_rng_state(g, meta["rng"][name])
    if accountant is not None:
        accountant.load_state(meta["accountant"])
    policy.load_state(meta["policy"])
    registry.load_state(meta["metrics"])
    # the snapshot was taken mid-event (inside the flush loop): replay
    # the interrupted event's tail — remaining full-buffer flushes and
    # the freed slot's redispatch — so run() picks up exactly where the
    # original run's event loop would have
    sched.finish_event(q.now)
    return sched.records


# ---------------------------------------------------------------------------
# sync snapshots


def encode_sync(*, y, sstate, round_idx: int, now: float, history, rngs,
                policy, registry, report, shocks=None,
                topo=None) -> Tuple[Dict[str, Any],
                                    Dict[str, np.ndarray]]:
    """Snapshot a sync run after round ``round_idx`` finished (the next
    round to run is ``round_idx + 1``). The comm ledger is billed per
    round in sync mode, so its measured totals ride along."""
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(pack_tree("y", y))
    arrays.update(pack_leaves("s", sstate))
    meta = {
        "grid_state_version": GRID_STATE_VERSION,
        "mode": "sync",
        "round": int(round_idx),
        "now": float(now),
        "history": history,
        "rng": {name: rng_state(g) for name, g in rngs.items()},
        "policy": policy.state_dict(),
        "metrics": registry.state_dict(),
        "comm": {"measured_down_bytes": int(report.measured_down_bytes),
                 "measured_up_bytes": int(report.measured_up_bytes),
                 "transfers": int(report.transfers),
                 "tier_traffic": report.tier_traffic,
                 "hop_traffic": report.hop_traffic},
        "topology": _topology_meta(topo),
        "shocks": shocks.state_dict() if shocks is not None else None,
    }
    return meta, arrays


def decode_sync(meta: Dict[str, Any], arrays: Dict[str, np.ndarray], *,
                sstate_template, rngs, policy, registry, report,
                dev: torch.device, shocks=None, topo=None):
    """Returns (y, sstate, next_round, now, history), the tensors on
    ``dev``, and restores the rng / policy / metrics / comm state in
    place."""
    if meta["mode"] != "sync":
        raise ValueError(f"cannot resume a {meta['mode']!r} snapshot in "
                         "sync mode — GridConfig.mode must match")
    _check_topology(meta, topo, shocks)
    y = unpack_tree("y", arrays, dev)
    sstate = unpack_leaves("s", arrays, sstate_template, dev)
    for name, g in rngs.items():
        set_rng_state(g, meta["rng"][name])
    policy.load_state(meta["policy"])
    registry.load_state(meta["metrics"])
    c = meta["comm"]
    report.measured_down_bytes = int(c["measured_down_bytes"])
    report.measured_up_bytes = int(c["measured_up_bytes"])
    report.transfers = int(c["transfers"])
    report.tier_traffic = {name: dict(rec)
                           for name, rec in c["tier_traffic"].items()}
    report.hop_traffic = {name: dict(rec)
                          for name, rec in c.get("hop_traffic",
                                                 {}).items()}
    return (y, sstate, int(meta["round"]) + 1, float(meta["now"]),
            list(meta["history"]))
