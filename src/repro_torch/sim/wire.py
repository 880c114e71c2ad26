"""Wire-level payload serialization for the simulation grid, port of
``repro/sim/wire.py``: the same bytes, byte for byte (test-enforced).

The comm ledger (``core/comm.py``) *predicts* payload sizes analytically;
this module actually serializes the FedPT payloads and meters the bytes,
so the grid reports **measured** communication:

* downlink: the trainable tree ``y`` as raw little-endian leaf bytes in
  flatten order (sorted keys, as JAX's), followed by the 8-byte
  frozen-side seed — everything a FedPT client needs (the frozen side is
  regenerated from the seed);
* uplink: the trainable delta, either raw fp32/native-dtype leaf bytes,
  or (``bits=8``) symmetric int8 quantization via ``core/compress.py`` —
  per leaf, the int8 payload followed by its f32 scale.

Leaves go to the host through ``.detach().cpu().numpy()``. For fp32
payloads the measured sizes equal ``CommReport.download_fedpt`` /
``upload_fedpt`` exactly; for int8 they equal
``compress.quantized_uplink_bytes``. ``tier_payloads`` gives each
trainability tier's sliced uplink (``core/plan.py``), and
``edge_flush_bytes`` an edge aggregator's pre-reduced buffer.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import comm, compress
from repro_torch.nn import basic

SEED_BYTES = comm.SEED_BYTES
_SEED_FMT = "<q"   # int64 little-endian == 8 bytes
_SCALE_FMT = "<f"  # one f32 scale per quantized leaf
assert struct.calcsize(_SEED_FMT) == SEED_BYTES
assert struct.calcsize(_SCALE_FMT) == compress.SCALE_BYTES


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Shape/dtype template both endpoints share out-of-band (it is part
    of the model architecture, not of any per-round payload)."""
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[np.dtype, ...]

    @classmethod
    def of(cls, tree) -> "TreeSpec":
        items = list(basic.flatten_params(tree))
        return cls(paths=tuple(p for p, _ in items),
                   shapes=tuple(tuple(l.shape) for _, l in items),
                   dtypes=tuple(np.dtype(_np(l).dtype) for _, l in items))

    def unflatten(self, leaves: List[np.ndarray]):
        return basic.unflatten_params(
            {p: torch.from_numpy(np.array(l, copy=True))
             for p, l in zip(self.paths, leaves)})


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_leaves(tree) -> List[np.ndarray]:
    return [_np(l) for l in basic.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# Downlink: trainable y + seed


def encode_downlink(y, seed: int) -> bytes:
    parts = [l.tobytes() for l in _np_leaves(y)]
    parts.append(struct.pack(_SEED_FMT, int(seed)))
    return b"".join(parts)


def decode_downlink(buf: bytes, spec: TreeSpec):
    """Returns (y, seed), y as CPU tensors."""
    leaves, off = [], 0
    for shape, dtype in zip(spec.shapes, spec.dtypes):
        count = int(np.prod(shape, dtype=np.int64))
        leaves.append(np.frombuffer(buf, dtype, count=count,
                                    offset=off).reshape(shape))
        off += count * dtype.itemsize
    (seed,) = struct.unpack_from(_SEED_FMT, buf, off)
    off += SEED_BYTES
    if off != len(buf):
        raise ValueError(f"trailing bytes in downlink payload: "
                         f"{len(buf) - off}")
    return spec.unflatten(leaves), int(seed)


# ---------------------------------------------------------------------------
# Uplink: trainable delta, raw or int8-quantized


def encode_uplink(delta, bits: int = 0) -> bytes:
    if bits == 0:
        return b"".join(l.tobytes() for l in _np_leaves(delta))
    if bits != 8:
        raise ValueError("wire serialization supports fp32 (bits=0) or "
                         f"int8 (bits=8) uplinks, got bits={bits}")
    parts = []
    for leaf in basic.tree_leaves(delta):
        q, scale = compress.quantize_leaf(torch.as_tensor(leaf), bits)
        parts.append(_np(q).tobytes())
        parts.append(struct.pack(_SCALE_FMT, float(scale)))
    return b"".join(parts)


def decode_uplink(buf: bytes, spec: TreeSpec, bits: int = 0):
    """Inverse of encode_uplink; int8 payloads come back dequantized to
    float32 (the server aggregates in f32 anyway). CPU tensors."""
    leaves, off = [], 0
    for shape, dtype in zip(spec.shapes, spec.dtypes):
        n_elems = int(np.prod(shape, dtype=np.int64))
        if bits == 0:
            leaves.append(np.frombuffer(buf, dtype, count=n_elems,
                                        offset=off).reshape(shape))
            off += n_elems * dtype.itemsize
        else:
            q = np.frombuffer(buf, np.int8, count=n_elems,
                              offset=off).reshape(shape)
            off += n_elems
            (scale,) = struct.unpack_from(_SCALE_FMT, buf, off)
            off += compress.SCALE_BYTES
            leaves.append(q.astype(np.float32) * np.float32(scale))
    if off != len(buf):
        raise ValueError(f"trailing bytes in uplink payload: "
                         f"{len(buf) - off}")
    return spec.unflatten(leaves)


# ---------------------------------------------------------------------------
# Metering


def downlink_bytes(y) -> int:
    """Measured downlink payload size (serializes once; the size is
    value-independent, so callers may cache per round shape)."""
    return len(encode_downlink(y, 0))


def uplink_bytes(delta, bits: int = 0) -> int:
    return len(encode_uplink(delta, bits))


def edge_flush_bytes(y) -> int:
    """Edge->server payload under a two-level topology: one region's
    pre-reduced flat delta buffer, serialized fp32 — no seed."""
    return len(encode_uplink(y, bits=0))


def tier_payloads(y, cplan, bits: int = 0) -> dict:
    """Per-tier wire payload sizes under a trainability plan:
    ``{tier name: {"down": bytes, "up": bytes}}``.

    The uplink is the tier's sliced delta: only the leaves the tier trains
    are serialized (measured for fp32 / int8, analytic int-k otherwise).
    The downlink is the same for every tier, the full trainable tree plus
    the seed: blocks a tier froze are still trained by other tiers and
    cannot be regenerated from the seed."""
    down = downlink_bytes(y)
    out = {}
    for t in cplan.tiers:
        y_t, _ = cplan.split(y, t)
        if bits in (0, 8):
            up = uplink_bytes(y_t, bits=bits)
        else:
            up = compress.quantized_uplink_bytes(y_t, bits)
        out[t.name] = {"down": down, "up": up}
    return out


def assert_matches_analytic(y, frozen, uplink_bits: int = 0) -> None:
    """Cross-check: measured wire bytes == the analytic ledger. Raises
    AssertionError on drift."""
    rep = comm.report_for(y, frozen, uplink_bits=uplink_bits)
    down = downlink_bytes(y)
    up = uplink_bytes(y, bits=uplink_bits)
    if down != rep.download_fedpt:
        raise AssertionError(f"downlink measured {down} != analytic "
                             f"{rep.download_fedpt}")
    if up != rep.upload_fedpt:
        raise AssertionError(f"uplink measured {up} != analytic "
                             f"{rep.upload_fedpt}")
