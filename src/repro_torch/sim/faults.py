"""Deterministic fault injection for the simulation grid.

The grid's failure model so far was *clean*: a dispatched client either
uploads a well-formed delta or drops out silently. Real cross-device
fleets fail messier — clients die mid-compute, uploads truncate on a
dropped link, payloads arrive corrupted (bad flash, bad RAM, bad actors),
retransmits deliver the same delta twice, and the *server* restarts
mid-run. This module injects all of those, deterministically:

* :class:`FaultConfig` — per-dispatch fault probabilities (crash mid-
  compute, upload truncation, NaN/Inf corruption, bit-flipped segments,
  duplicate delivery) plus a server kill at virtual time T.
* :class:`BoundFaults` — the config bound to its own RNG stream. The
  stream is a ``spawn`` child of the device stream (the dynamics
  stream's hygiene rule): spawning advances **zero** draws of the parent, and each
  dispatch consumes a *fixed count* of fault-stream draws, so
  ``faults=None`` is bit-identical to the pre-fault grid and a
  corruption-only config never moves the dispatch clock (test-enforced).
* :func:`corrupt_row` — applies a drawn payload corruption to one flat
  delta row, re-seeded from the per-event corruption seed so a restored
  checkpoint replays the exact same damage.
* :class:`ServerKilled` — raised when the virtual clock crosses
  ``server_kill_at``; the grid annotates it with the last grid-state
  checkpoint path so callers can resume.

Payload corruptions (truncate/NaN/bitflip/duplicate) act on the async
path's materialized flat rows; the sync engine computes deltas inside
one jitted cohort step and has no per-client wire payload to damage, so
sync supports crash + server-kill only and rejects payload faults
loudly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import numpy as np


class ServerKilled(RuntimeError):
    """The virtual clock crossed ``FaultConfig.server_kill_at``.

    ``at`` is the virtual time of the event that crossed the kill line,
    ``applied`` the number of server updates applied before death, and
    ``checkpoint`` (set by the grid) the latest grid-state snapshot to
    resume from (``None`` when no checkpoint was ever written)."""

    def __init__(self, at: float, applied: int,
                 checkpoint: Optional[str] = None):
        self.at = float(at)
        self.applied = int(applied)
        self.checkpoint = checkpoint
        super().__init__(
            f"server killed at virtual t={self.at:.1f}s after "
            f"{self.applied} applied updates"
            + (f" (resume from {checkpoint})" if checkpoint else ""))


# the async upload-time fault kinds, in cumulative-probability order (one
# uniform per dispatch is partitioned over these edges)
_KINDS = ("crash", "truncate", "nan", "bitflip", "duplicate")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-dispatch fault probabilities and the server-kill time.

    At most one fault fires per dispatch (the five probabilities
    partition one uniform draw, so they must sum to <= 1):

    ``crash_compute``
        the client dies after the download + ``crash_frac`` of its
        local compute — it consumed downlink and battery but never
        uploads (both modes);
    ``truncate_upload``
        the upload cuts off partway: the server receives (and bills) a
        fraction of the bytes, detects the length mismatch and drops
        the delta before buffering (async only);
    ``corrupt_nan``
        a random subset of ``nan_frac`` of the row's elements arrives
        as NaN/±Inf (async only);
    ``corrupt_bitflip``
        the top exponent bit of a contiguous ``bitflip_frac`` segment
        is flipped — finite-but-astronomical values that pure
        ``isfinite`` screens miss (async only);
    ``duplicate_upload``
        the delta is delivered twice (retransmit after a lost ack);
        both copies buffer and both bill uplink bytes (async only).

    ``server_kill_at`` kills the *server* at that virtual time by
    raising :class:`ServerKilled` — the crash-recovery half of the
    fault model (pair with ``GridConfig.checkpoint_every``).
    """

    crash_compute: float = 0.0
    truncate_upload: float = 0.0
    corrupt_nan: float = 0.0
    corrupt_bitflip: float = 0.0
    duplicate_upload: float = 0.0
    server_kill_at: float = math.inf
    # corruption shape knobs
    nan_frac: float = 0.02        # fraction of elements poisoned (nan)
    bitflip_frac: float = 0.01    # fraction of elements bit-flipped
    crash_frac: float = 0.5       # fraction of compute done before a crash
    min_truncate_frac: float = 0.1  # at least this fraction of bytes arrive

    def __post_init__(self):
        for name in ("crash_compute", "truncate_upload", "corrupt_nan",
                     "corrupt_bitflip", "duplicate_upload"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} is not a probability")
        if self.prob_total > 1.0:
            raise ValueError(f"fault probabilities sum to "
                             f"{self.prob_total} > 1 (at most one fault "
                             "fires per dispatch)")
        if self.server_kill_at <= 0:
            raise ValueError("server_kill_at must be a positive virtual "
                             "time (inf = never)")
        for name in ("nan_frac", "bitflip_frac", "crash_frac",
                     "min_truncate_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must lie in [0, 1]")

    @property
    def prob_total(self) -> float:
        return (self.crash_compute + self.truncate_upload + self.corrupt_nan
                + self.corrupt_bitflip + self.duplicate_upload)

    @property
    def payload_prob(self) -> float:
        """Probability mass on upload-payload faults (async only)."""
        return (self.truncate_upload + self.corrupt_nan
                + self.corrupt_bitflip + self.duplicate_upload)

    @property
    def trivial(self) -> bool:
        return self.prob_total == 0.0 and math.isinf(self.server_kill_at)

    def bind(self, rng: np.random.Generator) -> "BoundFaults":
        return BoundFaults(self, rng)


class BoundFaults:
    """A FaultConfig bound to its own RNG stream (a spawn child of the
    device stream — zero parent draws). ``draw()`` consumes exactly two
    fault-stream draws per async dispatch; ``crash_draws(m)`` consumes
    exactly ``m`` per sync round — fixed counts, so the stream position
    is outcome-independent and checkpoint/resume replays it exactly."""

    def __init__(self, cfg: FaultConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        c = cfg
        self._edges = np.cumsum([c.crash_compute, c.truncate_upload,
                                 c.corrupt_nan, c.corrupt_bitflip,
                                 c.duplicate_upload])

    @property
    def kill_at(self) -> float:
        return self.cfg.server_kill_at

    def draw(self) -> Optional[Dict[str, Any]]:
        """One per-dispatch fault decision: ``None`` (no fault) or
        ``{"kind", "seed"[, "frac"]}``. Always two draws — a uniform for
        the kind and a 63-bit per-event corruption seed — regardless of
        the outcome."""
        u = self.rng.random()
        seed = int(self.rng.integers(0, 2**63 - 1))
        k = int(np.searchsorted(self._edges, u, side="right"))
        if k >= len(_KINDS) or u >= self._edges[-1]:
            return None
        kind = _KINDS[k]
        fault: Dict[str, Any] = {"kind": kind, "seed": seed}
        if kind == "truncate":
            # derive the arriving fraction from the event seed (no
            # further parent-stream draws)
            r = np.random.default_rng(seed)
            lo = self.cfg.min_truncate_frac
            fault["frac"] = float(lo + (0.9 - lo) * r.random())
        return fault

    def crash_draws(self, m: int) -> np.ndarray:
        """Fixed-count sync-round draws: ``crashed[i]`` for each cohort
        member (the only fault kind the sync engine supports)."""
        return self.rng.random(m) < self.cfg.crash_compute


def corrupt_row(row: np.ndarray, kind: str, seed: int,
                cfg: FaultConfig) -> np.ndarray:
    """Apply a drawn payload corruption to one flat fp32 delta row.

    Deterministic in ``seed`` (the per-event corruption seed), so a
    resumed run replays byte-identical damage. ``nan`` scatters NaN/±Inf
    over a random ``nan_frac`` subset; ``bitflip`` XORs the top exponent
    bit of a contiguous ``bitflip_frac`` segment — for |x| < 2 that
    sends the value to ~1e38/Inf territory, the norm-outlier screen's
    clientele."""
    out = np.array(row, np.float32, copy=True)
    n = out.size
    if n == 0:
        return out
    r = np.random.default_rng(seed)
    if kind == "nan":
        k = min(n, max(1, int(cfg.nan_frac * n)))
        idx = r.choice(n, size=k, replace=False)
        vals = r.random(k)
        out[idx] = np.where(vals < 0.5, np.float32(np.nan),
                            np.where(vals < 0.75, np.float32(np.inf),
                                     np.float32(-np.inf)))
    elif kind == "bitflip":
        k = min(n, max(1, int(cfg.bitflip_frac * n)))
        start = int(r.integers(0, n))
        idx = (start + np.arange(k)) % n
        bits = out.view(np.uint32)
        bits[idx] ^= np.uint32(1 << 30)   # top exponent bit
    else:
        raise ValueError(f"not a payload-corruption kind: {kind!r}")
    return out


# ---------------------------------------------------------------------------
# Presets + resolution


def _preset_chaos() -> FaultConfig:
    # every fault kind live at once: the example's corrupted-cohort demo
    # and the CI chaos job run on this
    return FaultConfig(crash_compute=0.05, truncate_upload=0.05,
                       corrupt_nan=0.08, corrupt_bitflip=0.08,
                       duplicate_upload=0.05)


FAULT_PRESETS = {
    "chaos": _preset_chaos,
}


def resolve_faults(
        spec: Union[None, str, dict, FaultConfig]) -> Optional[FaultConfig]:
    """GridConfig.faults -> FaultConfig or None (trivial).

    ``None`` and an all-zero config resolve to ``None`` — the signal for
    the schedulers to take the exact pre-fault code paths (no fault
    stream is even spawned). A name looks up :data:`FAULT_PRESETS`; a
    dict builds a config from fields; a config passes through."""
    if spec is None:
        return None
    if isinstance(spec, str):
        try:
            cfg = FAULT_PRESETS[spec]()
        except KeyError:
            raise ValueError(f"unknown fault preset {spec!r}; options: "
                             f"{sorted(FAULT_PRESETS)}") from None
    elif isinstance(spec, dict):
        cfg = FaultConfig(**spec)
    elif isinstance(spec, FaultConfig):
        cfg = spec
    else:
        raise TypeError(f"faults must be None, a preset name, a dict or a "
                        f"FaultConfig, got {type(spec).__name__}")
    return None if cfg.trivial else cfg
