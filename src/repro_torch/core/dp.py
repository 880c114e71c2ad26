"""Per-flush differential privacy for buffered-async (FedBuff)
aggregation, port of ``FlushDPConfig`` and ``FlushAccountant`` from
``repro/core/dp.py`` (plain Python RDP accounting).

The sync engine privatizes one *round*: sigma = z * C / clients_per_round
with a fixed denominator so dropped clients shrink the numerator, never
the noise scale. The async analogue privatizes one *flush*: the unit of
composition is one buffered server update of ``goal_count`` client
deltas. The same fixed-denominator discipline applies — a drained final
buffer is padded to ``goal_count`` with zero-weight rows, and neither
the mean's denominator nor sigma changes for it, so every flush of a
run is the same Gaussian mechanism and composition stays a simple
product over flushes.

DP-FTRL (``tree_noise`` and its ServerOpt) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.obs import trace as trace_lib


@dataclasses.dataclass(frozen=True)
class FlushDPConfig:
    """Noise calibration for ONE async buffer flush.

    Per-client deltas arrive clipped to ``clip_norm`` (inside the flat
    client step) and are combined with weights in [0, 1] (staleness
    factor x uniform weight, or 0 for padding rows) over the FIXED
    denominator ``goal_count`` — so one client's contribution to the
    flushed mean has L2 norm at most ``clip_norm / goal_count``, and
    ``sigma = noise_multiplier * clip_norm / goal_count`` gives each
    flush the standard Gaussian mechanism with multiplier z.
    """
    clip_norm: float
    noise_multiplier: float
    goal_count: int

    def __post_init__(self):
        if self.clip_norm <= 0 or self.goal_count < 1:
            raise ValueError("flush DP needs clip_norm > 0 and "
                             "goal_count >= 1")

    @property
    def sensitivity(self) -> float:
        return self.clip_norm / self.goal_count

    @property
    def sigma(self) -> float:
        return self.noise_multiplier * self.sensitivity


class FlushAccountant:
    """Counts flushes and composes their Gaussian mechanisms via RDP.

    A flush where every buffered delta comes from a distinct client is
    one Gaussian mechanism with multiplier z. Async dispatch samples
    clients WITH replacement, though, so one client can own ``m >= 1``
    rows of the same flush — changing that client's data then moves the
    flushed mean by up to ``m * clip_norm / goal_count`` (each row is
    clipped and carries weight <= 1), an effective multiplier ``z / m``
    for that flush. The accountant therefore takes the observed
    per-flush multiplicity and composes
    ``RDP(alpha) = alpha / (2 z^2) * sum_t m_t^2``, giving
    ``eps(delta) = min_alpha RDP(alpha) + log(1/delta) / (alpha - 1)``.
    No client-sampling amplification is claimed (async dispatch is not
    a uniform subsample), so the bound is conservative.
    """

    _ALPHAS = tuple([1.0 + x / 10.0 for x in range(1, 100)]
                    + list(range(11, 64)) + [128, 256, 512])

    def __init__(self, cfg: FlushDPConfig,
                 tracer=trace_lib.NULL_TRACER):
        self.cfg = cfg
        self.tracer = tracer
        self.flushes = 0
        self.padded_flushes = 0
        self.max_multiplicity = 0
        self._sum_m2 = 0.0

    def record_flush(self, n_real: int, multiplicity: int = 1,
                     now: float = 0.0, parent=None) -> None:
        """One applied server update with ``n_real`` non-padding rows,
        of which at most ``multiplicity`` belong to the same client.
        Padding changes neither sigma nor the accounting — the mechanism
        is identical, a short flush just spends the same budget on fewer
        clients.

        ``now`` is the flush's virtual time, used only for the tracer's
        ``dp_flush`` instant (each composition step carries sigma and
        the epsilon spent SO FAR, so a timeline shows the budget curve)."""
        if multiplicity < 1:
            raise ValueError("multiplicity must be >= 1")
        self.flushes += 1
        self.max_multiplicity = max(self.max_multiplicity, multiplicity)
        self._sum_m2 += float(multiplicity) ** 2
        if n_real < self.cfg.goal_count:
            self.padded_flushes += 1
        if self.tracer.enabled:
            delta = 1e-5
            self.tracer.instant(
                "dp_flush", now, parent=parent, flush=self.flushes - 1,
                n_real=int(n_real), multiplicity=int(multiplicity),
                sigma=self.cfg.sigma, epsilon=self.epsilon(delta),
                delta=delta, padded=bool(n_real < self.cfg.goal_count))

    def epsilon(self, delta: float = 1e-5) -> float:
        z = self.cfg.noise_multiplier
        if z <= 0:
            return math.inf
        if self.flushes == 0:
            return 0.0
        return min(self._sum_m2 * a / (2.0 * z * z)
                   + math.log(1.0 / delta) / (a - 1.0)
                   for a in self._ALPHAS)

    def summary(self, delta: float = 1e-5) -> dict:
        return {"flushes": self.flushes,
                "padded_flushes": self.padded_flushes,
                "max_multiplicity": self.max_multiplicity,
                "sigma": self.cfg.sigma,
                "noise_multiplier": self.cfg.noise_multiplier,
                "epsilon": self.epsilon(delta), "delta": delta}
