"""Per-flush differential privacy for buffered-async (FedBuff)
aggregation and the DP-FTRL server optimizer, port of ``FlushDPConfig``,
``FlushAccountant`` (with its restorable state), ``tree_noise``,
``DPFTRLConfig``, ``dp_ftrl_server_opt`` and ``NOISE_TO_EPS`` from
``repro/core/dp.py``.

The sync engine privatizes one *round*: sigma = z * C / clients_per_round
with a fixed denominator so dropped clients shrink the numerator, never
the noise scale. The async analogue privatizes one *flush*: the unit of
composition is one buffered server update of ``goal_count`` client
deltas. The same fixed-denominator discipline applies — a drained final
buffer is padded to ``goal_count`` with zero-weight rows, and neither
the mean's denominator nor sigma changes for it, so every flush of a
run is the same Gaussian mechanism and composition stays a simple
product over flushes.

DP-FTRL (Kairouz et al. 2021) privatizes the running sum of the
pseudo-gradients instead, with binary-tree noise (``tree_noise``), as the
paper's section 4.2 runs it on Stack Overflow.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.nn import threefry
from repro_torch.nn.basic import flatten_params, tree_map, unflatten_params
from repro_torch.obs import trace as trace_lib
from repro_torch.optim import optimizers as opt_lib


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

    def state_dict(self) -> dict:
        """Restorable ledger state (the config is not serialized: a
        resumed run rebuilds it from GridConfig and :meth:`load_state`
        cross-checks the calibration)."""
        return {"flushes": self.flushes,
                "padded_flushes": self.padded_flushes,
                "max_multiplicity": self.max_multiplicity,
                "sum_m2": self._sum_m2,
                "sigma": self.cfg.sigma,
                "noise_multiplier": self.cfg.noise_multiplier,
                "goal_count": self.cfg.goal_count}

    def load_state(self, state: dict) -> None:
        """Restore the composition ledger in place. Raises if the saved
        calibration (sigma / z / goal_count) does not match this
        accountant's config: resuming under another mechanism would
        misprice every flush before the restore."""
        for field, have in (("sigma", self.cfg.sigma),
                            ("noise_multiplier", self.cfg.noise_multiplier),
                            ("goal_count", self.cfg.goal_count)):
            want = state.get(field)
            if want is not None and not math.isclose(
                    float(want), float(have),
                    rel_tol=1e-12, abs_tol=0.0):
                raise ValueError(
                    f"checkpointed DP calibration {field}={want!r} does "
                    f"not match this run's {field}={have!r} — resume "
                    "with the same dp_* GridConfig settings")
        self.flushes = int(state["flushes"])
        self.padded_flushes = int(state["padded_flushes"])
        self.max_multiplicity = int(state["max_multiplicity"])
        self._sum_m2 = float(state["sum_m2"])

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


# binary-tree levels the reference's noise loop walks (a step t < 2**30)
TREE_LEVELS = 30


def tree_noise(rng_key: threefry.Key, tree, sigma: float, t: int):
    """Noise of the binary-tree cumulative-sum estimator at step t
    (1-indexed): per leaf, the sum of one Gaussian per set bit of t, each
    keyed by ``fold_in(fold_in(leaf_key, level), t >> level)``, times
    sigma; the leaf keys are ``split(rng_key, n_leaves)`` in leaf order.
    Variance grows as popcount(t) * sigma^2 <= log2(T) * sigma^2.

    The reference draws all 30 levels and adds ``bit * z`` in level
    order; a clear bit adds 0 * z, which leaves the float32 sum as it was
    (z is finite), so drawing the set bits alone, in the same order, gives
    the same sums bit for bit (test-enforced)."""
    t = int(t)
    if not 0 <= t < 1 << TREE_LEVELS:
        raise ValueError(f"step {t} outside [0, 2**{TREE_LEVELS})")
    leaves = list(flatten_params(tree))
    out = {}
    for (path, leaf), leaf_key in zip(leaves,
                                      threefry.split(rng_key, len(leaves))):
        acc = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
        for level in range(TREE_LEVELS):
            if (t >> level) & 1:
                k = threefry.fold_in(threefry.fold_in(leaf_key, level),
                                     t >> level)
                acc = acc + threefry.normal(k, tuple(leaf.shape), leaf.device)
        out[path] = sigma * acc
    return unflatten_params(out)


@dataclasses.dataclass(frozen=True)
class DPFTRLConfig:
    lr: float
    noise_multiplier: float
    clip_norm: float
    clients_per_round: int
    momentum: float = 0.9
    seed: int = 1234


def dp_ftrl_server_opt(cfg: DPFTRLConfig) -> opt_lib.Optimizer:
    """ServerOpt implementing DP-FTRL(-M): the model is a function of the
    privatized cumulative sum S_t = sum_i delta_i + TreeNoise(t).

    state = {x0, cumsum, prev_priv, momentum buffer m, t}; t is a host
    int, so the noise keys need no device read. The incoming "grads" are
    -delta (the round engine's pseudo-gradient convention), already
    clipped per client and averaged with uniform weights, so the
    sensitivity per round is clip_norm / clients_per_round."""
    sigma = cfg.noise_multiplier * cfg.clip_norm / cfg.clients_per_round
    key = threefry.key(cfg.seed)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"x0": tree_map(torch.clone, params),
                "cumsum": tree_map(zeros, params),
                "prev_priv": tree_map(zeros, params),
                "m": tree_map(zeros, params), "t": 0}

    def update(params, grads, state):
        t = state["t"] + 1
        # grads = -delta; the cumulative sum of the descent direction
        cumsum = tree_map(lambda c, g: c + g.float(), state["cumsum"], grads)
        priv = opt_lib.tree_add(cumsum, tree_noise(key, cumsum, sigma, t))
        # momentum on the privatized increment
        inc = opt_lib.tree_sub(priv, state["prev_priv"])
        m = tree_map(lambda mm, ii: cfg.momentum * mm + ii, state["m"], inc)
        new = tree_map(lambda p, mm: (p - cfg.lr * mm).to(p.dtype), params, m)
        return new, {"x0": state["x0"], "cumsum": cumsum, "prev_priv": priv,
                     "m": m, "t": t}

    return opt_lib.Optimizer(
        init, update, f"dp-ftrl(lr={cfg.lr},z={cfg.noise_multiplier})")


# Noise-multiplier -> epsilon mapping quoted from the paper's Table 5
# (Kairouz et al. 2021b accountant; no offline accountant available here):
# noise 0 -> eps inf, 1.13 -> 19.74, 2.33 -> 8.50, 4.03 -> 5.66,
# 6.21 -> 2.95, 8.83 -> 2.04 (SO NWP, 1600 rounds, report goal 100).
NOISE_TO_EPS = {0.0: float("inf"), 1.13: 19.74, 2.33: 8.50,
                4.03: 5.66, 6.21: 2.95, 8.83: 2.04}
