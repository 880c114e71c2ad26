"""Adaptive (quantile-based) clipping for DP-FedAvg / DP-FTRL (Andrew et
al. 2021, "Differentially Private Learning with Adaptive Clipping"), port
of ``repro/core/adaptive_clip.py``.

The clip norm C_t tracks a target quantile gamma of the client update
norms by geometric updates, C_{t+1} = C_t * exp(-eta_C (b_t - gamma)),
where b_t is the (noised, for DP) fraction of clients whose update fit
inside C_t. With FedPT the norms live in the trainable subspace only, so
the estimator adapts to the reduced dimension by itself.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import basic, threefry


@dataclasses.dataclass(frozen=True)
class AdaptiveClipConfig:
    initial_clip: float = 0.1
    target_quantile: float = 0.5
    lr: float = 0.2               # eta_C
    fraction_noise_std: float = 0.0  # sigma_b for DP on the count


def init_state(cfg: AdaptiveClipConfig, device=None):
    return {"clip": torch.tensor(cfg.initial_clip, dtype=torch.float32,
                                 device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def update_state(cfg: AdaptiveClipConfig, state, norms, rng=None):
    """norms: (clients,) pre-clip update norms. Returns (new_state, clip).
    With ``fraction_noise_std > 0`` the count is noised by one normal
    drawn from the threefry key ``rng`` (``jax.random.normal(rng, ())``'s
    bits)."""
    clip = state["clip"]
    b = torch.mean((norms <= clip).float())
    if cfg.fraction_noise_std > 0 and rng is not None:
        b = b + cfg.fraction_noise_std * threefry.normal(rng, (), b.device)
    new_clip = clip * torch.exp(-cfg.lr * (b - cfg.target_quantile))
    return {"clip": new_clip, "t": state["t"] + 1}, clip


def clipped_mean(deltas, norms, clip):
    """Clip each client delta to ``clip`` and average (uniform weights)."""
    clip = torch.as_tensor(clip, dtype=torch.float32, device=norms.device)
    scale = torch.clamp(clip / torch.clamp_min(norms, 1e-12), max=1.0)
    return basic.tree_map(
        lambda d: torch.mean(d * scale.reshape((-1,) + (1,) * (d.ndim - 1)),
                             dim=0), deltas)
