"""Delta quarantine, port of ``repro/core/sanitize.py``: screen the flat
``(K, size)`` delta buffer before it touches aggregation.

DP clipping does not protect the server from a corrupted upload
(``NaN * scale`` is NaN), so the screen runs first in the server tail and
quarantines two kinds of row:

* **non-finite**: any NaN or +-Inf element;
* **norm outlier**: a finite row whose L2 norm exceeds ``norm_mult`` x
  the median norm of the live rows (weight > 0, finite, norm > 0).

Quarantined rows get zero weight (and, on the staged route, zero data:
``NaN * 0`` is NaN inside the mean). A fixed DP denominator is left as
it is, so a quarantined row counts like a padding row.

The median is JAX's ``nanmedian``: for an even count of live rows the
midpoint of the two middle values. ``torch.nanmedian`` returns the lower
one instead, so :func:`nanmedian` computes it itself. Everything stays on
the device: no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import flat as flat_lib


@dataclasses.dataclass(frozen=True)
class SanitizeConfig:
    """Quarantine screen knobs: ``nonfinite`` toggles the NaN/Inf row
    mask; ``norm_mult`` sets the outlier threshold as a multiple of the
    median live-row norm (``<= 0`` disables the outlier screen)."""

    nonfinite: bool = True
    norm_mult: float = 10.0

    @property
    def trivial(self) -> bool:
        return not self.nonfinite and self.norm_mult <= 0


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D float32 tensor (NaN when
    there are none), as ``jnp.nanmedian`` computes it: at position
    p = (n - 1) / 2 of the sorted values, ``lo * (1 - f) + hi * f`` with
    lo, hi the values at floor(p), ceil(p) and f = p - floor(p)."""
    vals = torch.sort(x).values                      # NaN sorts last
    n = (~torch.isnan(x)).sum().float()
    pos = 0.5 * (n - 1)
    lo_i, hi_i = torch.floor(pos), torch.ceil(pos)
    hi_w = pos - lo_i
    last = torch.clamp_min(n - 1, 0)

    def at(i):
        return vals[torch.minimum(torch.clamp_min(i, 0), last).long()]

    return at(lo_i) * (1 - hi_w) + at(hi_i) * hi_w


def screen_from_stats(norms: torch.Tensor, row_finite: torch.Tensor,
                      weights: torch.Tensor, cfg: SanitizeConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Dict[str, torch.Tensor]]:
    """Quarantine decisions from per-row pre-screen L2 ``norms`` and
    all-finite flags ``row_finite``. A row with ``row_finite`` False may
    carry a NaN/Inf norm: every use is masked by ``row_finite``.

    Returns ``(clean_weights, quarantine_mask, info)``; ``info`` holds the
    ``nonfinite`` / ``outlier`` masks and the ``norms`` (0 on non-finite
    rows). :func:`screen_rows` decides the same, bit for bit."""
    zeros = torch.zeros_like(row_finite)
    nonfinite_q = ~row_finite if cfg.nonfinite else zeros
    if cfg.norm_mult > 0:
        live = (weights > 0) & row_finite & (norms > 0)
        med = nanmedian(torch.where(live, norms,
                                    torch.full_like(norms, float("nan"))))
        # no live rows: the median is NaN and no comparison holds
        outlier_q = live & (norms > cfg.norm_mult * med)
    else:
        outlier_q = zeros
    q = nonfinite_q | outlier_q
    clean_w = torch.where(q, torch.zeros_like(weights), weights)
    info = {"nonfinite": nonfinite_q, "outlier": outlier_q,
            "norms": torch.where(row_finite, norms, torch.zeros_like(norms))}
    return clean_w, q, info


def screen_rows(mat: torch.Tensor, weights: torch.Tensor,
                cfg: SanitizeConfig, align: int = flat_lib.ALIGN,
                plane=None, nb: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    """Screen a flat ``(K, size)`` buffer with its own sweeps: returns
    ``(clean_mat, clean_weights, info)``, quarantined rows zeroed in
    both. Norms come from a NaN-free view, so a poisoned row cannot
    poison the median.

    On a mesh (``plane``, ``launch/sharding.FlatPlane``) ``mat`` is this
    rank's block of the buffer, of ``nb`` blocks in all: the finite flags
    are ANDed over "model", the norms made whole
    (:func:`flat_lib.row_norms`), every row decided on every rank, and
    this rank's rows zeroed."""
    plane = flat_lib.WHOLE if plane is None else plane
    K = weights.shape[0]
    finite = torch.isfinite(mat)
    row_finite = plane.gather_rows(plane.all_model(finite.all(dim=1)), K)
    safe = torch.where(finite, mat, torch.zeros_like(mat))
    norms = flat_lib.row_norms(safe, align, plane, K, nb)
    clean_w, q, info = screen_from_stats(norms, row_finite, weights, cfg)
    r0, r1 = plane.rows(K)
    clean = torch.where(q[r0:r1, None], torch.zeros_like(mat), mat)
    return clean, clean_w, info


def resolve_sanitize(
        spec: Union[None, bool, str, dict, SanitizeConfig]
) -> Optional[SanitizeConfig]:
    """A sanitize spec -> SanitizeConfig, or None (screen off).

    ``None``/``False``/``"off"`` and a trivial config give None; ``True``
    or ``"on"`` the default screen; a dict builds a config from fields; a
    config passes through."""
    if spec is None or spec is False:
        return None
    if spec is True:
        cfg = SanitizeConfig()
    elif isinstance(spec, str):
        if spec == "off":
            return None
        if spec != "on":
            raise ValueError(f"unknown sanitize spec {spec!r}; options: "
                             "'on', 'off'")
        cfg = SanitizeConfig()
    elif isinstance(spec, dict):
        cfg = SanitizeConfig(**spec)
    elif isinstance(spec, SanitizeConfig):
        cfg = spec
    else:
        raise TypeError(f"sanitize must be None, bool, 'on'/'off', a dict or "
                        f"a SanitizeConfig, got {type(spec).__name__}")
    return None if cfg.trivial else cfg
