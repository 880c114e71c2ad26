"""Heterogeneous trainability tiers: per-client freeze plans, port of
``repro/core/plan.py``.

A :class:`TrainPlan` is a set of named **tiers** over the global
trainable tree ``y`` (what ``freeze_spec`` leaves trainable, the union of
everything any tier trains). Each tier adds an **additive** freeze spec
over ``y``: regexes naming the leaves that tier does not train. Tier 0 is
conventionally ``full`` (nothing extra frozen); higher tiers freeze
supersets and suit weaker devices.

Compiling a plan against ``y`` (:func:`compile_plan`) turns each tier into
a static sub-layout of the global :class:`~repro_torch.core.flat.FlatLayout`:
a 0/1 block mask plus a gather/scatter index map, since every leaf owns
whole blocks. A tier's delta is a contiguous ``(tier_size,)`` slice that
scatters into the global ``(K, size)`` aggregation buffer.

Aggregation: a client contributes zero delta and zero *weight* on the
blocks its tier froze,

    delta[j] = sum_i w_i m_{t(i)}[j] delta_i[j] / sum_i w_i m_{t(i)}[j],

and blocks nobody trained keep delta 0. Under DP the denominator stays
the fixed cohort / goal count, so clip norms and the noise calibration
do not change with tiering.

Communication: tier t uploads only its trainable blocks; the downlink is
the full trainable tree plus the seed for every tier (other tiers keep
training the blocks a tier froze, so their values cannot be regenerated).

A one-tier plan that freezes nothing extra is the single-spec system:
:func:`compile_plan` marks it ``trivial`` and every consumer routes it
through the untiered code.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import flat as flat_lib
from repro_torch.nn import basic

# device copies of the static index maps and masks, by (content, device):
# the engines index with them every round or lane step
_ON_DEVICE: Dict[Tuple[Any, ...], torch.Tensor] = {}


def _on(kind: str, arr: np.ndarray, dtype, device) -> torch.Tensor:
    dev = torch.device(device)
    key = (kind, arr.shape, arr.tobytes(), dtype, dev)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(arr, dtype=dtype, device=dev)
    return t


@dataclasses.dataclass(frozen=True)
class Tier:
    """One named trainability tier: ``freeze_spec`` regexes are ADDITIVE
    over the global trainable tree (paths the tier does not train)."""
    name: str
    freeze_spec: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "freeze_spec", tuple(self.freeze_spec))


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Ordered tiers, most capable first (tier 0 = fewest frozen leaves).

    Construct from a dict (``TrainPlan.of({"full": (), "lite": (r"^conv",)})``),
    a sequence of (name, spec) pairs, or ``Tier`` objects."""
    tiers: Tuple[Tier, ...]

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise ValueError("a TrainPlan needs at least one tier")
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")

    @classmethod
    def of(cls, spec: Union["TrainPlan", Dict[str, Sequence[str]],
                            Sequence]) -> "TrainPlan":
        if isinstance(spec, TrainPlan):
            return spec
        if isinstance(spec, dict):
            return cls(tuple(Tier(n, tuple(s)) for n, s in spec.items()))
        tiers = []
        for item in spec:
            if isinstance(item, Tier):
                tiers.append(item)
            else:
                name, fs = item
                tiers.append(Tier(name, tuple(fs)))
        return cls(tuple(tiers))

    @classmethod
    def single(cls, name: str = "full") -> "TrainPlan":
        """One tier, nothing extra frozen."""
        return cls((Tier(name, ()),))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    def __len__(self) -> int:
        return len(self.tiers)


@dataclasses.dataclass(frozen=True)
class TierSlice:
    """A tier compiled against the global FlatLayout: its leaf selection,
    block ids and sizes, all host statics."""
    name: str
    index: int
    freeze_spec: Tuple[str, ...]
    leaf_on: Tuple[bool, ...]     # per global-layout leaf: trained here?
    block_ids: np.ndarray         # (tier_blocks,) int32 global block ids
    size: int                     # tier_blocks * align (padded flat width)
    param_count: int              # true (unpadded) trainable params
    trainable_bytes: int          # true bytes: what the wire bills

    @property
    def num_blocks(self) -> int:
        return len(self.block_ids)


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """A TrainPlan bound to one trainable tree ``y`` on ``device``.

    ``layout`` is the global flat layout; ``tiers[t]`` the per-tier
    sub-layout. A ``trivial`` plan (one tier training every leaf) tells
    consumers to keep the untiered code path, bit for bit."""
    plan: TrainPlan
    layout: flat_lib.FlatLayout
    paths: Tuple[str, ...]        # leaf paths, layout order
    tiers: Tuple[TierSlice, ...]
    device: torch.device

    @property
    def trivial(self) -> bool:
        return len(self.tiers) == 1 and all(self.tiers[0].leaf_on)

    @property
    def names(self) -> Tuple[str, ...]:
        return self.plan.names

    def block_masks(self) -> np.ndarray:
        """(n_tiers, num_blocks) float32 stacked 0/1 block masks."""
        return np.stack([self.layout.block_mask(t.leaf_on)
                         for t in self.tiers])

    def block_masks_on(self, device) -> torch.Tensor:
        """:meth:`block_masks` as a float32 tensor on ``device``, copied
        there once and reused (the engines index it with each row's tier)."""
        return _on("bmask", self.block_masks(), torch.float32, device)

    def leaf_masks(self) -> List[Dict[str, Any]]:
        """Per-tier 0/1 leaf-mask trees over ``y``: 0-d float32 tensors on
        the plan's device (gradient masking in the mixed-tier sync
        engine)."""
        ones = _on("one", np.ones((), np.float32), torch.float32, self.device)
        zeros = _on("zero", np.zeros((), np.float32), torch.float32,
                    self.device)
        return [basic.unflatten_params(
            {p: ones if on else zeros for p, on in zip(self.paths, t.leaf_on)})
            for t in self.tiers]

    def split(self, y, tier: TierSlice):
        """(tier-trainable subtree, tier-extra-frozen subtree) of ``y``.
        Leaf order inside the subtree is the global layout's, so the
        subtree's own FlatLayout is the tier's contiguous block slice."""
        flat = dict(basic.flatten_params(y))
        train = {p: flat[p] for p, on in zip(self.paths, tier.leaf_on) if on}
        frozen = {p: flat[p] for p, on in zip(self.paths, tier.leaf_on)
                  if not on}
        return basic.unflatten_params(train), basic.unflatten_params(frozen)

    def block_ids_on(self, tier: TierSlice, device) -> torch.Tensor:
        """The tier's block ids as an int64 tensor on ``device``, cached."""
        return _on("ids", tier.block_ids, torch.long, device)

    def gather(self, vec: torch.Tensor, tier: TierSlice) -> torch.Tensor:
        """Global (size,) / (k, size) -> contiguous tier slice."""
        return flat_lib.gather_blocks(vec, self.block_ids_on(tier, vec.device),
                                      self.layout.align)

    def scatter(self, sub: torch.Tensor, tier: TierSlice) -> torch.Tensor:
        """Contiguous (tier_size,) / (k, tier_size) slice -> zero-filled
        global width."""
        return flat_lib.scatter_blocks(sub, self.block_ids_on(tier, sub.device),
                                       self.layout.num_blocks,
                                       self.layout.align)


def _tier_slice(plan: TrainPlan, layout: flat_lib.FlatLayout,
                paths: Sequence[str], index: int) -> TierSlice:
    tier = plan.tiers[index]
    leaf_on = tuple(not any(re.search(p, path) for p in tier.freeze_spec)
                    for path in paths)
    block_ids = layout.leaf_blocks(leaf_on)
    pcount = sum(n for n, on in zip(layout.sizes, leaf_on) if on)
    tbytes = sum(n * d.itemsize
                 for n, d, on in zip(layout.sizes, layout.dtypes, leaf_on)
                 if on)
    return TierSlice(name=tier.name, index=index,
                     freeze_spec=tier.freeze_spec, leaf_on=leaf_on,
                     block_ids=block_ids,
                     size=len(block_ids) * layout.align,
                     param_count=int(pcount), trainable_bytes=int(tbytes))


def compile_plan(plan, y) -> CompiledPlan:
    """Bind a plan (TrainPlan / dict / sequence) to the trainable tree.

    Every tier must train at least one leaf of a non-empty ``y``: a tier
    that freezes all of it would dispatch clients that upload nothing. (An
    empty ``y`` compiles to zero-size tiers, so analytic summaries still
    work.) The plan's device is that of ``y``'s leaves (the CPU for an
    empty tree)."""
    plan = TrainPlan.of(plan)
    layout = flat_lib.FlatLayout.of(y)
    paths = layout.paths
    leaves = basic.tree_leaves(y)
    device = leaves[0].device if leaves else torch.device("cpu")
    tiers = tuple(_tier_slice(plan, layout, paths, i)
                  for i in range(len(plan)))
    for t in tiers:
        if paths and not any(t.leaf_on):
            raise ValueError(f"tier {t.name!r} freezes every trainable "
                             "leaf — it would train nothing")
    return CompiledPlan(plan=plan, layout=layout, paths=paths, tiers=tiers,
                        device=device)
