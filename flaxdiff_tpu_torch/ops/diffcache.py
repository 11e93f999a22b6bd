"""Training-free activation cache for DiT-family sampling (counterpart of
``flaxdiff_tpu/ops/diffcache.py``; docs/CACHING.md).

Adjacent sampler steps give highly redundant deep-block activations: the
deep trunk's residual contribution changes far more slowly than its input.
A `CachePlan` runs the shallow blocks every step and, on the steps it does
not refresh, replaces the deep trunk with the residual delta recorded at the
last refresh, re-centred on the fresh shallow activations:

    refresh step:   out = tail(deep(shallow(x)))
                    taps = deep(shallow(x)) - shallow(x)     (recorded)
    cached step:    out = tail(shallow(x) + taps)            (reused)

The plan is host-side and static: a frozen, hashable dataclass whose
per-step refresh schedule is a numpy bool row, read by the sampler's Python
loop to pick each step's forward (no device read-back). A model supports the
cache through its ``cache_mode`` forward contract (``models/dit.py``,
``models/uvit.py``, ``models/mmdit.py``):

    model(x, t, c, cache_mode="record", cache_split=k) -> (out, taps)
    model(x, t, c, cache_mode="reuse", cache_split=k, cache_taps=taps) -> out
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """Static per-trajectory refresh schedule and depth split.

    refresh_every   a full model evaluation every k-th step; the steps in
                    between reuse the cached deep delta. 1 refreshes every
                    step (the uncached program, see `active_plan`).
    depth_fraction  the fraction of the trunk that always runs; models map
                    it to a block split with ``cache_split_index``.
    refresh_head    the first N steps always refresh (step 0 always does:
                    the cache starts empty).
    refresh_tail    the last N steps always refresh.
    """

    enabled: bool = True
    refresh_every: int = 3
    depth_fraction: float = 0.2
    refresh_head: int = 2
    refresh_tail: int = 1

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError("refresh_every must be >= 1")
        if not 0.0 < self.depth_fraction < 1.0:
            raise ValueError("depth_fraction must be in (0, 1)")
        if self.refresh_head < 0 or self.refresh_tail < 0:
            raise ValueError("refresh_head/refresh_tail must be >= 0")

    def flags(self, num_steps: int) -> np.ndarray:
        """[num_steps] bool, True where the step evaluates the whole model.
        Step 0 is always True; a disabled plan refreshes everywhere."""
        if num_steps < 1:
            raise ValueError("num_steps must be >= 1")
        if not self.enabled:
            return np.ones((num_steps,), dtype=bool)
        idx = np.arange(num_steps)
        flags = (idx % self.refresh_every) == 0
        flags |= idx < max(1, self.refresh_head)
        if self.refresh_tail:
            flags |= idx >= num_steps - self.refresh_tail
        flags[0] = True
        return flags

    def key(self) -> Tuple:
        """Hashable identity for sampler caches: two plans never share one."""
        return ("diffcache", self.enabled, self.refresh_every, self.depth_fraction,
                self.refresh_head, self.refresh_tail)

    def reused_fraction(self, num_steps: int) -> float:
        """The fraction of the trajectory's steps served from the cache."""
        f = self.flags(num_steps)
        return float((~f).sum()) / float(num_steps)


# a request's default when it asks for caching without a plan
DEFAULT_CACHE_PLAN = CachePlan()


def active_plan(plan: Optional[CachePlan]) -> Optional[CachePlan]:
    """None unless the plan is present, enabled and can reuse something.
    ``refresh_every=1`` refreshes every step of any trajectory, so it routes
    to the plain uncached loop: bit-equal to no cache by construction."""
    if plan is None or not plan.enabled or plan.refresh_every == 1:
        return None
    return plan


def model_supports_cache(model: Any, plan: Optional[CachePlan] = None) -> bool:
    """True when the model has the ``cache_mode`` contract and can split at
    the plan's depth (a 1-layer DiT has no deep trunk to cache)."""
    if not hasattr(model, "cache_split_index"):
        return False
    frac = plan.depth_fraction if plan is not None else DEFAULT_CACHE_PLAN.depth_fraction
    try:
        model.cache_split_index(frac)
    except ValueError:
        return False
    return True


def resolve_cache_fns(model: Any, plan: CachePlan) -> Tuple[Callable, Callable]:
    """(record, reuse) closures over the model's ``cache_mode`` forward, for
    ``DiffusionSampler(cache_fns=...)``:

        record(x, t, cond) -> (raw, taps)
        reuse(x, t, cond, taps) -> raw

    The model holds its own weights. Raises ValueError when the model cannot
    honour the plan."""
    if not hasattr(model, "cache_split_index"):
        raise ValueError(
            f"{type(model).__name__} does not implement the cache_mode forward contract "
            f"(docs/CACHING.md); diffusion caching supports the DiT/UDiT/MM-DiT families")
    split = model.cache_split_index(plan.depth_fraction)

    def record(x, t, cond):
        return model(x, t, cond, cache_mode="record", cache_split=split)

    def reuse(x, t, cond, taps):
        return model(x, t, cond, cache_mode="reuse", cache_split=split, cache_taps=taps)

    return record, reuse
