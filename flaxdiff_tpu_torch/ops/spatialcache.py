"""Spatial token cache: training-free token-level reuse for DiT sampling
(counterpart of ``flaxdiff_tpu/ops/spatialcache.py``; docs/CACHING.md).

The timestep cache (``ops/diffcache.py``) reuses the deep trunk's residual
delta across steps; this adds the space axis. On a cached step most tokens
barely change, so only the highest-change tokens re-enter the deep trunk. A
`SpatialPlan` composes with a `CachePlan` into one static `ComposedPlan`
whose per-step behaviour is a host-side code row:

    code 2  refresh  the deep trunk on every token; taps and the score
                     reference recorded again
    code 1  spatial  the shallow blocks on every token; the k tokens whose
                     shallow activations changed most since their entry was
                     refreshed run the deep trunk, their taps and reference
                     entries are written back, every other token reuses
    code 0  reuse    pure timestep reuse

k = round(keep_fraction * L) is a host integer; the selection stays on the
device. Model support is two more ``cache_mode`` values:

    model(..., cache_mode="record_ref", cache_split=k) -> (out, taps, ref)
    model(..., cache_mode="spatial", cache_split=k, cache_taps=taps,
          cache_ref=ref, cache_keep=f, cache_metric=m) -> (out, taps, ref)

Selection is batch-shared (scores averaged over the batch): one index vector
serves the whole call, so under CFG both halves refresh the same tokens, and
the RoPE tables gather to the selected positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .diffcache import CachePlan, active_plan, resolve_cache_fns

# per-step codes of the host schedule, in the order the sampler branches
CODE_REUSE = 0
CODE_SPATIAL = 1
CODE_REFRESH = 2

METRICS = ("l2", "linf")


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """Static token-level reuse policy for the cached steps.

    keep_fraction  fraction of tokens that re-enter the deep trunk on a
                   spatial step (k = max(1, round(f * L))); 1.0 disables the
                   axis (`resolve_plan` routes it to the timestep cache).
    metric         per-token change score against the reference recorded at
                   the token's last refresh: "l2" (mean squared change over
                   channels) or "linf" (max absolute change).
    every          spatial cadence among the cached steps, counted from the
                   last full refresh: 1 every cached step, 2 every other
                   (the rest are pure timestep reuse), ...
    """

    enabled: bool = True
    keep_fraction: float = 0.25
    metric: str = "l2"
    every: int = 1

    def __post_init__(self):
        if not 0.0 < self.keep_fraction <= 1.0:
            raise ValueError("keep_fraction must be in (0, 1]")
        if self.metric not in METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; one of {METRICS}")
        if self.every < 1:
            raise ValueError("every must be >= 1")

    def key(self) -> Tuple:
        return ("spatialcache", self.enabled, self.keep_fraction, self.metric, self.every)


@dataclasses.dataclass(frozen=True)
class ComposedPlan:
    """One static plan over both axes: the `CachePlan` decides when the deep
    trunk fully refreshes, the `SpatialPlan` which tokens partially refresh
    in between. ``key()`` keeps two plans from sharing a sampler."""

    cache: CachePlan = dataclasses.field(default_factory=CachePlan)
    spatial: SpatialPlan = dataclasses.field(default_factory=SpatialPlan)

    def __post_init__(self):
        if not isinstance(self.cache, CachePlan):
            raise ValueError("ComposedPlan.cache must be a CachePlan")
        if not isinstance(self.spatial, SpatialPlan):
            raise ValueError("ComposedPlan.spatial must be a SpatialPlan")

    @property
    def enabled(self) -> bool:
        return self.cache.enabled

    @property
    def depth_fraction(self) -> float:
        return self.cache.depth_fraction

    def key(self) -> Tuple:
        return ("composed", self.cache.key(), self.spatial.key())

    def step_codes(self, num_steps: int) -> np.ndarray:
        """[num_steps] int32 of CODE_* values, on the host."""
        flags = self.cache.flags(num_steps)
        codes = np.zeros((num_steps,), np.int32)
        codes[flags] = CODE_REFRESH
        since = 0
        for i in range(num_steps):
            if flags[i]:
                since = 0
                continue
            since += 1
            if since % self.spatial.every == 0:
                codes[i] = CODE_SPATIAL
        return codes

    def counts(self, num_steps: int) -> dict:
        codes = self.step_codes(num_steps)
        return {"refresh": int((codes == CODE_REFRESH).sum()),
                "spatial": int((codes == CODE_SPATIAL).sum()),
                "reused": int((codes == CODE_REUSE).sum())}


# a request's default for composed caching: every other cached step between
# the sparse full refreshes re-runs the deep trunk on the top eighth of the
# tokens, the rest reuse
DEFAULT_SPATIAL_PLAN = SpatialPlan(keep_fraction=0.125, every=2)
DEFAULT_COMPOSED_PLAN = ComposedPlan(
    cache=CachePlan(refresh_every=16, depth_fraction=0.2, refresh_head=2, refresh_tail=1),
    spatial=DEFAULT_SPATIAL_PLAN)


def active_spatial(spatial: Optional[SpatialPlan]) -> Optional[SpatialPlan]:
    """None unless the spatial axis can skip something: keep 1.0 refreshes
    every token, which is the timestep cache's record step."""
    if spatial is None or not spatial.enabled or spatial.keep_fraction >= 1.0:
        return None
    return spatial


def resolve_plan(plan: Any) -> Union[None, CachePlan, ComposedPlan]:
    """Normalise any cache knob to the loop that serves it: None (uncached),
    a `CachePlan` (the timestep cache) or a `ComposedPlan` (both axes). A
    bare `SpatialPlan` composes with the default `CachePlan`. Degenerate axes
    fall off one at a time: spatial disabled or keep 1.0 drops to the
    timestep cache, ``refresh_every=1`` to the uncached loop."""
    if plan is None:
        return None
    if isinstance(plan, SpatialPlan):
        plan = ComposedPlan(spatial=plan)
    if isinstance(plan, ComposedPlan):
        base = active_plan(plan.cache)
        if base is None:
            return None
        spatial = active_spatial(plan.spatial)
        if spatial is None:
            return base
        if plan.cache is base and plan.spatial is spatial:
            return plan
        return ComposedPlan(cache=base, spatial=spatial)
    return active_plan(plan)


# --- selection on the device (shared by the three model families) ----------------

def token_change_scores(h: torch.Tensor, ref: torch.Tensor, metric: str) -> torch.Tensor:
    """[L] batch-shared change score of fresh trunk inputs `h` against the
    reference `ref` (both [B, L, C]). The difference is taken in the trunk's
    dtype and only then cast to f32, as JAX does: casting each operand first
    would pick other tokens in bf16."""
    d = (h - ref).float()
    if metric == "l2":
        per = (d * d).mean(dim=-1)
    elif metric == "linf":
        per = d.abs().amax(dim=-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return per.mean(dim=0)


def spatial_k(num_tokens: int, keep_fraction: float) -> int:
    """The top-k size, a host integer. Python's round: half to even."""
    return max(1, min(num_tokens, round(num_tokens * keep_fraction)))


def select_tokens(h: torch.Tensor, ref: torch.Tensor, keep_fraction: float,
                  metric: str) -> torch.Tensor:
    """[k] indices of the highest-change tokens, by descending score, the
    lower index first among equal scores: ``lax.top_k``'s order. The order
    is the order the deep trunk attends over; ``torch.topk`` promises none,
    a stable descending sort does. Tokens whose entries go stale gather
    change against their frozen reference, so each is selected in time."""
    scores = token_change_scores(h, ref, metric)
    k = spatial_k(h.shape[1], keep_fraction)
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, L, C] -> [B, k, C] with a shared [k] index vector."""
    return x.index_select(1, idx)


def scatter_tokens(full: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A new [B, L, C] tensor: `full` with `values` [B, k, C] at token
    positions `idx`. Out of place: the caller, or an earlier call of the same
    multi-evaluation step, still holds `full`."""
    return full.index_copy(1, idx, values.to(full.dtype))


def gather_freqs(freqs: Optional[Tuple[torch.Tensor, torch.Tensor]], idx: torch.Tensor
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The RoPE (cos, sin) rows of the selected positions, so attention in
    the gathered trunk rotates each token by its true position. Without
    them the attention would build tables for positions 0..k-1."""
    if freqs is None:
        return None
    cos, sin = freqs
    return cos.index_select(0, idx), sin.index_select(0, idx)


# --- the model's closures ---------------------------------------------------------

class ComposedCacheFns(NamedTuple):
    """The model's ``cache_mode`` forwards closed over one ComposedPlan:

        record(x, t, cond) -> (raw, taps)
        reuse(x, t, cond, taps) -> raw
        record_ref(x, t, cond) -> (raw, taps, ref)
        spatial(x, t, cond, taps, ref) -> (raw, taps, ref)
    """
    record: Callable
    reuse: Callable
    record_ref: Callable
    spatial: Callable


def resolve_composed_fns(model: Any, plan: ComposedPlan) -> ComposedCacheFns:
    """Closures over the model's ``cache_mode`` forward for a composed plan.
    Raises ValueError as `diffcache.resolve_cache_fns` does."""
    record, reuse = resolve_cache_fns(model, plan.cache)
    split = model.cache_split_index(plan.cache.depth_fraction)
    keep, metric = plan.spatial.keep_fraction, plan.spatial.metric

    def record_ref(x, t, cond):
        return model(x, t, cond, cache_mode="record_ref", cache_split=split)

    def spatial(x, t, cond, taps, ref):
        return model(x, t, cond, cache_mode="spatial", cache_split=split, cache_taps=taps,
                     cache_ref=ref, cache_keep=keep, cache_metric=metric)

    return ComposedCacheFns(record=record, reuse=reuse, record_ref=record_ref, spatial=spatial)
