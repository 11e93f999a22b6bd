"""Serving resilience: fault taxonomy, engine supervision/rebuild, and
brownout degradation (counterpart of ``flaxdiff_tpu/serving/supervision.py``;
docs/SERVING.md "Failure semantics").

- `classify` maps any exception out of a dispatch round or completion
  fetch onto the resilience layer's retryable/non-retryable taxonomy
  (`resilience.retry.default_classifier`), with one serving-specific
  class on top: **device_lost**, which no request-level retry can fix.
  On the card that is an injected `DeviceLost` or a sticky CUDA error
  (an illegal address, a launch failure, a device-side assert): such an
  error poisons the process's CUDA context, so the in-process rebuild
  that follows fails too, and the scheduler then fails every pending
  future with a typed `ServingFault` instead of looping.
  `torch.cuda.OutOfMemoryError` is transient: it goes through conviction
  and requeue like any other round error.
- `ServingFault` is the typed terminal failure a request's future
  carries instead of hanging: every queued or in-flight future always
  resolves (result, `DeadlineExceeded`, `SchedulerClosed`, or
  `ServingFault`).
- `EngineSupervisor` is the SERVING -> DRAINING -> REBUILDING ->
  SERVING state machine the scheduler drives on device loss: drain
  in-flight completions, drop the program cache with the dead engine,
  rebuild from the factory, re-run `prewarm` so rebuilt traffic pays no
  first-call cost, then requeue interrupted requests.
- `BrownoutPolicy` degrades before it sheds: under queue pressure or
  recent faults it caps NFE, forces the default cache plan, and
  shrinks batch buckets — the quality/latency knobs `SampleRequest`
  already carries — flagging every degraded result
  (`SampleResult.degraded`) and counting per-tier at
  `serving/brownout_*`.

Everything here is host-side bookkeeping: no device work, no syncs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

from ..resilience.events import record_event
from ..resilience.retry import default_classifier


class DeviceLost(RuntimeError):
    """The accelerator backing the engine is gone (or halted): raised
    by the `serving.device_lost` fault site, and what sticky CUDA
    errors classify to."""


class ServingFault(Exception):
    """Typed terminal failure for one request's future.

    kind:
        poisoned           convicted by a solo re-run after a batch
                           fault — the request itself breaks rounds
        retries_exhausted  innocent but the bounded retry budget ran out
        fetch_error        completion fetch failed after dispatch ended
        device_lost        device died and no engine_factory exists, or
                           the rebuild itself failed
        scheduler_died     the dispatch/completion thread crashed
        pool_exhausted     front door only (serving/frontdoor.py): the
                           cross-replica attempt budget ran out, or no
                           routable replica remains — raised even when
                           ALL replicas die, so pool futures are never
                           stranded
    """

    def __init__(self, msg: str, kind: str = "round_error",
                 request: Any = None, attempts: int = 0,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.kind = kind
        self.request = request
        self.attempts = attempts
        self.cause = cause


# substrings (lowercased) of the CUDA runtime's messages for the sticky
# errors: once one is raised the context is unusable until the process
# exits, so no retry (and no in-process rebuild) can serve again
_STICKY_CUDA_MARKS = ("illegal memory access", "illegal address",
                      "unspecified launch failure", "launch failure",
                      "device-side assert", "misaligned address",
                      "illegal instruction", "hardware stack error",
                      "uncorrectable ecc", "device lost", "device_lost",
                      "gpu has fallen off the bus", "invalid program counter")


def _is_sticky_cuda_error(exc: BaseException) -> bool:
    """A CUDA runtime error (torch raises `torch.AcceleratorError`, a
    RuntimeError, or a plain RuntimeError naming the CUDA error) whose
    message names a sticky error."""
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc).lower()
    cuda = type(exc).__name__ == "AcceleratorError" or "cuda" in msg
    return cuda and any(m in msg for m in _STICKY_CUDA_MARKS)


def classify(exc: BaseException) -> str:
    """Map a dispatch/fetch exception to "device_lost", "transient",
    or "fatal" (resilience/retry.py taxonomy). device_lost routes to
    the supervisor's rebuild path; everything else goes through
    evidence-based conviction + bounded requeue — the *classification*
    names the fault for telemetry/traces, the *probe* decides guilt."""
    if isinstance(exc, DeviceLost) or _is_sticky_cuda_error(exc):
        return "device_lost"
    return "transient" if default_classifier(exc) else "fatal"


# -- engine supervision ------------------------------------------------------

# supervisor states, exported as the `serving/supervisor_state` gauge
SERVING, DRAINING, REBUILDING = 0, 1, 2
STATE_NAMES = {SERVING: "serving", DRAINING: "draining",
               REBUILDING: "rebuilding"}


class EngineSupervisor:
    """SERVING -> DRAINING -> REBUILDING -> SERVING state machine for
    the scheduler's engine. The scheduler's dispatch thread drives the
    transitions (it is the thread that observes device loss); this
    object owns the state gauge, the rebuild counter/timing, and the
    rebuild itself (factory + prewarm replay)."""

    def __init__(self, telemetry):
        self.telemetry = telemetry
        self.state = SERVING
        self.rebuilds = 0

    def set_state(self, state: int) -> None:
        self.state = state
        self.telemetry.gauge("serving/supervisor_state").set(state)
        record_event("serving_supervisor", "serving.engine",
                     detail=STATE_NAMES[state])

    def rebuild(self, factory: Callable[[], Any],
                cause: BaseException,
                prewarm_args: Optional[tuple] = None) -> Any:
        """Build a replacement engine (REBUILDING state), re-running
        `prewarm` with the recorded traffic prototypes so the rebuilt
        program cache is warm before any requeued request is dispatched
        — rebuilt traffic builds no program (chaos-tested). Returns
        the new engine; the caller swaps it in and requeues."""
        self.set_state(REBUILDING)
        record_event("serving_rebuild", "serving.engine",
                     detail=f"rebuilding after {type(cause).__name__}: "
                            f"{cause}")
        t0 = time.perf_counter()
        engine = factory()
        if prewarm_args is not None and hasattr(engine, "prewarm"):
            protos, round_steps, buckets = prewarm_args
            if protos:
                engine.prewarm(protos, round_steps, buckets)
        self.rebuilds += 1
        self.telemetry.counter("serving/supervisor_rebuilds").inc()
        self.telemetry.gauge("serving/rebuild_ms").set(
            (time.perf_counter() - t0) * 1e3)
        self.set_state(SERVING)
        return engine


# -- brownout degradation ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Load/failure-aware degradation thresholds. Tiers are computed
    from queue pressure (fraction of `max_queue`) and recent faults,
    and each tier turns one more quality knob *before* any request is
    shed:

        tier 1 (queue >= queue_soft, or a fault in the last
                fault_cooldown_s): cap NFE at `nfe_cap`
        tier 2 (>= queue_heavy):    force `force_plan` onto plan-less
                                    requests (the default composed
                                    cache plan — cheaper compute)
        tier 3 (>= queue_critical): shrink rounds to the smallest
                                    batch bucket (bound blast radius)

    `force_plan="default"` resolves lazily to
    `ops.spatialcache.DEFAULT_COMPOSED_PLAN`; None never forces a
    plan. Degraded results carry `SampleResult.degraded` flags."""
    queue_soft: float = 0.5
    queue_heavy: float = 0.75
    queue_critical: float = 0.9
    nfe_cap: int = 32
    force_plan: Any = "default"
    fault_floor_tier: int = 1
    fault_cooldown_s: float = 5.0


class BrownoutPolicy:
    """Computes the current degradation tier and rewrites requests
    accordingly. Host arithmetic only; all decisions are deterministic
    given queue depth and the fault clock."""

    def __init__(self, config: BrownoutConfig, telemetry):
        self.config = config
        self.telemetry = telemetry
        self._fault_until = 0.0

    def note_fault(self, now: float) -> None:
        """A round/fetch fault or rebuild raises the tier floor to
        `fault_floor_tier` for `fault_cooldown_s` — degrade while the
        system is provably unhealthy, not only when the queue says so."""
        self._fault_until = max(self._fault_until,
                                now + self.config.fault_cooldown_s)

    def tier(self, queue_len: int, max_queue: int, now: float) -> int:
        c = self.config
        frac = queue_len / max(1, max_queue)
        t = 0
        if frac >= c.queue_soft:
            t = 1
        if frac >= c.queue_heavy:
            t = 2
        if frac >= c.queue_critical:
            t = 3
        if now < self._fault_until:
            t = max(t, c.fault_floor_tier)
        self.telemetry.gauge("serving/brownout_tier").set(t)
        return t

    def tier_for(self, tenant, queue_len: int, max_queue: int,
                 now: float, slo=None) -> int:
        """Per-tenant tier: the base `tier()` shaped by the tenant's
        error-budget burn (docs/SERVING.md "Burn-rate brownout").

        With no SLO engine or no tenant attribution this IS `tier()` —
        the pre-SLO behavior, bit for bit. Otherwise the engine's
        `tier_hint` escalates a burning tenant (it degrades first, up
        to its hint), while a healthy tenant is SHIELDED one tier when
        some other tenant is burning: the pressure that triggered the
        base tier is attributed to the noisy neighbor, so the healthy
        tenant should not pay full price for it. The fault floor is
        never shielded away — device faults degrade everyone."""
        base = self.tier(queue_len, max_queue, now)
        if slo is None or tenant is None:
            return base
        hint = slo.tier_hint(tenant, now=now)
        if hint > 0:
            return max(base, hint)
        if base > 0 and slo.any_burning(now=now):
            floor = (self.config.fault_floor_tier
                     if now < self._fault_until else 0)
            return max(base - 1, floor)
        return base

    def apply(self, req, tier: int) -> Tuple[Any, Tuple[str, ...]]:
        """Rewrite one request for `tier`; returns (effective request,
        degradation flags). Tier 0 returns the request untouched (the
        healthy path allocates nothing)."""
        if tier <= 0:
            return req, ()
        c = self.config
        changes = {}
        flags = []
        if c.nfe_cap and int(req.diffusion_steps) > c.nfe_cap:
            changes["diffusion_steps"] = c.nfe_cap
            flags.append("nfe_capped")
            self.telemetry.counter("serving/brownout_nfe_capped").inc()
        if tier >= 2 and req.cache_plan is None:
            plan = c.force_plan
            if plan == "default":
                from ..ops.spatialcache import DEFAULT_COMPOSED_PLAN
                plan = DEFAULT_COMPOSED_PLAN
            if plan is not None:
                changes["cache_plan"] = plan
                flags.append("plan_forced")
                self.telemetry.counter(
                    "serving/brownout_plan_forced").inc()
        if not changes:
            return req, ()
        self.telemetry.counter("serving/brownout_requests").inc()
        return dataclasses.replace(req, **changes), tuple(flags)
