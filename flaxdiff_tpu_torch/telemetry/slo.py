"""Online per-tenant SLO attainment and error-budget burn rates
(counterpart of ``flaxdiff_tpu/telemetry/slo.py``).

The front door feeds every terminal outcome here, from timestamps it
already takes, so brownout and routing act on error budgets while requests
still arrive:

- sliding-window attainment: per tenant, the fraction of requests in the
  last `window_s` seconds that completed within their objective
  (`SampleRequest.slo_ms`, else the engine's `target_ms`); shed, faulted
  and failed requests never attain;
- multi-window burn rate, `(1 - attainment) / (1 - objective)` over a fast
  and a slow window. A tenant is burning only when both windows agree, and
  exhausted when the fast window burns at `exhaust_factor` times the
  budget rate: the two-tier hint `BrownoutPolicy.tier_for` takes.

Gauges `slo/attainment/<tenant>`, `slo/burn_fast/<tenant>`,
`slo/burn_slow/<tenant>` and counters `slo/observed` / `slo/violations`.
Pure host arithmetic over deques; no device access.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Objective + window knobs for the online engine.

    target_ms: latency objective used when a request carries no
      `slo_ms` of its own.
    objective: attainment target; the error budget is
      `1 - objective` (0.99 -> 1% of requests may miss).
    fast_window_s / slow_window_s: the two burn-rate windows. The
      fast window reacts (seconds), the slow window confirms — a
      tenant must burn in BOTH to be degraded.
    burn_threshold: burn rate at/above which a window counts as
      burning (1.0 = spending budget exactly at the sustainable rate).
    exhaust_factor: fast-window burn multiple that marks the budget
      EXHAUSTED (tier-2 degradation hint).
    max_samples: per-tenant ring bound — oldest samples fall off first
      so a hot tenant cannot grow the engine without bound.
    """
    target_ms: float = 60_000.0
    objective: float = 0.99
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    burn_threshold: float = 1.0
    exhaust_factor: float = 4.0
    max_samples: int = 4096


class _TenantWindow:
    """One tenant's sample ring + running good/total counts per
    window, maintained incrementally (append + expire on observe)."""

    __slots__ = ("samples", "fast", "slow")

    def __init__(self, max_samples: int):
        # (at_s, ok) pairs, oldest first
        self.samples: Deque[Tuple[float, bool]] = deque(
            maxlen=max_samples)
        self.fast = [0, 0]          # [good, total] inside fast window
        self.slow = [0, 0]


class SloEngine:
    """Incremental per-tenant attainment/burn-rate accounting.

    Thread-safe: the front door's submit path and monitor thread both
    observe. All methods are cheap host bookkeeping; `observe` expires
    stale samples lazily (amortized O(1) per call).
    """

    def __init__(self, config: Optional[SloConfig] = None,
                 telemetry=None):
        self.config = config or SloConfig()
        if telemetry is None:
            from .hub import global_telemetry
            telemetry = global_telemetry()
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantWindow] = {}

    # -- recording ------------------------------------------------------------
    def observe(self, tenant: Optional[str], latency_ms: float,
                ok: bool = True, at_s: Optional[float] = None,
                target_ms: Optional[float] = None) -> bool:
        """Record one request outcome for `tenant` (None buckets under
        "default"). A request ATTAINS when it succeeded AND its latency
        met its objective. Returns the attained verdict."""
        c = self.config
        name = tenant or "default"
        at = time.perf_counter() if at_s is None else at_s
        attained = bool(ok) and latency_ms <= (
            c.target_ms if target_ms is None else target_ms)
        with self._lock:
            w = self._tenants.get(name)
            if w is None:
                w = self._tenants[name] = _TenantWindow(c.max_samples)
            if len(w.samples) == w.samples.maxlen:
                # ring full: the evicted sample leaves the slow window
                # (the fast counts are re-derived in _expire_locked)
                _, old_ok = w.samples[0]
                w.slow[1] -= 1
                if old_ok:
                    w.slow[0] -= 1
            w.samples.append((at, attained))
            w.slow[1] += 1
            if attained:
                w.slow[0] += 1
            self._expire_locked(w, at)
            fast_b = self._burn(w.fast)
            slow_b = self._burn(w.slow)
            att = (w.fast[0] / w.fast[1]) if w.fast[1] else 1.0
        tel = self.telemetry
        tel.counter("slo/observed").inc()
        if not attained:
            tel.counter("slo/violations").inc()
        tel.gauge(f"slo/attainment/{name}").set(att)
        tel.gauge(f"slo/burn_fast/{name}").set(fast_b)
        tel.gauge(f"slo/burn_slow/{name}").set(slow_b)
        return attained

    def _expire_locked(self, w: _TenantWindow, now: float) -> None:
        """Drop samples older than the slow window; re-derive the fast
        window counts from the survivors' tail (bounded by the deque)."""
        c = self.config
        while w.samples and now - w.samples[0][0] > c.slow_window_s:
            _, old_ok = w.samples.popleft()
            w.slow[1] -= 1
            if old_ok:
                w.slow[0] -= 1
        # fast window: recount the (short) suffix — samples are
        # time-ordered, so walk back from the newest
        good = total = 0
        for t, s_ok in reversed(w.samples):
            if now - t > c.fast_window_s:
                break
            total += 1
            if s_ok:
                good += 1
        w.fast[0], w.fast[1] = good, total

    def _burn(self, win) -> float:
        """Error-budget burn rate over one window's [good, total]."""
        good, total = win
        if total <= 0:
            return 0.0
        budget = max(1e-9, 1.0 - self.config.objective)
        return (1.0 - good / total) / budget

    # -- queries --------------------------------------------------------------
    def attainment(self, tenant: str,
                   now: Optional[float] = None) -> float:
        """Fast-window attainment for `tenant` (1.0 when unobserved)."""
        at = time.perf_counter() if now is None else now
        with self._lock:
            w = self._tenants.get(tenant)
            if w is None:
                return 1.0
            self._expire_locked(w, at)
            return (w.fast[0] / w.fast[1]) if w.fast[1] else 1.0

    def burn_rates(self, tenant: str,
                   now: Optional[float] = None) -> Tuple[float, float]:
        """(fast, slow) burn rates for `tenant` (0.0 when unobserved)."""
        at = time.perf_counter() if now is None else now
        with self._lock:
            w = self._tenants.get(tenant)
            if w is None:
                return (0.0, 0.0)
            self._expire_locked(w, at)
            return (self._burn(w.fast), self._burn(w.slow))

    def tier_hint(self, tenant: Optional[str],
                  now: Optional[float] = None) -> int:
        """Degradation hint for `BrownoutPolicy.tier_for`:
        0 = inside budget, 1 = burning (both windows over threshold),
        2 = exhausted (fast window at `exhaust_factor`x budget rate)."""
        if tenant is None:
            return 0
        fast, slow = self.burn_rates(tenant, now)
        c = self.config
        if fast >= c.burn_threshold and slow >= c.burn_threshold:
            return 2 if fast >= c.exhaust_factor * c.burn_threshold \
                else 1
        return 0

    def any_burning(self, now: Optional[float] = None) -> bool:
        """True when at least one tenant is over budget — the signal
        that lets a pressure-driven brownout SHIELD the tenants that
        are not (they are not the cause)."""
        with self._lock:
            names = list(self._tenants)
        return any(self.tier_hint(n, now) > 0 for n in names)

    def snapshot(self, now: Optional[float] = None
                 ) -> Dict[str, Dict[str, float]]:
        """Per-tenant {attainment, burn_fast, burn_slow, samples} —
        the flight-recorder / diagnose view of the engine's state."""
        at = time.perf_counter() if now is None else now
        with self._lock:
            names = sorted(self._tenants)
        out: Dict[str, Dict[str, float]] = {}
        for n in names:
            fast, slow = self.burn_rates(n, at)
            with self._lock:
                w = self._tenants.get(n)
                count = len(w.samples) if w is not None else 0
            out[n] = {"attainment": round(self.attainment(n, at), 6),
                      "burn_fast": round(fast, 6),
                      "burn_slow": round(slow, 6),
                      "samples": count}
        return out
