"""Replica: one health-tracked `ServingScheduler` + `EngineSupervisor`
unit inside a `ReplicaPool` (counterpart of
``flaxdiff_tpu/serving/replica.py``; docs/SERVING.md "Front door").

The supervisor makes a single scheduler survivable; this layer treats the
WHOLE scheduler as the unit of failure. A `Replica` wraps one scheduler and
derives a four-state health signal the front door routes on:

    HEALTHY     supervisor SERVING, fault-rate EWMA low, queue shallow
    DEGRADED    fault-rate EWMA above threshold, or queue pressure
                beyond the degraded fraction of max_queue — routable,
                but only when no HEALTHY replica is
    REBUILDING  supervisor mid DRAINING/REBUILDING (device loss is
                being repaired) — routable as a last resort; submits
                queue and serve once the rebuild lands
    DEAD        scheduler closed (explicitly, by a thread-death sweep,
                or by `kill()` — the `serving.replica_lost` chaos
                site). Never routed; the door fails its in-flight
                requests over to survivors.

Everything here is host-side bookkeeping: no torch, no device work.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ..resilience.events import record_event
from .supervision import SERVING as _SUP_SERVING

# health states, ordered by routing preference (lower routes first);
# exported as the `frontdoor/replica_health/<replica>` gauge values
HEALTHY, DEGRADED, REBUILDING, DEAD = ("healthy", "degraded",
                                       "rebuilding", "dead")
HEALTH_RANK = {HEALTHY: 0, DEGRADED: 1, REBUILDING: 2, DEAD: 3}


@dataclasses.dataclass(frozen=True)
class ReplicaHealthConfig:
    """Thresholds for the DEGRADED derivation.

    ewma_alpha: weight of the newest outcome in the fault-rate EWMA
      (outcome stream: 1.0 per terminal fault / failover the door
      observed on this replica, 0.0 per completed result).
    ewma_degraded: EWMA at or above this marks the replica DEGRADED.
    queue_degraded_frac: queued fraction of the scheduler's max_queue
      at or above which the replica is DEGRADED (back-pressure routing
      kicks in well before the replica itself starts shedding).
    """
    ewma_alpha: float = 0.25
    ewma_degraded: float = 0.5
    queue_degraded_frac: float = 0.75


class Replica:
    """One named scheduler behind the front door.

    The replica does not own a thread: health is derived on read from
    supervisor state + the outcome EWMA + queue depth, all host-side
    accessors. `kill()` is the replica-loss path (chaos or operator):
    it marks the replica DEAD immediately — routing skips it from that
    instant — and closes the scheduler non-draining in the background
    so in-flight futures resolve (`SchedulerClosed`) and the door can
    fail them over without waiting for the close to finish joining.
    """

    def __init__(self, name: str, scheduler,
                 config: Optional[ReplicaHealthConfig] = None):
        self.name = name
        self.scheduler = scheduler
        self.config = config or ReplicaHealthConfig()
        self._lock = threading.Lock()
        self._ewma = 0.0
        self._dead = False
        self._kill_thread: Optional[threading.Thread] = None

    # -- health ---------------------------------------------------------------
    def note_outcome(self, ok: bool) -> None:
        """Feed one observed terminal outcome (door-side) into the
        fault-rate EWMA: False for a fault/failover attributed to this
        replica, True for a delivered result."""
        a = self.config.ewma_alpha
        with self._lock:
            self._ewma = a * (0.0 if ok else 1.0) + (1 - a) * self._ewma

    def fault_rate(self) -> float:
        with self._lock:
            return self._ewma

    def health(self) -> str:
        if self._dead or self.scheduler.closed:
            return DEAD
        if self.scheduler.supervisor.state != _SUP_SERVING:
            return REBUILDING
        if self.fault_rate() >= self.config.ewma_degraded:
            return DEGRADED
        max_q = max(1, self.scheduler.config.max_queue)
        if self.scheduler.queue_depth() \
                >= self.config.queue_degraded_frac * max_q:
            return DEGRADED
        return HEALTHY

    def load(self) -> int:
        """Requests this replica is responsible for right now (the
        least-loaded routing key). DEAD replicas report 0 — they are
        never routed anyway."""
        if self._dead or self.scheduler.closed:
            return 0
        return self.scheduler.load()

    # -- lifecycle ------------------------------------------------------------
    def submit(self, req, trace_ctx=None):
        return self.scheduler.submit(req, trace_ctx=trace_ctx)

    def prewarm(self, reqs):
        return self.scheduler.prewarm(reqs)

    def cancel(self, fut) -> bool:
        return self.scheduler.cancel(fut)

    def kill(self, cause: str = "replica_lost",
             timeout: float = 10.0) -> None:
        """Replica-level failure: DEAD now, scheduler closed
        (non-draining) in the background. Idempotent. In-flight
        futures on the dying scheduler resolve with `SchedulerClosed`
        (or a completed result the completion thread already had in
        hand — first set wins), which is the front door's failover
        trigger."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            record_event("replica_lost", "serving.replica_lost",
                         detail=f"replica {self.name}: {cause}")
            t = threading.Thread(
                target=lambda: self.scheduler.close(drain=False,
                                                    timeout=timeout),
                name=f"replica-kill-{self.name}", daemon=True)
            self._kill_thread = t
        t.start()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Orderly shutdown (drains by default). A killed replica just
        joins the background close."""
        with self._lock:
            kill = self._kill_thread
            self._dead = True
        if kill is not None:
            kill.join(timeout)
            return
        self.scheduler.close(drain=drain, timeout=timeout)
