"""Structured resilience events (counterpart of
``flaxdiff_tpu/resilience/events.py``): one append-only, thread-safe log
that every recovery path flows through. Every event lands in an
`EventLog`, counted by (kind, site) and mirrored to the
``flaxdiff_tpu_torch.resilience`` stdlib logger. The serving layer records its faults, rebuilds and replica
losses here.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("flaxdiff_tpu_torch.resilience")

# Event kinds (open set — these are the ones the framework itself emits):
#   retry              an operation failed and will be re-attempted
#   retry_exhausted    an operation failed after its full retry budget
#   save_skipped       checkpoint step already exists; save was a no-op
#   save_failed        checkpoint save degraded to a warning (training on)
#   fallback_restore   latest checkpoint unreadable; walked back a step
#   rollback           abnormal loss; state rolled back to best state
#   watchdog_stall     heartbeat watchdog detected a stalled step/loader
#   starvation         data loader yielded a fallback (repeated) batch
#   fault_injected     a deterministic fault-plan site fired
#   preempt            SIGTERM received; checkpointing and exiting
#   commit             a checkpoint step passed the two-phase commit
#   commit_aborted     non-unanimous commit votes; step stays uncommitted
#   commit_skipped     coordination lost; save left uncommitted locally
#   consensus_restore  the world agreed on one restore step
#   barrier_timeout    a crash barrier missed its deadline (peer dead)
#   restored           fit resumed from a checkpoint at start
#   cold_start         restore_at_start found nothing; training fresh
#   warning            a requested safety feature could not be armed


@dataclasses.dataclass(frozen=True)
class ResilienceEvent:
    kind: str                      # e.g. "retry", "fallback_restore"
    site: str                      # e.g. "ckpt.save", "data.fetch"
    detail: str = ""
    step: Optional[int] = None     # train step, when known
    time: float = dataclasses.field(default_factory=time.time)

    def as_dict(self) -> Dict[str, object]:
        d = {"kind": self.kind, "site": self.site, "detail": self.detail,
             "time": self.time}
        if self.step is not None:
            d["step"] = self.step
        return d


class EventLog:
    """Thread-safe event sink with per-(kind, site) counters.

    `summary()` flattens counters into `resilience/<kind>.<site>` scalar
    metrics."""

    def __init__(self, name: str = "default", keep: int = 1000):
        self.name = name
        # RLock: a signal handler (SIGTERM preempt path) may record while
        # the main thread is mid-record — a plain Lock would self-deadlock.
        self._lock = threading.RLock()
        self._events: List[ResilienceEvent] = []
        self._counts: Dict[Tuple[str, str], int] = {}
        self._keep = keep
        self._dropped = 0

    def record(self, kind: str, site: str, detail: str = "",
               step: Optional[int] = None) -> ResilienceEvent:
        ev = ResilienceEvent(kind=kind, site=site, detail=detail, step=step)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._keep:
                # counters stay exact; only the event bodies are bounded
                self._events.pop(0)
                self._dropped += 1
            self._counts[(kind, site)] = self._counts.get((kind, site), 0) + 1
        log.warning("resilience[%s] %s@%s%s%s", self.name, kind, site,
                    f" step={step}" if step is not None else "",
                    f": {detail}" if detail else "")
        return ev

    # -- queries -------------------------------------------------------------
    def events(self, kind: Optional[str] = None,
               site: Optional[str] = None) -> List[ResilienceEvent]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if site is not None:
            evs = [e for e in evs if e.site == site]
        return evs

    def count(self, kind: Optional[str] = None,
              site: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for (k, s), n in self._counts.items()
                       if (kind is None or k == kind)
                       and (site is None or s == site))

    def summary(self) -> Dict[str, int]:
        """Flat `resilience/<kind>.<site>` -> count metrics dict."""
        with self._lock:
            return {f"resilience/{k}.{s}": n
                    for (k, s), n in sorted(self._counts.items())}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counts.clear()
            self._dropped = 0


# Process-global default log: layers with no plumbing (the serving
# scheduler's threads, the fault sites) record here. Tests swap it via
# `use_event_log`.
_GLOBAL = EventLog("global")
_global_lock = threading.Lock()


def global_event_log() -> EventLog:
    return _GLOBAL


def set_global_event_log(log_: EventLog) -> EventLog:
    """Replace the process-global log; returns the previous one."""
    global _GLOBAL
    with _global_lock:
        prev, _GLOBAL = _GLOBAL, log_
    return prev


class use_event_log:
    """Context manager: swap the global event log for a scope (tests)."""

    def __init__(self, log_: EventLog):
        self._log = log_
        self._prev: Optional[EventLog] = None

    def __enter__(self) -> EventLog:
        self._prev = set_global_event_log(self._log)
        return self._log

    def __exit__(self, *exc):
        assert self._prev is not None
        set_global_event_log(self._prev)
        return False


def record_event(kind: str, site: str, detail: str = "",
                 step: Optional[int] = None) -> ResilienceEvent:
    """Record on the process-global log."""
    return global_event_log().record(kind, site, detail=detail, step=step)
