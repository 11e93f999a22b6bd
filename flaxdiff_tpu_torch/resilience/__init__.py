"""Resilience of the port (counterpart of parts of
``flaxdiff_tpu/resilience``): the structured event log, the retry policy
and deterministic fault injection, which the serving subsystem uses.

  events   `EventLog` and `record_event`: every fault, rebuild and replica
           loss, counted by (kind, site)
  faults   seedable `FaultPlan` arming named sites (serving.round,
           serving.fetch, serving.device_lost, serving.replica_lost)
  retry    `RetryPolicy`: the requeue budget and its backoff schedule;
           `default_classifier`: retryable or not

The checkpoint verifier, the watchdog and multi-host coordination are
training-side and not ported (ROADMAP.md).
"""
from .events import (EventLog, ResilienceEvent, global_event_log, record_event,
                     set_global_event_log, use_event_log)
from .faults import (FaultPlan, FaultSpec, InjectedFault, InjectedHTTPError, active_plan,
                     check, install_plan, maybe_stall)
from .retry import RetryPolicy, default_classifier

__all__ = ["EventLog", "FaultPlan", "FaultSpec", "InjectedFault", "InjectedHTTPError",
           "ResilienceEvent", "RetryPolicy", "active_plan", "check",
           "default_classifier", "global_event_log", "install_plan", "maybe_stall",
           "record_event", "set_global_event_log", "use_event_log"]
