"""The telemetry hub (counterpart of ``Telemetry`` in
``flaxdiff_tpu/telemetry/hub.py``): the metrics registry, an optional trace
recorder and the raw typed records (request traces, front-door health
rows, tenant SLO rows).

``Telemetry()`` is the disabled hub: counters, gauges and histograms still
record, but there is no recorder, so the request tracer is a no-op, and
`write_record` keeps nothing. ``Telemetry(recorder=TraceRecorder(...))``
enables both; with `jsonl_path` every record is also appended to that file.
The process-global hub is a disabled one that layers without plumbing
(the inference pipeline's cache accounting, the serving engine by default)
count on; tests swap it with `use_telemetry`. The exporters, the goodput
ledger and the cross-host aggregator are ROADMAP.md A14.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import TraceRecorder


# raw records an enabled hub keeps in memory, the newest last
MAX_RECORDS = 100_000


class Telemetry:
    def __init__(self, recorder: Optional[TraceRecorder] = None,
                 enabled: Optional[bool] = None, jsonl_path: Optional[str] = None):
        self.registry = MetricsRegistry()
        self.recorder = recorder
        if recorder is not None:
            recorder.set_on_drop(
                lambda n: self.registry.counter("telemetry/trace_dropped_events").inc(n))
        self.jsonl_path = jsonl_path
        self.enabled = bool(enabled) if enabled is not None else bool(recorder or jsonl_path)
        self._records: Deque[Dict[str, object]] = deque(maxlen=MAX_RECORDS)
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self.registry.histogram(name, **kwargs)

    def write_record(self, record: Dict[str, object]) -> None:
        """One raw typed record: kept in memory (bounded) and appended to
        `jsonl_path` on an enabled hub; dropped on the disabled one."""
        if not self.enabled:
            return
        rec = {"_time": time.time(), **record}
        with self._lock:
            self._records.append(rec)
            if self.jsonl_path is not None:
                with open(self.jsonl_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec) + "\n")

    def records(self, type: Optional[str] = None) -> List[Dict[str, object]]:
        with self._lock:
            recs = list(self._records)
        return [r for r in recs if type is None or r.get("type") == type]

    def flush(self) -> None:
        if self.recorder is not None and self.recorder.path is not None:
            self.recorder.save()


_GLOBAL = Telemetry(enabled=False)
_global_lock = threading.Lock()


def global_telemetry() -> Telemetry:
    return _GLOBAL


def set_global_telemetry(hub: Telemetry) -> Telemetry:
    """Replace the process-global hub; returns the previous one."""
    global _GLOBAL
    with _global_lock:
        prev, _GLOBAL = _GLOBAL, hub
    return prev


class use_telemetry:
    """Context manager: swap the global hub for a scope (tests)."""

    def __init__(self, hub: Telemetry):
        self._hub = hub
        self._prev: Optional[Telemetry] = None

    def __enter__(self) -> Telemetry:
        self._prev = set_global_telemetry(self._hub)
        return self._hub

    def __exit__(self, *exc):
        set_global_telemetry(self._prev)
        return False
