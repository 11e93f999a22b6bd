"""Span recording in Chrome trace-event JSON (counterpart of the
``TraceRecorder`` of ``flaxdiff_tpu/telemetry/tracing.py``), reduced to
what the serving request tracer emits: complete events and instants at
explicit host timestamps, held in a bounded list and written atomically by
`save()` (Perfetto and ``chrome://tracing`` load the file)."""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class TraceRecorder:
    """Collects events on the `time.perf_counter` clock. Past `max_events`
    new events are counted in `dropped` instead of stored, and the drop
    callback (the hub wires it to `telemetry/trace_dropped_events`) is
    called outside the lock."""

    def __init__(self, path: Optional[str] = None, max_events: int = 100_000):
        self.path = path
        self.pid = 0
        self.max_events = max_events
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[Dict[str, object]] = [
            {"ph": "M", "name": "process_name", "pid": self.pid,
             "args": {"name": f"host {self.pid}"}}]
        self.dropped = 0
        self._on_drop = None

    def set_on_drop(self, fn) -> None:
        self._on_drop = fn

    def _emit(self, ev: Dict[str, object]) -> None:
        with self._lock:
            full = len(self._events) >= self.max_events
            if full:
                self.dropped += 1
            else:
                self._events.append(ev)
        if full and self._on_drop is not None:
            self._on_drop(1)

    def _tid(self, tid: Optional[int]) -> int:
        return int(tid) if tid is not None else threading.get_ident() % 1_000_000

    def event_at(self, name: str, start_s: float, end_s: float, cat: str = "run",
                 args: Optional[Dict[str, object]] = None, tid: Optional[int] = None) -> None:
        """A complete ("X") event from timestamps already taken on this
        recorder's clock: the request tracer takes them inline on the
        dispatch and completion threads and emits the spans after."""
        ev: Dict[str, object] = {"ph": "X", "name": name, "cat": cat, "pid": self.pid,
                                 "tid": self._tid(tid), "ts": (start_s - self._t0) * 1e6,
                                 "dur": max(0.0, end_s - start_s) * 1e6}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant_at(self, name: str, at_s: float, cat: str = "event",
                   args: Optional[Dict[str, object]] = None, tid: Optional[int] = None) -> None:
        ev: Dict[str, object] = {"ph": "i", "s": "p", "name": name, "cat": cat,
                                 "pid": self.pid, "tid": self._tid(tid),
                                 "ts": (at_s - self._t0) * 1e6}
        if args:
            ev["args"] = args
        self._emit(ev)

    def events(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._events)

    def save(self) -> str:
        """Atomic rewrite of the whole trace file; safe to call often."""
        if self.path is None:
            raise ValueError("this recorder has no path")
        events = self.events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self.dropped:
            doc["flaxdiff_dropped_events"] = self.dropped
        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        return self.path
