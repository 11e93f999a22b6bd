"""Fault flight recorder (counterpart of
``flaxdiff_tpu/telemetry/flightrec.py``): bounded rings of recent
telemetry, dumped as one correlated `incident-<id>.json` bundle when an
incident is declared.

Post-mortems on the replicated serving path previously meant joining
five streams by hand: `telemetry.jsonl` rows, resilience events,
metric snapshots, the goodput ledger, and the Chrome trace. This
module keeps the last `window_s` seconds of all of them in memory and,
at the moment something goes wrong, freezes one cross-referenced
bundle next to the telemetry files:

- **rings**: every `Telemetry.write_record` row (request traces,
  tenant SLO rows, health timelines, quarantine entries, ...), every
  resilience event (via `EventLog.subscribe`), and every registry
  export snapshot, each stamped with the recorder clock at arrival.
- **incidents**: a declared incident (replica death, engine rebuild,
  pool exhaustion, quarantine spike, elastic transition, quorum
  eviction — see `EVENT_INCIDENTS`) dumps the window: rows + events
  (the operational ledger) + metric snapshots + a registry snapshot
  taken at declaration, with `trace_ids` and `steps` indices extracted
  from the rows so the bundle cross-references itself. Dumps are
  cooldown-limited per kind and capped at `max_incidents` per run —
  a fault storm degrades to counting, never to unbounded disk.

`scripts/diagnose_run.py` renders the bundles as an "Incidents"
section. The port declares engine rebuilds (the scheduler's supervised
rebuild), replica deaths (the front door), pool exhaustion and
quarantine spikes (the scheduler's convictions).

Cost contract: pure host bookkeeping — dict/deque appends on the
paths that already construct the rows, one JSON file write per
declared incident. No device access.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

INCIDENT_PREFIX = "incident-"
BUNDLE_SCHEMA_VERSION = 1

# resilience event kind -> incident kind: the declared-incident
# taxonomy. Everything else lands in the ring only.
EVENT_INCIDENTS: Dict[str, str] = {
    "replica_lost": "replica_lost",
    "serving_rebuild": "engine_rebuild",
    "pool_exhausted": "pool_exhausted",
    "quorum_evicted": "quorum_eviction",
}

# telemetry row type -> incident kind (rows arrive via write_record)
_ROW_INCIDENTS: Dict[str, str] = {
    "elastic_transition": "elastic_transition",
}


def list_incidents(directory: str) -> List[str]:
    """Sorted incident bundle paths under `directory`."""
    return sorted(glob.glob(
        os.path.join(directory, INCIDENT_PREFIX + "*.json")))


class FlightRecorder:
    """Bounded in-memory rings + incident bundle dumps.

    Attach points (all optional — the recorder works with any subset):
    - `Telemetry` forwards `write_record` rows and `export` snapshots
      when the hub carries a recorder (`hub.flightrec`).
    - `attach_events(event_log)` subscribes to a resilience
      `EventLog`; `close()` unsubscribes.
    - `registry` (a MetricsRegistry) is snapshotted at declaration
      time so every bundle carries the counters as they stood.
    """

    def __init__(self, directory: str,
                 registry=None,
                 window_s: float = 30.0,
                 max_rows: int = 4096,
                 max_events: int = 1024,
                 max_snapshots: int = 64,
                 max_incidents: int = 16,
                 cooldown_s: float = 2.0,
                 quarantine_spike: int = 8,
                 clock=time.perf_counter):
        self.directory = directory
        self.registry = registry
        self.window_s = float(window_s)
        self.max_incidents = int(max_incidents)
        self.cooldown_s = float(cooldown_s)
        self.quarantine_spike = int(quarantine_spike)
        self._clock = clock
        self._lock = threading.Lock()
        self._rows: Deque[Dict[str, Any]] = deque(maxlen=max_rows)
        self._events: Deque[Dict[str, Any]] = deque(maxlen=max_events)
        self._snapshots: Deque[Dict[str, Any]] = deque(
            maxlen=max_snapshots)
        self._seq = 0
        self._suppressed = 0
        self._last_dump: Dict[str, float] = {}   # kind -> clock
        self._paths: List[str] = []
        self._event_log = None
        self._subscriber = None

    # -- feeds ----------------------------------------------------------------
    def record(self, row: Dict[str, Any]) -> None:
        """One telemetry JSONL row (called from the hub's
        write_record). Row-typed incidents declare themselves here."""
        now = self._clock()
        with self._lock:
            self._rows.append({"t_s": now, "row": dict(row)})
        kind = _ROW_INCIDENTS.get(str(row.get("type", "")))
        if kind is not None:
            self.incident(kind, detail=str(row.get("reason", "")),
                          at_s=now)

    def metrics(self, snapshot: Dict[str, Any],
                step: Optional[int] = None) -> None:
        """One registry export snapshot (called from the hub's
        export)."""
        with self._lock:
            self._snapshots.append({"t_s": self._clock(), "step": step,
                                    "metrics": dict(snapshot)})

    def attach_events(self, event_log) -> None:
        """Subscribe to a resilience `EventLog`: every event lands in
        the ring; the `EVENT_INCIDENTS` kinds (and quarantine spikes)
        declare incidents. Idempotent per recorder."""
        if self._subscriber is not None:
            return
        self._event_log = event_log
        self._subscriber = self._on_event
        event_log.subscribe(self._subscriber)

    def _on_event(self, ev) -> None:
        now = self._clock()
        with self._lock:
            self._events.append({"t_s": now, **ev.as_dict()})
        kind = EVENT_INCIDENTS.get(ev.kind)
        if kind is not None:
            self.incident(kind, detail=f"{ev.site}: {ev.detail}",
                          step=ev.step, at_s=now)
        elif ev.kind == "quarantine":
            # a single quarantined record is routine; a SPIKE inside
            # the window is an incident (bad shard / poisoned source)
            with self._lock:
                n = sum(1 for e in self._events
                        if e.get("kind") == "quarantine"
                        and now - e["t_s"] <= self.window_s)
            if n == self.quarantine_spike:
                self.incident("quarantine_spike",
                              detail=f"{n} quarantines in "
                                     f"{self.window_s:g}s", at_s=now)

    def close(self) -> None:
        if self._event_log is not None and self._subscriber is not None:
            self._event_log.unsubscribe(self._subscriber)
        self._event_log = self._subscriber = None

    # -- declaration ----------------------------------------------------------
    def incident(self, kind: str, detail: str = "",
                 step: Optional[int] = None,
                 at_s: Optional[float] = None) -> Optional[str]:
        """Declare one incident: dump the last `window_s` seconds of
        every ring as `incident-<seq>-<kind>.json` in `directory`.
        Returns the bundle path, or None when suppressed (per-kind
        cooldown or the run's `max_incidents` cap — suppressions are
        counted in the next bundle's `suppressed` field)."""
        now = self._clock() if at_s is None else at_s
        with self._lock:
            last = self._last_dump.get(kind)
            if (self._seq >= self.max_incidents
                    or (last is not None
                        and now - last < self.cooldown_s)):
                self._suppressed += 1
                return None
            self._last_dump[kind] = now
            self._seq += 1
            seq = self._seq
            lo = now - self.window_s
            rows = [r for r in self._rows if r["t_s"] >= lo]
            events = [e for e in self._events if e["t_s"] >= lo]
            snaps = [s for s in self._snapshots if s["t_s"] >= lo]
            suppressed, self._suppressed = self._suppressed, 0
        if self.registry is not None:
            self.registry.counter("telemetry/incidents").inc()
            if suppressed:
                self.registry.counter(
                    "telemetry/incidents_suppressed").inc(suppressed)
        trace_ids = sorted({str(r["row"]["trace_id"]) for r in rows
                            if "trace_id" in r["row"]})
        payloads = [r["row"] for r in rows] + list(events)
        steps = sorted({int(p["step"]) for p in payloads
                        if p.get("step") is not None})
        bundle: Dict[str, Any] = {
            "schema_version": BUNDLE_SCHEMA_VERSION,
            "incident_id": f"{seq:03d}-{kind}",
            "kind": kind,
            "detail": detail,
            "t_s": round(now, 6),
            "window_s": self.window_s,
            "step": step,
            "suppressed_since_last": suppressed,
            "trace_ids": trace_ids,
            "steps": steps,
            "records": rows,
            "ledger": events,
            "metric_snapshots": snaps,
            "metrics": (dict(self.registry.snapshot())
                        if self.registry is not None else {}),
        }
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(
            self.directory, f"{INCIDENT_PREFIX}{seq:03d}-{kind}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, sort_keys=True, default=str)
        os.replace(tmp, path)
        with self._lock:
            self._paths.append(path)
        return path

    # -- queries --------------------------------------------------------------
    @property
    def incidents(self) -> List[str]:
        with self._lock:
            return list(self._paths)
