"""The telemetry hub (counterpart of ``Telemetry`` in
``flaxdiff_tpu/telemetry/hub.py``): the metrics registry, the exporters,
the goodput ledger, the trace recorder, the cross-host aggregator, the
program evidence registry, the flight recorder and the device profiler's
sink, which the trainer, the CLI and the serving layer talk to.

Two modes share one API:

- **disabled** (``Telemetry()`` with no recorder, the process-global
  default): counters, gauges, histograms and an in-memory goodput account
  still work, but `enabled` is False, so the fit loop adds no host sync,
  writes no file and builds no profiler, the serving engine registers no
  program, and `write_record` keeps nothing.
- **enabled** (``Telemetry.create(directory, ...)``, the CLI's
  ``--telemetry_dir``): ``telemetry.jsonl`` (raw typed rows and metric
  snapshots), an optional Prometheus textfile and fan-out into the run's
  logger, ``trace.json`` (host spans), ``goodput.json`` (the account,
  cumulative across incarnations), ``programs.jsonl``, incident bundles and
  ``devprof.jsonl`` beside them; process p > 0 suffixes its files
  ``_p<p>``. ``Telemetry(recorder=TraceRecorder(...))`` is the lighter
  enabled hub the serving tests use. A hub with exporters streams its raw
  records through them and keeps none; one without keeps the newest
  ``MAX_RECORDS`` in memory for `records()`.

Layers without plumbing record on the process-global hub
(`global_telemetry()`); tests swap it with `use_telemetry`. The resilience
half of the JAX package's telemetry (watchdog, elastic worlds, coordinated
restarts) is ROADMAP.md A14's second half.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from .aggregate import CrossHostAggregator
from .devprof import DEVPROF_FILENAME
from .flightrec import FlightRecorder
from .goodput import GOODPUT_FILENAME, GoodputLedger
from .metrics import (Counter, Gauge, Histogram, JsonlExporter, LoggerExporter,
                      MetricsRegistry, PrometheusTextfileExporter)
from .phases import StepPhaseTimer
from .programs import PROGRAMS_FILENAME, ProgramRegistry
from .tracing import TraceRecorder

TELEMETRY_JSONL = "telemetry.jsonl"
TRACE_FILENAME = "trace.json"

# raw records an enabled hub with no exporter keeps in memory, the newest last
MAX_RECORDS = 100_000


class Telemetry:
    def __init__(self, recorder: Optional[TraceRecorder] = None,
                 enabled: Optional[bool] = None,
                 registry: Optional[MetricsRegistry] = None, exporters: List = (),
                 goodput: Optional[GoodputLedger] = None,
                 aggregator: Optional[CrossHostAggregator] = None,
                 programs: Optional[ProgramRegistry] = None,
                 flightrec: Optional[FlightRecorder] = None,
                 devprof_path: Optional[str] = None, epoch: Optional[int] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.recorder = recorder
        if recorder is not None:
            recorder.set_on_drop(
                lambda n: self.registry.counter("telemetry/trace_dropped_events").inc(n))
        self.exporters = list(exporters)
        self.goodput = goodput if goodput is not None else GoodputLedger()
        self.aggregator = aggregator
        # None on the disabled hub: program sites check and skip
        self.programs = programs
        self.flightrec = flightrec
        # the device profiler's sink; None keeps the profiler unbuilt
        self.devprof_path = devprof_path
        # every raw row carries this epoch (the goodput incarnation by
        # default), so rows of two lives of a run stay apart
        self.epoch = int(epoch) if epoch is not None else int(self.goodput.incarnation)
        self.enabled = bool(enabled) if enabled is not None \
            else bool(recorder or self.exporters)
        self._records: Optional[Deque[Dict[str, object]]] = \
            None if self.exporters else deque(maxlen=MAX_RECORDS)
        self._lock = threading.Lock()

    @classmethod
    def create(cls, directory: str, transport=None, prometheus_textfile: Optional[str] = None,
               logger=None, process_index: Optional[int] = None,
               device=None) -> "Telemetry":
        """A fully enabled hub rooted at `directory`. `transport`
        (``resilience.coordination``): cross-host aggregation; its process
        index names the files. `device`: the program registry's
        fingerprint (default: CUDA when present)."""
        pid = process_index
        if pid is None:
            pid = transport.process_index if transport is not None else 0
        os.makedirs(directory, exist_ok=True)
        suffix = "" if pid == 0 else f"_p{pid}"

        def in_dir(name: str) -> str:
            stem, ext = os.path.splitext(name)
            return os.path.join(directory, stem + suffix + ext)

        exporters: List = [JsonlExporter(in_dir(TELEMETRY_JSONL))]
        if prometheus_textfile:
            exporters.append(PrometheusTextfileExporter(prometheus_textfile))
        if logger is not None:
            exporters.append(LoggerExporter(logger))
        registry = MetricsRegistry()
        flightrec = FlightRecorder(directory, registry=registry)
        from ..resilience.events import global_event_log
        flightrec.attach_events(global_event_log())
        return cls(recorder=TraceRecorder(in_dir(TRACE_FILENAME)), registry=registry,
                   exporters=exporters,
                   goodput=GoodputLedger(os.path.join(directory, GOODPUT_FILENAME),
                                         process_index=pid),
                   aggregator=CrossHostAggregator(transport) if transport is not None else None,
                   programs=ProgramRegistry(in_dir(PROGRAMS_FILENAME), registry=registry,
                                            device=device),
                   flightrec=flightrec, devprof_path=in_dir(DEVPROF_FILENAME), enabled=True)

    # -- instruments ---------------------------------------------------------

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self.registry.histogram(name, **kwargs)

    def step_timer(self, mfu_meter=None, sample_every: int = 1) -> StepPhaseTimer:
        return StepPhaseTimer(registry=self.registry, mfu_meter=mfu_meter,
                              sample_every=sample_every)

    # -- tracing -------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "run", args: Optional[Dict[str, object]] = None):
        """A host span in ``trace.json`` (nothing without a recorder)."""
        if self.recorder is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.recorder.event_at(name, t0, time.perf_counter(), cat=cat, args=args)

    def instant(self, name: str, cat: str = "event",
                args: Optional[Dict[str, object]] = None) -> None:
        if self.recorder is not None:
            self.recorder.instant_at(name, time.perf_counter(), cat=cat, args=args)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    # -- records and export --------------------------------------------------

    def write_record(self, record: Dict[str, object]) -> None:
        """One raw typed record, stamped with the epoch: into the flight
        recorder's ring and every exporter, or kept in memory (bounded) by
        an enabled hub that has no exporter; dropped on the disabled one."""
        if not self.enabled:
            return
        if "epoch" not in record:
            record = {**record, "epoch": self.epoch}
        if self.flightrec is not None:
            self.flightrec.record(record)
        for ex in self.exporters:
            ex.write(record)
        if self._records is not None:
            rec = {"_time": time.time(), **record}
            with self._lock:
                self._records.append(rec)

    def records(self, type: Optional[str] = None) -> List[Dict[str, object]]:
        """The records kept in memory (a hub with no exporter)."""
        if self._records is None:
            raise RuntimeError("this hub streams its records through its exporters "
                               "(telemetry.jsonl) and keeps none in memory")
        with self._lock:
            recs = list(self._records)
        return [r for r in recs if type is None or r.get("type") == type]

    def record_step(self, phases: Dict[str, float]) -> None:
        """One phase row (a step, or a sampled window) into the stream."""
        rec = {"type": "step_phases", "step": int(phases.get("step", -1))}
        rec.update({k: v for k, v in phases.items() if k != "step"})
        self.write_record(rec)

    def record_numerics(self, flat_aux: Dict[str, float], step: Optional[int] = None) -> None:
        """One training-health row; the global series also into gauges."""
        rec: Dict[str, object] = {"type": "numerics"}
        if step is not None:
            rec["step"] = int(step)
        rec.update(flat_aux)
        self.write_record(rec)
        for name, v in flat_aux.items():
            if not name.startswith("numerics/module/"):
                self.registry.gauge(name).set(v)

    def export(self, step: Optional[int] = None,
               extra: Optional[Dict[str, float]] = None) -> None:
        """The registry's and the goodput account's snapshot through every
        exporter (and into the flight recorder's ring)."""
        snap = self.registry.snapshot()
        snap.update(self.goodput.snapshot())
        if extra:
            snap.update(extra)
        snap.setdefault("epoch", float(self.epoch))
        if self.flightrec is not None:
            self.flightrec.metrics(snap, step=step)
        for ex in self.exporters:
            ex.export(snap, step=step)

    def _goodput_contribution(self) -> Dict[str, float]:
        prod, bad = self.goodput.raw_counters()
        out = {"goodput/productive_s": prod}
        for bucket, v in bad.items():
            out[f"goodput/badput/{bucket}_s"] = v
        total = prod + sum(bad.values())
        if total > 0:
            out["goodput/fraction"] = prod / total
        return out

    def aggregate(self, metrics: Dict[str, float],
                  step: Optional[int] = None) -> Optional[Dict[str, Dict[str, float]]]:
        """Cross-host reduction of this host's metrics and goodput counters;
        rank 0 writes a ``pod_metrics`` row and mirrors it into gauges. A
        failed round disables aggregation and records a ``telemetry_lost``
        resilience event: metrics never kill a run."""
        if self.aggregator is None:
            return None
        contribution = dict(metrics)
        contribution.update(self._goodput_contribution())
        try:
            stats = self.aggregator.aggregate(contribution)
        except Exception as e:  # noqa: BLE001 — degrade, never die
            from ..resilience.events import record_event
            record_event("telemetry_lost", "telemetry.aggregate",
                         detail=f"{type(e).__name__}: {e}", step=step)
            return None
        if stats is None:
            return None
        if self.aggregator.process_index == 0:
            flat = CrossHostAggregator.flatten(stats)
            rec: Dict[str, object] = {"type": "pod_metrics", "world": self.aggregator.world_size}
            if step is not None:
                rec["step"] = int(step)
            rec.update(flat)
            self.write_record(rec)
            for name, v in flat.items():
                self.registry.gauge(name).set(v)
        return stats

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        if self.recorder is not None and self.recorder.path is not None:
            self.recorder.save()
        self.goodput.persist()

    def close(self) -> None:
        self.flush()
        if self.flightrec is not None:
            self.flightrec.close()
        for ex in self.exporters:
            ex.close()


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
