"""Telemetry of the port (counterpart of ``flaxdiff_tpu/telemetry``): the hub
with its counters, gauges and histograms and its exporters (JSONL,
Prometheus textfile, the trainer's logger), the step phase timer, the
goodput ledger, the cross-host aggregator, memory gauges, the program
evidence registry, device-profile windows, the flight recorder, the trace
recorder, the serving request tracer, the online SLO engine, and the
training-health aux of the monitored step."""
from .aggregate import AggregationDisabled, CrossHostAggregator
from .devprof import DEVPROF_FILENAME, DeviceProfiler, kernel_family, read_devprof
from .flightrec import FlightRecorder, list_incidents
from .goodput import GOODPUT_FILENAME, GoodputLedger
from .hub import Telemetry, global_telemetry, set_global_telemetry, use_telemetry
from .memory import MemoryMonitor
from .metrics import (DEFAULT_BUCKET_BOUNDS, Counter, Gauge, Histogram, JsonlExporter,
                      LoggerExporter, MetricsRegistry, PrometheusTextfileExporter)
from .numerics import NumericsConfig, flatten_aux, numerics_aux
from .phases import PHASES, StepPhaseTimer
from .programs import (PROGRAMS_FILENAME, ProgramRegistry, hardware_fingerprint,
                       read_registry, stable_json)
from .reqtrace import RequestTrace, RequestTracer
from .slo import SloConfig, SloEngine
from .tracing import TraceRecorder

__all__ = ["AggregationDisabled", "Counter", "CrossHostAggregator", "DEFAULT_BUCKET_BOUNDS",
           "DEVPROF_FILENAME", "DeviceProfiler", "FlightRecorder", "GOODPUT_FILENAME", "Gauge",
           "GoodputLedger", "Histogram", "JsonlExporter", "LoggerExporter", "MemoryMonitor",
           "MetricsRegistry", "NumericsConfig", "PHASES", "PROGRAMS_FILENAME",
           "ProgramRegistry", "PrometheusTextfileExporter", "RequestTrace", "RequestTracer",
           "SloConfig", "SloEngine", "StepPhaseTimer", "Telemetry", "TraceRecorder",
           "flatten_aux", "global_telemetry", "hardware_fingerprint", "kernel_family",
           "list_incidents", "numerics_aux", "read_devprof", "read_registry",
           "set_global_telemetry", "stable_json", "use_telemetry"]
