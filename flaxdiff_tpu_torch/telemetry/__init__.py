"""Telemetry of the port (counterpart of parts of ``flaxdiff_tpu/telemetry``):
the hub with its counters, gauges and histograms, the trace recorder, the
serving request tracer, the online SLO engine, and the training-health aux
of the monitored step."""
from .hub import Telemetry, global_telemetry, set_global_telemetry, use_telemetry
from .metrics import DEFAULT_BUCKET_BOUNDS, Counter, Gauge, Histogram, MetricsRegistry
from .numerics import NumericsConfig, flatten_aux, numerics_aux
from .reqtrace import RequestTrace, RequestTracer
from .slo import SloConfig, SloEngine
from .tracing import TraceRecorder

__all__ = ["Counter", "DEFAULT_BUCKET_BOUNDS", "Gauge", "Histogram", "MetricsRegistry",
           "NumericsConfig", "RequestTrace", "RequestTracer", "SloConfig", "SloEngine",
           "Telemetry", "TraceRecorder", "flatten_aux", "global_telemetry", "numerics_aux",
           "set_global_telemetry", "use_telemetry"]
