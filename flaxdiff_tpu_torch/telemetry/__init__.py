"""Telemetry of the port (counterpart of parts of ``flaxdiff_tpu/telemetry``):
the training-health aux of the monitored step, and the process-global
hub's counters."""
from .hub import Telemetry, global_telemetry
from .metrics import Counter, MetricsRegistry
from .numerics import NumericsConfig, flatten_aux, numerics_aux

__all__ = ["Counter", "MetricsRegistry", "NumericsConfig", "Telemetry", "flatten_aux",
           "global_telemetry", "numerics_aux"]
