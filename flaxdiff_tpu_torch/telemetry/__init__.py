"""Training health telemetry of the port (counterpart of the in-graph part of
``flaxdiff_tpu/telemetry``)."""
from .numerics import NumericsConfig, flatten_aux, numerics_aux

__all__ = ["NumericsConfig", "flatten_aux", "numerics_aux"]
