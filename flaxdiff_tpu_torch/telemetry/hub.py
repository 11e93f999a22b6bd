"""The process-global telemetry hub (counterpart of ``global_telemetry`` in
``flaxdiff_tpu/telemetry/hub.py``), reduced to its counters: layers without
plumbing, such as the inference pipeline's cache accounting, count here."""
from __future__ import annotations

from .metrics import Counter, MetricsRegistry


class Telemetry:
    def __init__(self):
        self.registry = MetricsRegistry()

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)


_GLOBAL = Telemetry()


def global_telemetry() -> Telemetry:
    return _GLOBAL
