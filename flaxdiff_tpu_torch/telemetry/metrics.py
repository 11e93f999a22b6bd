"""Host-side counters (counterpart of the ``Counter`` and the registry's
``counter(name)`` of ``flaxdiff_tpu/telemetry/metrics.py``). Gauges,
histograms, exporters and the series cap are ROADMAP.md A14."""
from __future__ import annotations

import threading
from typing import Dict


class Counter:
    """Monotone float counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Named counters, made on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(threading.Lock())
            return self._counters[name]
