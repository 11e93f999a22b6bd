"""Bounded-memory host metrics (counterpart of
``flaxdiff_tpu/telemetry/metrics.py``): counters, gauges, streaming
histograms over fixed bucket bounds, and the registry with its series cap.

Histograms hold one count per fixed bucket, never raw samples; past
`max_series` distinct names the registry hands out a shared no-op
instrument and counts the loss in `telemetry/dropped_series`. Recording is
a lock and a float add. The exporters (JSONL, Prometheus, the trainer's
loggers) are ROADMAP.md A14.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Tuple

# Seconds-scale latency bounds. The last implicit bucket is +inf.
DEFAULT_BUCKET_BOUNDS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


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


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Streaming histogram over FIXED bucket bounds — O(buckets) memory
    forever. Percentiles are estimated by linear interpolation inside
    the bucket containing the target rank (clamped to the observed
    min/max so a wide final bucket cannot invent outliers)."""

    __slots__ = ("_lock", "bounds", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, lock: threading.Lock,
                 bounds: Sequence[float] = DEFAULT_BUCKET_BOUNDS):
        self._lock = lock
        self.bounds = tuple(sorted(float(b) for b in bounds))
        self._counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for i, b in enumerate(self.bounds):
                if v <= b:
                    break
            else:
                i = len(self.bounds)
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1])."""
        with self._lock:
            if self._count == 0:
                return None
            rank = q * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                lo = self.bounds[i - 1] if i > 0 else min(self._min, 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                if cum + c >= rank:
                    frac = (rank - cum) / c
                    est = lo + frac * (hi - lo)
                    return float(min(max(est, self._min), self._max))
                cum += c
            return float(self._max)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            mean = self._sum / self._count
            mn, mx = self._min, self._max
            cnt, total = self._count, self._sum
        return {"count": cnt, "sum": total, "mean": mean,
                "min": mn, "max": mx,
                "p50": self.percentile(0.5), "p99": self.percentile(0.99)}


class _NullInstrument:
    """Accepts every instrument operation and records nothing — handed
    out past the series cap so callers never branch."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0
    count = 0

    def snapshot(self) -> Dict[str, float]:
        return {}

    def percentile(self, q: float) -> Optional[float]:
        return None


_NULL = _NullInstrument()


class MetricsRegistry:
    """Name -> instrument map with a hard series cap.

    `counter/gauge/histogram` create-or-get; asking for an existing
    name with a different type raises (silent type confusion would
    corrupt every later export). Past `max_series`, new names share a
    no-op instrument and `telemetry/dropped_series` counts the loss.
    """

    def __init__(self, max_series: int = 1024):
        self._lock = threading.Lock()
        self.max_series = max_series
        self._instruments: Dict[str, object] = {}
        self._dropped_series = 0

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, requested {cls.__name__}")
                return inst
            if len(self._instruments) >= self.max_series:
                self._dropped_series += 1
                return _NULL
            inst = cls(threading.Lock(), **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BUCKET_BOUNDS
                  ) -> Histogram:
        return self._get(name, Histogram, bounds=bounds)

    @property
    def dropped_series(self) -> int:
        with self._lock:
            return self._dropped_series

    def snapshot(self) -> Dict[str, float]:
        """Flat `{name: float}` view: counters/gauges as-is, histograms
        expanded to `<name>/count|mean|p50|p99|max`."""
        with self._lock:
            items = list(self._instruments.items())
            dropped = self._dropped_series
        out: Dict[str, float] = {}
        for name, inst in items:
            if isinstance(inst, Histogram):
                for k, v in inst.snapshot().items():
                    if v is not None and k in ("count", "mean", "p50",
                                               "p99", "max"):
                        out[f"{name}/{k}"] = float(v)
            else:
                out[name] = float(inst.value)
        if dropped:
            out["telemetry/dropped_series"] = float(dropped)
        return out
