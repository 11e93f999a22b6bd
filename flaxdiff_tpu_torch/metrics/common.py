"""Metric types and a direction-aware best tracker (counterpart of
``flaxdiff_tpu/metrics/common.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict


@dataclass
class EvaluationMetric:
    """function(generated_samples, batch) -> scalar."""

    function: Callable[..., float]
    name: str
    higher_is_better: bool = True


@dataclass
class MetricTracker:
    """The best value of each metric, with its direction."""

    best: Dict[str, float] = field(default_factory=dict)
    directions: Dict[str, bool] = field(default_factory=dict)

    def update(self, name: str, value: float, higher_is_better: bool = True) -> bool:
        """Record a value; True if it is a new best."""
        self.directions[name] = higher_is_better
        prev = self.best.get(name)
        improved = prev is None or (value > prev if higher_is_better else value < prev)
        if improved:
            self.best[name] = value
        return improved

    def is_best(self, name: str, value: float) -> bool:
        prev = self.best.get(name)
        if prev is None:
            return True
        hib = self.directions.get(name, True)
        return value > prev if hib else value < prev
