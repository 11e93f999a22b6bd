"""Prediction transforms: what the network predicts and how to invert it
(counterpart of ``flaxdiff_tpu/predictors/__init__.py``); the Karras
transform comes with the sigma schedules.

  forward(schedule, x0, noise, t)   -> (x_t, target)       [training]
  transform_output(x_t, t, raw, s)  -> prediction in target space
  input_scale(schedule, t)          -> c_in multiplier on x_t before the net
  to_x0_eps(x_t, t, pred, s)        -> (x0_hat, eps_hat)   [sampling]
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..schedulers.common import NoiseSchedule, bcast_right


def _rates(schedule: NoiseSchedule, t: torch.Tensor, ndim: int):
    signal, sigma = schedule.rates(t)
    return bcast_right(signal, ndim), bcast_right(sigma, ndim)


class PredictionTransform:
    """Base: identity output transform, unit input scale."""

    def forward(self, schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
                t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x_t = schedule.add_noise(x0, noise, t)
        return x_t, self.target(schedule, x0, noise, x_t, t)

    def target(self, schedule, x0, noise, x_t, t) -> torch.Tensor:
        raise NotImplementedError

    def input_scale(self, schedule: NoiseSchedule, t: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(t, dtype=torch.float32)

    def transform_output(self, x_t, t, raw, schedule) -> torch.Tensor:
        return raw

    def to_x0_eps(self, x_t, t, pred, schedule) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class EpsilonPredictionTransform(PredictionTransform):
    """The network predicts the noise eps."""

    def target(self, schedule, x0, noise, x_t, t):
        return noise

    def to_x0_eps(self, x_t, t, pred, schedule):
        signal, sigma = _rates(schedule, t, x_t.ndim)
        x0 = (x_t - sigma * pred) / torch.clamp_min(signal, 1e-12)
        return x0, pred


class DirectPredictionTransform(PredictionTransform):
    """The network predicts x0 directly."""

    def target(self, schedule, x0, noise, x_t, t):
        return x0

    def to_x0_eps(self, x_t, t, pred, schedule):
        signal, sigma = _rates(schedule, t, x_t.ndim)
        eps = (x_t - signal * pred) / torch.clamp_min(sigma, 1e-12)
        return pred, eps


class VPredictionTransform(PredictionTransform):
    """v = signal * eps - noise_rate * x0 (Salimans & Ho)."""

    def target(self, schedule, x0, noise, x_t, t):
        signal, sigma = _rates(schedule, t, x0.ndim)
        return signal * noise - sigma * x0

    def to_x0_eps(self, x_t, t, pred, schedule):
        signal, sigma = _rates(schedule, t, x_t.ndim)
        norm = signal ** 2 + sigma ** 2
        x0 = (signal * x_t - sigma * pred) / norm
        eps = (sigma * x_t + signal * pred) / norm
        return x0, eps

