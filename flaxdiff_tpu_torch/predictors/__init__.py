"""Prediction transforms: what the network predicts and how to invert it
(counterpart of ``flaxdiff_tpu/predictors/__init__.py``).

  forward(schedule, x0, noise, t)   -> (x_t, target)       [training]
  transform_output(x_t, t, raw, s)  -> prediction in target space
  input_scale(schedule, t)          -> c_in multiplier on x_t before the net
  to_x0_eps(x_t, t, pred, s)        -> (x0_hat, eps_hat)   [sampling]
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..schedulers.common import NoiseSchedule, SigmaSchedule, bcast_right


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



class KarrasPredictionTransform(PredictionTransform):
    """EDM preconditioning (Karras et al. 2022):
    D(x; sigma) = c_skip * x + c_out * F(c_in * x; c_noise). The target is
    x0 and `transform_output` applies the c_skip/c_out wrap, so the weighted
    MSE on (D, x0) with a SigmaSchedule's EDM weights is the EDM loss."""

    def __init__(self, sigma_data: float = 0.5):
        self.sigma_data = sigma_data

    def _coeffs(self, schedule: SigmaSchedule, t: torch.Tensor):
        sigma = schedule.sigmas(t)
        sd2 = self.sigma_data ** 2
        denom = sigma ** 2 + sd2
        # a tensor numerator: ``float / tensor`` is reciprocal times float in torch
        c_skip = torch.full_like(denom, sd2) / denom
        c_out = sigma * self.sigma_data / torch.sqrt(denom)
        c_in = 1.0 / torch.sqrt(denom)
        return sigma, c_skip, c_out, c_in

    def target(self, schedule, x0, noise, x_t, t):
        return x0

    def input_scale(self, schedule, t):
        return self._coeffs(schedule, t)[3]

    def transform_output(self, x_t, t, raw, schedule):
        _, c_skip, c_out, _ = self._coeffs(schedule, t)
        return bcast_right(c_skip, x_t.ndim) * x_t + bcast_right(c_out, x_t.ndim) * raw

    def to_x0_eps(self, x_t, t, pred, schedule):
        # pred is already the denoised D(x; sigma)
        sigma = bcast_right(self._coeffs(schedule, t)[0], x_t.ndim)
        return pred, (x_t - pred) / torch.clamp_min(sigma, 1e-12)


TRANSFORM_REGISTRY = {
    "epsilon": EpsilonPredictionTransform,
    "eps": EpsilonPredictionTransform,
    "direct": DirectPredictionTransform,
    "x0": DirectPredictionTransform,
    "v": VPredictionTransform,
    "v_prediction": VPredictionTransform,
    "karras": KarrasPredictionTransform,
    "edm": KarrasPredictionTransform,
}


def get_transform(name: str, **kwargs) -> PredictionTransform:
    if name not in TRANSFORM_REGISTRY:
        raise ValueError(f"Unknown prediction transform {name!r}")
    return TRANSFORM_REGISTRY[name](**kwargs)
