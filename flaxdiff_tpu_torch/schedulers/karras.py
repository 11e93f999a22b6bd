"""Karras/EDM sigma schedules (counterpart of ``flaxdiff_tpu/schedulers/karras.py``).

One timestep convention across VP and VE schedules: t ascending means more
noise, so sigma(timesteps - 1) == sigma_max and sigma(0) == sigma_min.
Each constant is the f32 value the JAX package computes: the rho-ramp's
ends in Python float64 (rounded to f32 where they meet a tensor), the logs
and arctangents in f32.
"""
from __future__ import annotations

import torch

from .common import SigmaSchedule, f32_of


class KarrasVENoiseSchedule(SigmaSchedule):
    """Karras et al. 2022's rho-ramp:
    sigma(t) = (smin^(1/rho) + u * (smax^(1/rho) - smin^(1/rho)))^rho,
    u = t / (timesteps - 1)."""

    def __init__(self, timesteps: int = 1000, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, sigma_data: float = 0.5, rho: float = 7.0,
                 device=None):
        super().__init__(timesteps, sigma_min, sigma_max, sigma_data, device)
        self.rho = rho

    def _ends(self):
        inv_rho = 1.0 / self.rho
        return inv_rho, self.sigma_min ** inv_rho, self.sigma_max ** inv_rho

    def sigmas(self, t: torch.Tensor) -> torch.Tensor:
        _, lo, hi = self._ends()
        return (lo + self._u(t) * (hi - lo)) ** self.rho

    def timesteps_from_sigmas(self, sigma: torch.Tensor) -> torch.Tensor:
        inv_rho, lo, hi = self._ends()
        return self._t((sigma ** inv_rho - lo) / (hi - lo))


class SimpleExpNoiseSchedule(SigmaSchedule):
    """Log-linear sigma ramp."""

    def __init__(self, timesteps: int = 1000, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, sigma_data: float = 0.5, device=None):
        super().__init__(timesteps, sigma_min, sigma_max, sigma_data, device)
        self._log_lo = f32_of(torch.log, sigma_min)
        self._log_span = f32_of(lambda a, b: torch.log(b) - torch.log(a), sigma_min, sigma_max)

    def sigmas(self, t: torch.Tensor) -> torch.Tensor:
        return torch.exp(self._log_lo + self._u(t) * self._log_span)

    def timesteps_from_sigmas(self, sigma: torch.Tensor) -> torch.Tensor:
        return self._t((torch.log(sigma) - self._log_lo) / self._log_span)


class EDMNoiseSchedule(KarrasVENoiseSchedule):
    """The Karras ramp for sampling; for training, ln(sigma) ~ N(p_mean,
    p_std), clipped to [sigma_min, sigma_max] and mapped to the ramp's t
    through the inverse, so the rest of the step keeps one convention."""

    def __init__(self, timesteps: int = 1000, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, sigma_data: float = 0.5, rho: float = 7.0,
                 p_mean: float = -1.2, p_std: float = 1.2, device=None):
        super().__init__(timesteps, sigma_min, sigma_max, sigma_data, rho, device)
        self.p_mean, self.p_std = p_mean, p_std

    def sample_timesteps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        z = torch.randn(n, generator=generator, device=generator.device)
        sigma = torch.exp(self.p_std * z + self.p_mean)
        return self.timesteps_from_sigmas(torch.clamp(sigma, self.sigma_min, self.sigma_max))


class CosineGeneralNoiseSchedule(SigmaSchedule):
    """sigma(t) = tan(theta), theta linear in t from atan(sigma_min) to
    atan(sigma_max)."""

    def __init__(self, timesteps: int = 1000, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, sigma_data: float = 0.5, device=None):
        super().__init__(timesteps, sigma_min, sigma_max, sigma_data, device)
        self._theta_min = f32_of(torch.atan, sigma_min)
        self._theta_span = f32_of(lambda a, b: torch.atan(b) - torch.atan(a),
                                  sigma_min, sigma_max)

    def sigmas(self, t: torch.Tensor) -> torch.Tensor:
        return torch.tan(self._theta_min + self._u(t) * self._theta_span)

    def timesteps_from_sigmas(self, sigma: torch.Tensor) -> torch.Tensor:
        return self._t((torch.atan(sigma) - self._theta_min) / self._theta_span)
