"""Continuous VP schedules, closed-form rates over float t in [0, 1]
(counterpart of ``flaxdiff_tpu/schedulers/continuous.py``)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .common import NoiseSchedule


class ContinuousNoiseSchedule(NoiseSchedule):
    """Base for continuous schedules: training draws t ~ U[0, 1); samplers
    drive them with step values in [0, timesteps), which `_normalize` maps
    back."""

    def sample_timesteps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.rand(n, generator=generator, device=generator.device)

    def _normalize(self, t: torch.Tensor) -> torch.Tensor:
        # a value above 1 is a step index, one at or below 1 already a
        # fraction: so a step value in (0, 1] near the end of a trajectory
        # reads as a fraction, as in the JAX package (continuous.py:24-28)
        t = t.to(torch.float32)
        return torch.where(t > 1.0, t / self.timesteps, t)

    def loss_weights(self, t: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(self._normalize(t))

    @property
    def is_continuous(self) -> bool:
        return True


class CosineContinuousNoiseSchedule(ContinuousNoiseSchedule):
    """signal = cos(pi/2 * t), noise = sin(pi/2 * t)."""

    def rates(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        angle = 0.5 * math.pi * self._normalize(t)
        return torch.cos(angle), torch.sin(angle)

    def max_noise_std(self) -> torch.Tensor:
        # sigma at the fraction 1 - 1/T (sin(pi/2) would be 1 exactly)
        _, sigma = self.rates(torch.full((1,), 1.0 - 1.0 / self.timesteps,
                                         dtype=torch.float32, device=self.device))
        return sigma[0]


class SqrtContinuousNoiseSchedule(ContinuousNoiseSchedule):
    """alpha_bar = 1 - sqrt(t + 1e-4) (Li et al., Diffusion-LM)."""

    def rates(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        alpha_bar = torch.clamp(1.0 - torch.sqrt(self._normalize(t) + 1e-4), 1e-6, 1.0)
        return torch.sqrt(alpha_bar), torch.sqrt(1.0 - alpha_bar)
