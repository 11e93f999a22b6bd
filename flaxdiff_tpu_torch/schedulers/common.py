"""Noise-schedule core (counterpart of ``flaxdiff_tpu/schedulers/common.py``).

The forward process is x_t = signal_rate(t) * x0 + noise_rate(t) * eps.
A schedule holds its tables as tensors on one device; ``to(device)`` moves
it, so rate lookups are gathers on the device with no host round trip.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bcast_right(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] with `ndim` dims."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


class NoiseSchedule:
    """Base diffusion noise schedule over t in [0, timesteps)."""

    def __init__(self, timesteps: int = 1000):
        self.timesteps = timesteps

    def rates(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(signal_rate, noise_rate) per sample, shape == t.shape."""
        raise NotImplementedError

    def loss_weights(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sample_timesteps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Training-time timesteps, drawn from `generator` on its device."""
        raise NotImplementedError

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        signal, sigma = self.rates(t)
        return bcast_right(signal, x0.ndim) * x0 + bcast_right(sigma, x0.ndim) * noise

    def to(self, device) -> "NoiseSchedule":
        raise NotImplementedError

    def transform_inputs(self, x: torch.Tensor, t: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(model input x, model input t); discrete schedules feed t as is."""
        return x, t

    def max_noise_std(self) -> torch.Tensor:
        """Std-dev of the x_T marginal, which scales the initial noise. For VP
        schedules signal(T) ~ 0, so x_T ~ sigma(T) * eps: sigma(T - 1)."""
        _, sigma = self.rates(torch.tensor([self.timesteps - 1], dtype=torch.float32,
                                           device=self.device))
        return sigma[0]

    @property
    def device(self) -> torch.device:
        raise NotImplementedError
