"""Noise-schedule core (counterpart of ``flaxdiff_tpu/schedulers/common.py``).

The forward process is x_t = signal_rate(t) * x0 + noise_rate(t) * eps.
A schedule lives on one device; ``to(device)`` moves its tables, so rate
lookups are gathers on the device with no host round trip. The closed-form
schedules hold their constants as Python floats, each the f32 value the JAX
package computes, so they cost no transfer either.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bcast_right(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] with `ndim` dims."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def f32_of(fn, *args: float) -> float:
    """``fn`` of the f32 values of `args`, computed in f32, as a Python
    float: a constant the JAX package takes with ``jnp`` (in f32) rather
    than in Python's float64."""
    return float(fn(*(torch.tensor(a, dtype=torch.float32) for a in args)))


class NoiseSchedule:
    """Base diffusion noise schedule over t in [0, timesteps)."""

    def __init__(self, timesteps: int = 1000, device=None):
        self.timesteps = timesteps
        self._device = torch.device("cpu" if device is None else device)

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

    def remove_all_noise(self, x_t: torch.Tensor, noise: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
        signal, sigma = self.rates(t)
        return (x_t - bcast_right(sigma, x_t.ndim) * noise) / bcast_right(signal, x_t.ndim)

    def transform_inputs(self, x: torch.Tensor, t: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(model input x, model input t); discrete schedules feed t as is."""
        return x, t

    def max_noise_std(self) -> torch.Tensor:
        """Std-dev of the x_T marginal, which scales the initial noise. For VP
        schedules signal(T) ~ 0, so x_T ~ sigma(T) * eps: sigma(T - 1)."""
        _, sigma = self.rates(torch.full((1,), self.timesteps - 1, dtype=torch.float32,
                                         device=self.device))
        return sigma[0]

    @property
    def is_continuous(self) -> bool:
        return False

    @property
    def device(self) -> torch.device:
        return self._device

    def to(self, device) -> "NoiseSchedule":
        """A copy on `device`, its tensors moved there."""
        new = object.__new__(type(self))
        new.__dict__.update({k: v.to(device) if isinstance(v, torch.Tensor) else v
                             for k, v in self.__dict__.items()})
        new._device = torch.device(device)
        return new


class SigmaSchedule(NoiseSchedule):
    """Karras-style schedule: signal rate 1, noise level sigma(t), and its
    inverse t(sigma). Loss weights are EDM's, the model's time input is
    c_noise = log(sigma) / 4."""

    def __init__(self, timesteps: int = 1000, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, sigma_data: float = 0.5, device=None):
        super().__init__(timesteps, device)
        self.sigma_min, self.sigma_max, self.sigma_data = sigma_min, sigma_max, sigma_data

    def sigmas(self, t: torch.Tensor) -> torch.Tensor:
        """Noise level as a function of a [0, timesteps) step index."""
        raise NotImplementedError

    def timesteps_from_sigmas(self, sigma: torch.Tensor) -> torch.Tensor:
        """Inverse of `sigmas`; the karras spacing and RK4 need it."""
        raise NotImplementedError

    def _u(self, t: torch.Tensor) -> torch.Tensor:
        """t as a fraction of the ramp, clipped to [0, 1]."""
        return (t.to(torch.float32) / max(self.timesteps - 1, 1)).clamp(0.0, 1.0)

    def _t(self, u: torch.Tensor) -> torch.Tensor:
        return u.clamp(0.0, 1.0) * (self.timesteps - 1)

    def sample_timesteps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n f32 steps uniform in [0, timesteps - 1)."""
        return torch.rand(n, generator=generator, device=generator.device) * (self.timesteps - 1)

    def rates(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sigma = self.sigmas(t)
        return torch.ones_like(sigma), sigma

    def loss_weights(self, t: torch.Tensor) -> torch.Tensor:
        """EDM's (sigma^2 + sigma_d^2) / (sigma * sigma_d)^2, the denominator
        held at 1e-8 or above."""
        sigma = self.sigmas(t)
        denom = torch.clamp_min((sigma * self.sigma_data) ** 2, 1e-8)
        return (sigma ** 2 + self.sigma_data ** 2) / denom

    def transform_inputs(self, x: torch.Tensor, t: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        return x, 0.25 * torch.log(torch.clamp_min(self.sigmas(t), 1e-12))

    def max_noise_std(self) -> torch.Tensor:
        return torch.full((), self.sigma_max, dtype=torch.float32, device=self.device)

    @property
    def is_continuous(self) -> bool:
        return True
