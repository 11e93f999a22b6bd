"""Discrete variance-preserving (beta) schedules with precomputed tables
(counterpart of ``flaxdiff_tpu/schedulers/discrete.py``).

The tables are built in float64 numpy and cast to f32, as the JAX package
does, so both hold the same f32 values.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .common import NoiseSchedule


def linear_beta_schedule(timesteps: int, beta_start: float = 0.0001,
                         beta_end: float = 0.02) -> np.ndarray:
    """Linear betas with the canonical 1000/T rescale."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * beta_start, scale * beta_end, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008,
                         max_beta: float = 0.999) -> np.ndarray:
    """Nichol & Dhariwal cosine alpha-bar -> betas."""
    steps = np.arange(timesteps + 1, dtype=np.float64) / timesteps
    alpha_bar = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    betas = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
    return np.clip(betas, 0.0, max_beta)


def exp_beta_schedule(timesteps: int, beta_start: float = 0.0001,
                      beta_end: float = 0.02) -> np.ndarray:
    """Geometric (exponential) beta ramp."""
    return np.exp(np.linspace(np.log(beta_start), np.log(beta_end), timesteps))


class DiscreteNoiseSchedule(NoiseSchedule):
    """VP schedule over alpha-bar tables: signal = sqrt(alpha_bar[t]),
    noise = sqrt(1 - alpha_bar[t]), with t truncated to an integer index
    (``astype(int32)`` in the JAX package, flaxdiff_tpu/schedulers/discrete.py:95)."""

    def __init__(self, betas: np.ndarray, device=None):
        # the 1000/T rescale gives beta >= 1 for tiny T: clamp, as the JAX package does
        betas = np.clip(np.asarray(betas, dtype=np.float64), 1e-8, 0.999)
        super().__init__(len(betas))
        alphas_cumprod = np.cumprod(1.0 - betas)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.betas = f32(betas)
        self.alphas_cumprod = f32(alphas_cumprod)
        self.sqrt_alphas_cumprod = f32(np.sqrt(alphas_cumprod))
        self.sqrt_one_minus_alphas_cumprod = f32(np.sqrt(1.0 - alphas_cumprod))

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def to(self, device) -> "DiscreteNoiseSchedule":
        new = object.__new__(type(self))
        new.timesteps = self.timesteps
        for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                     "sqrt_one_minus_alphas_cumprod"):
            setattr(new, name, getattr(self, name).to(device))
        return new

    def rates(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = t.to(torch.int32).clamp(0, self.timesteps - 1).long()
        return self.sqrt_alphas_cumprod[idx], self.sqrt_one_minus_alphas_cumprod[idx]


def LinearNoiseSchedule(timesteps: int = 1000, beta_start: float = 0.0001,
                        beta_end: float = 0.02, device=None) -> DiscreteNoiseSchedule:
    return DiscreteNoiseSchedule(linear_beta_schedule(timesteps, beta_start, beta_end), device)


def CosineNoiseSchedule(timesteps: int = 1000, s: float = 0.008,
                        device=None) -> DiscreteNoiseSchedule:
    return DiscreteNoiseSchedule(cosine_beta_schedule(timesteps, s), device)


def ExpNoiseSchedule(timesteps: int = 1000, beta_start: float = 0.0001,
                     beta_end: float = 0.02, device=None) -> DiscreteNoiseSchedule:
    return DiscreteNoiseSchedule(exp_beta_schedule(timesteps, beta_start, beta_end), device)
