"""Discrete variance-preserving (beta) schedules with precomputed tables
(counterpart of ``flaxdiff_tpu/schedulers/discrete.py``).

The tables are built in float64 numpy and cast to f32, as the JAX package
does, so both hold the same f32 values.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .common import NoiseSchedule, bcast_right


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
    (``astype(int32)`` in the JAX package, flaxdiff_tpu/schedulers/discrete.py:318).
    Loss weights are P2's (k + SNR)^-gamma (Choi et al. 2022), 1 at the
    default gamma 0. The DDPM posterior q(x_{t-1} | x_t, x0) comes as tables
    too (``from_betas``, discrete.py:286-314)."""

    def __init__(self, betas: np.ndarray, device=None, p2_k: float = 1.0,
                 p2_gamma: float = 0.0):
        # the 1000/T rescale gives beta >= 1 for tiny T: clamp, as the JAX package does
        betas = np.clip(np.asarray(betas, dtype=np.float64), 1e-8, 0.999)
        timesteps = len(betas)
        super().__init__(timesteps, device)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        # clipped at the first step's variance: posterior_variance[0] is 0
        posterior_log_variance = np.log(
            np.maximum(posterior_variance, posterior_variance[1] if timesteps > 1 else 1e-20))
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.betas = f32(betas)
        self.alphas_cumprod = f32(alphas_cumprod)
        self.sqrt_alphas_cumprod = f32(np.sqrt(alphas_cumprod))
        self.sqrt_one_minus_alphas_cumprod = f32(np.sqrt(1.0 - alphas_cumprod))
        self.posterior_variance = f32(posterior_variance)
        self.posterior_log_variance_clipped = f32(posterior_log_variance)
        self.posterior_mean_coef1 = f32(betas * np.sqrt(alphas_cumprod_prev)
                                        / (1.0 - alphas_cumprod))
        self.posterior_mean_coef2 = f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                        / (1.0 - alphas_cumprod))
        self.p2_loss_weight_k = p2_k
        self.p2_loss_weight_gamma = p2_gamma

    def _index(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.int32).clamp(0, self.timesteps - 1).long()

    def rates(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self._index(t)
        return self.sqrt_alphas_cumprod[idx], self.sqrt_one_minus_alphas_cumprod[idx]

    def loss_weights(self, t: torch.Tensor) -> torch.Tensor:
        ab = self.alphas_cumprod[self._index(t)]
        return (self.p2_loss_weight_k + ab / (1.0 - ab)) ** (-self.p2_loss_weight_gamma)

    def sample_timesteps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n integer steps uniform in [0, timesteps), int32 as in JAX."""
        return torch.randint(0, self.timesteps, (n,), generator=generator,
                             device=generator.device, dtype=torch.int32)

    def posterior_mean(self, x0: torch.Tensor, x_t: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
        idx = self._index(t)
        return (bcast_right(self.posterior_mean_coef1[idx], x0.ndim) * x0
                + bcast_right(self.posterior_mean_coef2[idx], x0.ndim) * x_t)

    def posterior_log_variance(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return bcast_right(self.posterior_log_variance_clipped[self._index(t)], ndim)


def LinearNoiseSchedule(timesteps: int = 1000, beta_start: float = 0.0001,
                        beta_end: float = 0.02, device=None, **p2) -> DiscreteNoiseSchedule:
    return DiscreteNoiseSchedule(linear_beta_schedule(timesteps, beta_start, beta_end),
                                 device, **p2)


def CosineNoiseSchedule(timesteps: int = 1000, s: float = 0.008,
                        device=None, **p2) -> DiscreteNoiseSchedule:
    return DiscreteNoiseSchedule(cosine_beta_schedule(timesteps, s), device, **p2)


def ExpNoiseSchedule(timesteps: int = 1000, beta_start: float = 0.0001,
                     beta_end: float = 0.02, device=None, **p2) -> DiscreteNoiseSchedule:
    return DiscreteNoiseSchedule(exp_beta_schedule(timesteps, beta_start, beta_end),
                                 device, **p2)
