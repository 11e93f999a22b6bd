"""Euler-family ODE samplers (counterpart of ``flaxdiff_tpu/samplers/euler.py``)."""
from __future__ import annotations

import torch

from .common import Sampler


class EulerSampler(Sampler):
    """Probability-flow Euler in VE-ified sigma space: dx_hat/dsigma_hat = eps."""

    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        x0, eps = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        return signal_n * (x / signal_c + eps * (sh_n - sh_c)), state


class SimplifiedEulerSampler(Sampler):
    """x0-form Euler: a step toward the denoised estimate."""

    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        x0, eps = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        ratio = sh_n / torch.clamp_min(sh_c, 1e-12)
        return signal_n * (x0 + ratio * (x / signal_c - x0)), state


class EulerAncestralSampler(Sampler):
    """An Euler step to sigma_down, then fresh noise of sigma_up."""

    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        x0, eps = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        var_up = sh_n ** 2 * torch.clamp_min(sh_c ** 2 - sh_n ** 2, 0.0) / torch.clamp_min(
            sh_c ** 2, 1e-24)
        sigma_down = torch.sqrt(torch.clamp_min(sh_n ** 2 - var_up, 0.0))
        x_hat_next = x / signal_c + eps * (sigma_down - sh_c)
        return signal_n * (x_hat_next + torch.sqrt(var_up) * noise.normal(x.shape)), state
