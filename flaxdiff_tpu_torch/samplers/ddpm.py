"""DDPM ancestral samplers (counterpart of ``flaxdiff_tpu/samplers/ddpm.py``)."""
from __future__ import annotations

import torch

from ..schedulers.common import NoiseSchedule, bcast_right
from .common import Sampler


class DDPMSampler(Sampler):
    """Ancestral sampling through the q(x_s | x_t, x0) posterior in closed
    form from the schedule's rates at (t_cur, t_next): exact for any step
    pair and any schedule, and the classic table values for adjacent steps.
    Noise is drawn at every step, the last too, and masked where
    t_next is 0."""

    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        x0, eps = denoise(x, t_cur)
        mean, logvar = _generalized_posterior(schedule, x0, eps, t_cur.expand(b),
                                              t_next.expand(b), x.ndim)
        z = noise.normal(x.shape)
        nonzero = bcast_right((t_next.expand(b) > 0).to(x.dtype), x.ndim)
        return mean + nonzero * torch.exp(0.5 * logvar) * z, state


def _generalized_posterior(schedule: NoiseSchedule, x0, eps, t_cur, t_next, ndim):
    signal_n, sigma_n = schedule.rates(t_next)
    signal_c, sigma_c = schedule.rates(t_cur)
    sh_c = sigma_c / torch.clamp_min(signal_c, 1e-12)
    sh_n = sigma_n / torch.clamp_min(signal_n, 1e-12)
    var_hat = sh_n ** 2 * torch.clamp_min(sh_c ** 2 - sh_n ** 2, 0.0) / torch.clamp_min(
        sh_c ** 2, 1e-12)
    down = torch.sqrt(torch.clamp_min(sh_n ** 2 - var_hat, 0.0))
    signal_n_b = bcast_right(signal_n, ndim)
    mean = signal_n_b * (x0 + bcast_right(down, ndim) * eps)
    logvar = torch.log(torch.clamp_min(bcast_right(var_hat, ndim) * signal_n_b ** 2, 1e-20))
    return mean, logvar


class SimpleDDPMSampler(Sampler):
    """Ancestral DDPM from rate ratios; any schedule, any step pair."""

    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        x0, eps = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        var_up = sh_n ** 2 * torch.clamp_min(sh_c ** 2 - sh_n ** 2, 0.0) / torch.clamp_min(
            sh_c ** 2, 1e-24)
        sigma_down = torch.sqrt(torch.clamp_min(sh_n ** 2 - var_up, 0.0))
        x_hat_next = x0 + sigma_down * eps
        return signal_n * (x_hat_next + torch.sqrt(var_up) * noise.normal(x.shape)), state
