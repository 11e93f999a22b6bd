"""Heun's second-order sampler (counterpart of ``flaxdiff_tpu/samplers/heun.py``).

The exponential-integrator form in log-SNR space (the trapezoidal rule on
the x0 prediction):

    lambda = -log(sigma_hat),  h = lambda_next - lambda_cur
    x_hat_next = (sh_n / sh_c) * x_hat - expm1(-h) * 0.5 * (x0_c + x0_n)

with x0_n taken at the first-order (DDIM) predictor. The linear part is
integrated exactly, so the coefficients stay bounded across the VP tail.
Two model calls every step: at the terminal step (sigma_next ~ 0) the
predictor's result is selected arithmetically, with no host branch.
"""
from __future__ import annotations

import torch

from .common import Sampler


class HeunSampler(Sampler):
    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        x0_c, _ = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        sh_c = torch.clamp_min(sh_c, 1e-8)
        sh_n = torch.clamp_min(sh_n, 1e-8)
        ratio = sh_n / sh_c                                        # e^{-h}
        growth = -torch.expm1(torch.log(sh_n) - torch.log(sh_c))   # 1 - e^{-h}
        x_hat = x / signal_c
        x_hat_euler = ratio * x_hat + growth * x0_c
        x0_n, _ = denoise(signal_n * x_hat_euler, t_next)
        x_hat_heun = ratio * x_hat + growth * 0.5 * (x0_c + x0_n)
        use_heun = (sh_n > 1e-6).to(x.dtype)
        x_hat_next = use_heun * x_hat_heun + (1.0 - use_heun) * x_hat_euler
        return signal_n * x_hat_next, state
