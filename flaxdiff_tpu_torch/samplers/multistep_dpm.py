"""Multistep DPM-Solver++ of orders 1-3 (counterpart of
``flaxdiff_tpu/samplers/multistep_dpm.py``).

Data prediction in lambda = -log(sigma_hat):
  x_hat_next = (sh_n / sh_c) * x_hat - expm1(-h) * D_tilde,  h = l_n - l_c
with D_tilde a first-, second- or third-order extrapolation of the x0
predictions. The two previous predictions and their lambdas ride in the
sampler state; the order in use follows the Python step index.
"""
from __future__ import annotations

from typing import Any

import torch

from .common import Sampler


def _lambda_of(schedule, t: torch.Tensor) -> torch.Tensor:
    """The log-SNR coordinate lambda(t) = -log(sigma / signal), a 0-d tensor."""
    signal, sigma = schedule.rates(t.reshape(1).to(torch.float32))
    sh = torch.clamp_min(sigma[0] / torch.clamp_min(signal[0], 1e-12), 1e-6)
    return -torch.log(sh)


def _safe_div(a, b):
    return a / torch.where(b.abs() > 1e-12, b, torch.ones_like(b))


class MultiStepDPMSampler(Sampler):
    def __init__(self, order: int = 2):
        self.order = order

    def init_state(self, x: torch.Tensor) -> Any:
        zeros = torch.zeros_like(x)
        scalar = torch.zeros((), device=x.device)
        # (D_{i-1}, D_{i-2}, lambda_{i-1}, lambda_{i-2})
        return (zeros, zeros, scalar, scalar)

    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        b = x.shape[0]
        d_prev, d_prev2, l_prev, l_prev2 = state
        x0, _ = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        sh_c = torch.clamp_min(sh_c, 1e-6)
        sh_n = torch.clamp_min(sh_n, 1e-6)
        l_cur = _lambda_of(schedule, t_cur)
        h = _lambda_of(schedule, t_next) - l_cur
        want = min(self.order, 3)
        if step_index >= 2 and want >= 3:
            # quadratic extrapolation over the two previous predictions
            h_prev = l_cur - l_prev
            slope1 = _safe_div(x0 - d_prev, h_prev)
            slope2 = _safe_div(d_prev - d_prev2, l_prev - l_prev2)
            curv = _safe_div(slope1 - slope2, h_prev + (l_prev - l_prev2))
            d_tilde = x0 + 0.5 * h * slope1 + (h ** 2 / 6.0) * curv
        elif step_index >= 1 and want >= 2:
            # linear extrapolation of D over lambda
            d_tilde = x0 + 0.5 * h * _safe_div(x0 - d_prev, l_cur - l_prev)
        else:
            d_tilde = x0
        x_hat_next = (sh_n / sh_c) * (x / signal_c) - torch.expm1(-h) * d_tilde
        return signal_n * x_hat_next, (x0, d_prev, l_cur, l_prev)
