"""Multistep DPM-Solver++ of orders 1-3 (counterpart of
``flaxdiff_tpu/samplers/multistep_dpm.py``).

Data prediction in lambda = -log(sigma_hat):
  x_hat_next = (sh_n / sh_c) * x_hat - expm1(-h) * D_tilde,  h = l_n - l_c
with D_tilde a first-, second- or third-order extrapolation of the x0
predictions. The two previous predictions and their lambdas ride in the
sampler state. In the solo loop the order in use follows the Python step
index. A serving round batches rows that sit at different steps of their
trajectories, so there the step index is a tensor of one index per sample,
the lambdas in the state are per-sample vectors, and each sample selects
its order as the reference does with ``jnp.where``
(flaxdiff_tpu/samplers/multistep_dpm.py:67-69).
"""
from __future__ import annotations

from typing import Any

import torch

from ..schedulers.common import bcast_right
from .common import Sampler


def _lambda(schedule, t: torch.Tensor) -> torch.Tensor:
    """The log-SNR coordinate lambda(t) = -log(sigma / signal), elementwise
    over `t` (0-d in the solo loop, one value per sample in a round)."""
    signal, sigma = schedule.rates(t.reshape(-1).to(torch.float32))
    sh = torch.clamp_min(sigma / torch.clamp_min(signal, 1e-12), 1e-6)
    return -torch.log(sh).reshape(t.shape)


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
        rows = isinstance(step_index, torch.Tensor)
        d_prev, d_prev2, l_prev, l_prev2 = state
        x0, _ = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        sh_c = torch.clamp_min(sh_c, 1e-6)
        sh_n = torch.clamp_min(sh_n, 1e-6)
        l_cur = _lambda(schedule, t_cur.expand(b) if rows else t_cur)
        l_next = _lambda(schedule, t_next.expand(b) if rows else t_next)
        col = (lambda v: bcast_right(v, x.ndim)) if rows else (lambda v: v)
        h, h_prev, h_prev2 = col(l_next - l_cur), col(l_cur - l_prev), col(l_prev - l_prev2)
        # the order in use: one for the batch in the solo loop; in a round
        # each sample selects its own (the most any sample can use is built)
        order = min(self.order, 3)
        if rows:
            own = col(torch.clamp(step_index + 1, max=order))
        else:
            order = min(step_index + 1, order)
        d_tilde = x0
        if order >= 2:
            # linear extrapolation of D over lambda
            slope1 = _safe_div(x0 - d_prev, h_prev)
            d2 = x0 + 0.5 * h * slope1
            d_tilde = torch.where(own >= 2, d2, d_tilde) if rows else d2
        if order >= 3:
            # quadratic extrapolation over the two previous predictions
            slope2 = _safe_div(d_prev - d_prev2, h_prev2)
            curv = _safe_div(slope1 - slope2, h_prev + h_prev2)
            d3 = d2 + (h ** 2 / 6.0) * curv
            d_tilde = torch.where(own >= 3, d3, d_tilde) if rows else d3
        x_hat_next = (sh_n / sh_c) * (x / signal_c) - torch.expm1(-h) * d_tilde
        return signal_n * x_hat_next, (x0, d_prev, l_cur, l_prev)
