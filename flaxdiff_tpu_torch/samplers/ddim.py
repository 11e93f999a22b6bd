"""DDIM sampler with optional eta stochasticity
(counterpart of ``flaxdiff_tpu/samplers/ddim.py``)."""
from __future__ import annotations

import torch

from .common import Sampler


class DDIMSampler(Sampler):
    def __init__(self, eta: float = 0.0):
        self.eta = float(eta)

    def step(self, denoise, x, t_cur, t_next, generator, state, schedule, step_index):
        b = x.shape[0]
        x0, eps = denoise(x, t_cur)
        signal_c, sh_c = self._coords(schedule, t_cur.expand(b), x.ndim)
        signal_n, sh_n = self._coords(schedule, t_next.expand(b), x.ndim)
        # eta=1 recovers ancestral sampling; eta=0 is the deterministic ODE step
        var_up = (self.eta ** 2) * sh_n ** 2 * torch.clamp_min(
            sh_c ** 2 - sh_n ** 2, 0.0) / torch.clamp_min(sh_c ** 2, 1e-24)
        sigma_down = torch.sqrt(torch.clamp_min(sh_n ** 2 - var_up, 0.0))
        x_next = x0 + sigma_down * eps
        if self.eta > 0:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
            x_next = x_next + torch.sqrt(var_up) * noise
        return signal_n * x_next, state
