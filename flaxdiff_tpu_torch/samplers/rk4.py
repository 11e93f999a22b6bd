"""Classic RK4 ODE sampler (counterpart of ``flaxdiff_tpu/samplers/rk4.py``).

Four model calls a step on dx/dsigma = eps. The midpoint slopes need
t(sigma), so the schedule must be a SigmaSchedule (signal rate 1).
"""
from __future__ import annotations

from ..schedulers.common import SigmaSchedule, bcast_right
from .common import Sampler


class RK4Sampler(Sampler):
    def step(self, denoise, x, t_cur, t_next, noise, state, schedule, step_index):
        if not isinstance(schedule, SigmaSchedule):
            raise TypeError(f"RK4Sampler requires a SigmaSchedule (sigma-parameterized), "
                            f"not {type(schedule).__name__}")
        b = x.shape[0]
        t_c, t_n = t_cur.expand(b), t_next.expand(b)
        sigma_c, sigma_n = schedule.sigmas(t_c), schedule.sigmas(t_n)
        h = bcast_right(sigma_n - sigma_c, x.ndim)
        t_mid = schedule.timesteps_from_sigmas(0.5 * (sigma_c + sigma_n))

        def slope(xi, ti):
            return denoise(xi, ti)[1]

        k1 = slope(x, t_c)
        k2 = slope(x + 0.5 * h * k1, t_mid)
        k3 = slope(x + 0.5 * h * k2, t_mid)
        k4 = slope(x + h * k3, t_n)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), state
