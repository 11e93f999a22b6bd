"""Sampler engine (counterpart of ``flaxdiff_tpu/samplers/common.py``).

The trajectory is a Python loop under ``torch.inference_mode()``: one model
call per step (two batches in one call with classifier-free guidance), then a
terminal denoise at the last step value. Samplers update in the VE-ified
coordinates x / signal(t), sigma(t) / signal(t), as the JAX package does.

Not in this slice: the cached programs, inpainting, the autoencoder and the
serving chunk programs. Capturing the loop in a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..predictors import PredictionTransform
from ..schedulers.common import NoiseSchedule, bcast_right
from ..utils import clip_images


def _linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace`` in f32, bit for bit: start * (1 - s) + stop * s with
    s = i * (1 / div) (XLA divides by multiplying with the reciprocal) and
    the endpoint appended. The model sees fractional t, so its f32 bits must
    match the JAX package's."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    inv = torch.tensor(1.0, dtype=torch.float32) / div
    step = torch.arange(div, dtype=torch.float32, device=device) * inv.to(device)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def get_timestep_spacing(method: str, num_steps: int, timesteps: int,
                         start: Optional[float] = None, end: float = 0.0,
                         device=None) -> torch.Tensor:
    """[num_steps + 1] descending f32 step values ending at `end`.
    method: linear | quadratic | exponential. Both endpoints are pinned
    exactly (flaxdiff_tpu/samplers/common.py:83)."""
    hi = float(timesteps - 1) if start is None else float(start)
    lo = float(end)
    n = num_steps + 1
    if method == "linear":
        steps = _linspace_f32(hi, lo, n, device)
    elif method == "quadratic":
        steps = _linspace_f32(hi ** 0.5, lo ** 0.5, n, device) ** 2
    elif method == "exponential":
        log = lambda v: float(torch.log(torch.tensor(v, dtype=torch.float32)))
        steps = torch.exp(_linspace_f32(log(hi + 1.0), log(lo + 1.0), n, device)) - 1.0
    else:
        raise ValueError(f"Unknown timestep spacing {method!r}")
    steps[0] = hi
    steps[-1] = lo
    return steps


class Sampler:
    """A sampler is a step function over the VE-ified state. `step` gets
    `denoise(x, t) -> (x0_hat, eps_hat)` so higher-order samplers can take
    several model calls per step."""

    def init_state(self, x: torch.Tensor) -> Any:
        """Extra carried state (e.g. multistep history). Default: none."""
        return ()

    def step(self, denoise: Callable, x: torch.Tensor, t_cur: torch.Tensor,
             t_next: torch.Tensor, generator: torch.Generator, state: Any,
             schedule: NoiseSchedule, step_index: int) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    @staticmethod
    def _coords(schedule: NoiseSchedule, t: torch.Tensor, ndim: int):
        signal, sigma = schedule.rates(t)
        signal = bcast_right(signal, ndim)
        sigma = bcast_right(sigma, ndim)
        return signal, sigma / torch.clamp_min(signal, 1e-12)


class DiffusionSampler:
    """Trajectory generation with optional classifier-free guidance.

    model_fn(x, t, cond) -> raw network output (NHWC). With
    ``guidance_scale > 0`` and an ``unconditional`` input, one model call
    takes [cond; uncond] stacked on the batch axis and the guided output is
    u + s * (c - u), as at flaxdiff_tpu/samplers/common.py:180-189.
    """

    def __init__(self, model_fn: Callable, schedule: NoiseSchedule,
                 transform: PredictionTransform, sampler: Sampler,
                 guidance_scale: float = 0.0, clip_denoised: bool = False,
                 timestep_spacing: str = "linear", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.schedule = schedule.to(self.device)
        self.transform = transform
        self.sampler = sampler
        self.guidance_scale = float(guidance_scale)
        self.clip_denoised = clip_denoised
        self.timestep_spacing = timestep_spacing

    def _denoise_fn(self, cond, uncond):
        schedule, transform = self.schedule, self.transform
        use_cfg = self.guidance_scale > 0.0 and uncond is not None

        def denoise(x, t):
            t_b = t.expand(x.shape[0]).to(torch.float32)
            c_in = bcast_right(transform.input_scale(schedule, t_b), x.ndim)
            x_in, t_in = schedule.transform_inputs(x * c_in, t_b)
            if use_cfg:
                raw = self.model_fn(torch.cat([x_in, x_in]), torch.cat([t_in, t_in]),
                                    torch.cat([cond, uncond]))
                raw_c, raw_u = raw.chunk(2)
                raw = raw_u + self.guidance_scale * (raw_c - raw_u)
            else:
                raw = self.model_fn(x_in, t_in, cond)
            pred = transform.transform_output(x, t_b, raw.float(), schedule)
            x0, eps = transform.to_x0_eps(x, t_b, pred, schedule)
            if self.clip_denoised:
                x0 = clip_images(x0)
                signal, sigma = schedule.rates(t_b)
                eps = (x - bcast_right(signal, x.ndim) * x0) / torch.clamp_min(
                    bcast_right(sigma, x.ndim), 1e-12)
            return x0, eps

        return denoise

    @torch.inference_mode()
    def generate_samples(self, num_samples: int = 4, resolution: int = 64,
                         diffusion_steps: int = 50,
                         generator: Optional[torch.Generator] = None,
                         conditioning: Optional[torch.Tensor] = None,
                         unconditional: Optional[torch.Tensor] = None,
                         init_samples: Optional[torch.Tensor] = None,
                         start_step: Optional[float] = None, end_step: float = 0.0,
                         channels: int = 3) -> torch.Tensor:
        """Run the trajectory; returns samples [N, R, R, C] clipped to [-1, 1].
        Random draws (initial noise, stochastic samplers) come from
        `generator` (default: seed 42 on the sampler's device)."""
        dev = self.device
        generator = make_generator(42, dev) if generator is None else generator
        if init_samples is None:
            shape = (num_samples, resolution, resolution, channels)
            x = torch.randn(shape, generator=generator, device=dev) * self.schedule.max_noise_std()
        else:
            x = init_samples.to(dev, torch.float32)
        cond = None if conditioning is None else conditioning.to(dev)
        uncond = None if unconditional is None else unconditional.to(dev)
        steps = get_timestep_spacing(self.timestep_spacing, diffusion_steps,
                                     self.schedule.timesteps, start_step, end_step, dev)
        denoise = self._denoise_fn(cond, uncond)
        state = self.sampler.init_state(x)
        for i in range(diffusion_steps):
            x, state = self.sampler.step(denoise, x, steps[i], steps[i + 1], generator,
                                         state, self.schedule, i)
        # terminal denoise: a plain model call at the final step value
        x0, _ = denoise(x, steps[-1])
        return clip_images(x0)


__all__ = ["DiffusionSampler", "Sampler", "get_timestep_spacing"]
