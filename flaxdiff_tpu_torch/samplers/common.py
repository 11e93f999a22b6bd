"""Sampler engine (counterpart of ``flaxdiff_tpu/samplers/common.py``).

The trajectory is a Python loop under ``torch.inference_mode()``: one model
call per step (two batches in one call with classifier-free guidance), then a
terminal denoise at the last step value. Samplers update in the VE-ified
coordinates x / signal(t), sigma(t) / signal(t), as the JAX package does.

Not ported yet: the autoencoder decode, the cached programs and the
serving chunk, terminal and trajectory-input programs. Capturing the loop
in a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..predictors import PredictionTransform
from ..schedulers.common import NoiseSchedule, bcast_right
from ..utils import clip_images


def _linspace_f32(start, stop, num: int) -> torch.Tensor:
    """``jnp.linspace`` in f32 on the CPU, bit for bit, as XLA compiles it:
    start * (1 - i * r) + i * (stop * r) with r = f32(1 / div), the sum fused
    into one rounding (an FMA; emulated in float64), and the endpoint
    appended. The model sees fractional t, so its f32 bits must match the
    JAX package's."""
    start_t = torch.as_tensor(start, dtype=torch.float32)
    stop_t = torch.as_tensor(stop, dtype=torch.float32)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    inv = torch.tensor(1.0, dtype=torch.float32) / div
    iota = torch.arange(div, dtype=torch.float32)
    head = start_t * (1 - iota * inv)
    out = (iota.double() * (stop_t * inv).double() + head.double()).float()
    return torch.cat([out, stop_t.reshape(1)])


def _pow_f32(x: torch.Tensor, e: float) -> torch.Tensor:
    """f32 ``x ** e`` as XLA's CPU pow rounds it (to nearest, from a wider
    result), where torch's vectorised CPU pow is off by an ulp in ~2% of
    values. `e` is rounded to f32 first, as a weak-typed JAX exponent is."""
    return (x.double() ** float(torch.tensor(e, dtype=torch.float32))).float()


def get_timestep_spacing(method: str, num_steps: int, timesteps: int,
                         start: Optional[float] = None, end: float = 0.0, rho: float = 7.0,
                         schedule: Optional[NoiseSchedule] = None,
                         device=None) -> torch.Tensor:
    """[num_steps + 1] descending f32 step values ending at `end`.
    method: linear | quadratic | exponential | karras. "karras" is
    rho-spacing in the sigma domain, mapped back through
    `timesteps_from_sigmas` when `schedule` has both ``sigmas`` and that;
    otherwise the t-domain approximation. Both endpoints are pinned exactly
    (flaxdiff_tpu/samplers/common.py:35-84). Computed on the CPU and moved
    to `device` once, so every device steps through the same values."""
    hi = float(timesteps - 1) if start is None else float(start)
    lo = float(end)
    n = num_steps + 1
    if method == "linear":
        steps = _linspace_f32(hi, lo, n)
    elif method == "quadratic":
        steps = _linspace_f32(hi ** 0.5, lo ** 0.5, n) ** 2
    elif method == "exponential":
        log = lambda v: float(torch.log(torch.tensor(v, dtype=torch.float32)))
        steps = torch.exp(_linspace_f32(log(hi + 1.0), log(lo + 1.0), n)) - 1.0
    elif method == "karras":
        inv = 1.0 / rho
        if hasattr(schedule, "sigmas") and hasattr(schedule, "timesteps_from_sigmas"):
            ends = _pow_f32(schedule.sigmas(torch.tensor([hi, lo], dtype=torch.float32)), inv)
            steps = schedule.timesteps_from_sigmas(
                _pow_f32(_linspace_f32(ends[0], ends[1], n), rho))
        else:
            steps = _pow_f32(_linspace_f32((hi + 1.0) ** inv, (lo + 1.0) ** inv, n), rho) - 1.0
    else:
        raise ValueError(f"Unknown timestep spacing {method!r}")
    # the nonlinear spacings round-trip hi and lo through f32 powers and
    # logs: the first value could leave the schedule's domain and the last
    # miss `end`, which at 1-3 steps is the whole step budget
    steps[0] = hi
    steps[-1] = lo
    return steps if device is None else steps.to(device)


class NoiseSource:
    """Every random draw of a trajectory: the initial noise, a stochastic
    sampler's per-step noise and inpainting's re-noising, in that order.
    This one draws from a ``torch.Generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.generator.device)


class GivenNoise(NoiseSource):
    """Yields the given arrays in order, moved to `device` up front: the draws
    of another implementation (the JAX engine's key sequence), so both run
    one trajectory. Raises when the draws run out or a shape differs."""

    def __init__(self, arrays, device=None):
        self.arrays = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]
        self.used = 0

    def normal(self, shape):
        if self.used == len(self.arrays):
            raise IndexError(f"draw {self.used + 1} asked of {len(self.arrays)} given")
        a = self.arrays[self.used]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"draw {self.used + 1}: given {tuple(a.shape)}, "
                             f"asked {tuple(shape)}")
        self.used += 1
        return a


class Sampler:
    """A sampler is a step function over the VE-ified state. `step` gets
    `denoise(x, t) -> (x0_hat, eps_hat)` so higher-order samplers can take
    several model calls per step, and draws any noise from `noise`. A step
    branches on no tensor value and reads none back, so the loop never
    waits on the card."""

    def init_state(self, x: torch.Tensor) -> Any:
        """Extra carried state (e.g. multistep history). Default: none."""
        return ()

    def step(self, denoise: Callable, x: torch.Tensor, t_cur: torch.Tensor,
             t_next: torch.Tensor, noise: NoiseSource, state: Any,
             schedule: NoiseSchedule, step_index: int) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    @staticmethod
    def _coords(schedule: NoiseSchedule, t: torch.Tensor, ndim: int):
        signal, sigma = schedule.rates(t)
        signal = bcast_right(signal, ndim)
        sigma = bcast_right(sigma, ndim)
        return signal, sigma / torch.clamp_min(signal, 1e-12)


def _resize_nearest(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the [..., H, W, C] mask's H and W with half-pixel
    centres, in ``jax.image.resize``'s f32 index math: source index
    floor((i + 0.5) * in / out). torch's ``nearest`` mode has no half pixel."""
    for dim, n in zip((-3, -2), size):
        m = mask.shape[dim]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long()
            mask = mask.index_select(dim % mask.ndim, idx.to(mask.device))
    return mask


class DiffusionSampler:
    """Trajectory generation with optional classifier-free guidance and
    inpainting.

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

    def _inpaint_inputs(self, reference, mask, shape):
        """(mask, known) as the JAX engine checks and shapes them
        (flaxdiff_tpu/samplers/common.py:584-605): the mask gains a channel
        dim when it has none, is nearest-resized to the sample's H and W and
        broadcast over the sample."""
        if mask is None:
            raise ValueError("inpaint_reference requires inpaint_mask")
        known = torch.as_tensor(reference).to(self.device, torch.float32)
        if tuple(known.shape) != tuple(shape):
            raise ValueError(f"inpaint_reference encodes to {tuple(known.shape)}, "
                             f"expected {tuple(shape)}")
        mask = torch.as_tensor(mask).to(self.device, torch.float32)
        if mask.ndim == known.ndim - 1:
            mask = mask[..., None]
        elif mask.ndim != known.ndim:
            raise ValueError(f"inpaint_mask rank {mask.ndim} incompatible with sample rank "
                             f"{known.ndim} (pass [batch, (frames,) H, W] or with a trailing "
                             f"channel dim)")
        mask = _resize_nearest(mask, tuple(known.shape[-3:-1]))
        return mask.expand(known.shape), known

    @torch.inference_mode()
    def generate_samples(self, num_samples: int = 4, resolution: int = 64,
                         diffusion_steps: int = 50,
                         generator: "torch.Generator | NoiseSource | None" = None,
                         conditioning: Optional[torch.Tensor] = None,
                         unconditional: Optional[torch.Tensor] = None,
                         init_samples: Optional[torch.Tensor] = None,
                         start_step: Optional[float] = None, end_step: float = 0.0,
                         sequence_length: Optional[int] = None, channels: int = 3,
                         inpaint_reference: Optional[torch.Tensor] = None,
                         inpaint_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the trajectory; returns samples [N, R, R, C] clipped to [-1, 1],
        or [N, T, R, R, C] with a `sequence_length`.

        Every random draw comes from `generator`: a ``torch.Generator``
        (default: seed 42 on the sampler's device) or a `NoiseSource`.
        Inpainting: `inpaint_reference` in [-1, 1] at the sample's shape and
        `inpaint_mask` (1 generates, 0 keeps the reference; [N, (T,) H, W],
        with or without a channel dim, nearest-resized to the sample's H, W).
        After each step the kept region is the reference re-noised to the
        step's level; the output keeps the reference itself there."""
        dev = self.device
        if generator is None:
            generator = make_generator(42, dev)
        noise = generator if isinstance(generator, NoiseSource) else NoiseSource(generator)
        if sequence_length is not None:
            shape = (num_samples, sequence_length, resolution, resolution, channels)
        else:
            shape = (num_samples, resolution, resolution, channels)
        inpaint = inpaint_reference is not None
        if inpaint:
            mask, known = self._inpaint_inputs(inpaint_reference, inpaint_mask, shape)
        if init_samples is None:
            x = noise.normal(shape) * self.schedule.max_noise_std()
        else:
            x = init_samples.to(dev, torch.float32)
        cond = None if conditioning is None else conditioning.to(dev)
        uncond = None if unconditional is None else unconditional.to(dev)
        steps = get_timestep_spacing(self.timestep_spacing, diffusion_steps,
                                     self.schedule.timesteps, start_step, end_step,
                                     schedule=self.schedule, device=dev)
        denoise = self._denoise_fn(cond, uncond)
        state = self.sampler.init_state(x)
        for i in range(diffusion_steps):
            x, state = self.sampler.step(denoise, x, steps[i], steps[i + 1], noise,
                                         state, self.schedule, i)
            if inpaint:
                known_t = self.schedule.add_noise(known, noise.normal(known.shape),
                                                  steps[i + 1].expand(x.shape[0]))
                x = mask * x + (1.0 - mask) * known_t
        # terminal denoise: a plain model call at the final step value
        x0, _ = denoise(x, steps[-1])
        if inpaint:
            x0 = mask * x0 + (1.0 - mask) * known
        return clip_images(x0)

    generate_images = generate_samples


__all__ = ["DiffusionSampler", "GivenNoise", "NoiseSource", "Sampler",
           "get_timestep_spacing"]
