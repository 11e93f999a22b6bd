"""Sampler engine (counterpart of ``flaxdiff_tpu/samplers/common.py``).

The trajectory is a Python loop under ``torch.inference_mode()``: one model
call per step (two batches in one call with classifier-free guidance), then a
terminal denoise at the last step value. Samplers update in the VE-ified
coordinates x / signal(t), sigma(t) / signal(t), as the JAX package does.
With a codec the trajectory runs in its latent space and the result is
decoded (a clip's frames folded through the codec).

With a cache plan (``ops/diffcache.py``, ``ops/spatialcache.py``) each step
picks its forward on the host from the plan's numpy row: record or reuse
under a `CachePlan`, record_ref, spatial or reuse under a `ComposedPlan`;
the taps (and the score reference) are carried across steps.

The serving programs (``make_chunk_program``, ``make_cached_chunk_program``,
``make_terminal_program``) advance a batch of
requests by one round of continuous batching: the batch axis holds each
request's block of samples, every step takes per-sample t vectors and a
live mask, and each row draws from its own `NoiseSource` (`RowNoise`), so a
batched request follows its solo trajectory. A round reads nothing back
from the card and has static shapes for its program key, so it could be
captured as a CUDA graph (later work, ROADMAP.md A1).
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


class RowNoise(NoiseSource):
    """The draws of a serving round: row j's k samples from its own source
    on the steps it is live; zeros for a padding row and for a step past a
    row's last, which keep the row's source where its solo run leaves it.
    The round sets `live` (per row, host bools) before each step."""

    def __init__(self, sources, k: int, device=None):
        self.sources = list(sources)
        self.k = int(k)
        self.device = device
        self.live = [True] * len(self.sources)

    def normal(self, shape):
        rest = tuple(shape[1:])
        if shape[0] != self.k * len(self.sources):
            raise ValueError(f"draw of {tuple(shape)} for {len(self.sources)} rows of {self.k}")
        parts = [src.normal((self.k,) + rest) if src is not None and live
                 else torch.zeros((self.k,) + rest, device=self.device)
                 for src, live in zip(self.sources, self.live)]
        return torch.cat(parts)


def select_rows(act: torch.Tensor, new: Any, old: Any) -> Any:
    """`new` where the [B] mask `act` is set, else `old`, leaf by leaf over
    tuples and lists of [B, ...] tensors (a sampler's state)."""
    if isinstance(new, torch.Tensor):
        return torch.where(bcast_right(act, new.ndim), new, old)
    return type(new)(select_rows(act, a, b) for a, b in zip(new, old))


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
    `autoencoder`: latent diffusion (``models/autoencoder.py``); the
    trajectory runs at the codec's latent resolution and channels and its
    result is decoded.
    """

    def __init__(self, model_fn: Callable, schedule: NoiseSchedule,
                 transform: PredictionTransform, sampler: Sampler,
                 guidance_scale: float = 0.0, clip_denoised: bool = False,
                 timestep_spacing: str = "linear", device: DeviceLike = None,
                 autoencoder=None, cache_plan=None, cache_fns=None):
        self.device = resolve_device(device)
        self.autoencoder = autoencoder
        self.model_fn = model_fn
        self.schedule = schedule.to(self.device)
        self.transform = transform
        self.sampler = sampler
        self.guidance_scale = float(guidance_scale)
        self.clip_denoised = clip_denoised
        self.timestep_spacing = timestep_spacing
        # the training-free caches: a static plan and the model's cache_mode
        # closures (a (record, reuse) pair or a ComposedCacheFns); without
        # both the loop is the plain one
        self.cache_plan = cache_plan
        self.cache_fns = cache_fns

    @property
    def cache_active(self) -> bool:
        return (self.cache_plan is not None and getattr(self.cache_plan, "enabled", False)
                and self.cache_fns is not None)

    @property
    def spatial_active(self) -> bool:
        """True when the plan composes the spatial token axis on the timestep
        cache: it carries a `spatial` sub-plan and the closures the
        record_ref and spatial forwards."""
        return (self.cache_active and getattr(self.cache_plan, "spatial", None) is not None
                and hasattr(self.cache_fns, "spatial"))

    def _denoise_fn(self, cond, uncond, model_fn: Optional[Callable] = None):
        """`denoise(x, t) -> (x0, eps)` through `model_fn` (default: the
        model) with CFG, the transform and the optional clip. Every cache
        mode goes through this one function, so a record step's math is the
        plain step's."""
        schedule, transform = self.schedule, self.transform
        use_cfg = self.guidance_scale > 0.0 and uncond is not None
        model_fn = self.model_fn if model_fn is None else model_fn

        def denoise(x, t):
            t_b = t.expand(x.shape[0]).to(torch.float32)
            c_in = bcast_right(transform.input_scale(schedule, t_b), x.ndim)
            x_in, t_in = schedule.transform_inputs(x * c_in, t_b)
            if use_cfg:
                raw = model_fn(torch.cat([x_in, x_in]), torch.cat([t_in, t_in]),
                               torch.cat([cond, uncond]))
                raw_c, raw_u = raw.chunk(2)
                raw = raw_u + self.guidance_scale * (raw_c - raw_u)
            else:
                raw = model_fn(x_in, t_in, cond)
            pred = transform.transform_output(x, t_b, raw.float(), schedule)
            x0, eps = transform.to_x0_eps(x, t_b, pred, schedule)
            if self.clip_denoised:
                x0 = clip_images(x0)
                signal, sigma = schedule.rates(t_b)
                eps = (x - bcast_right(signal, x.ndim) * x0) / torch.clamp_min(
                    bcast_right(sigma, x.ndim), 1e-12)
            return x0, eps

        return denoise

    def _mode_denoisers(self, cond, uncond, carry: dict) -> dict:
        """The cached loop's denoisers by mode, each reading and writing the
        one `carry` of taps (and the score reference): {True: record, False:
        reuse} under a `CachePlan`, {CODE_REFRESH: record_ref, CODE_SPATIAL:
        spatial, CODE_REUSE: reuse} under a `ComposedPlan`."""
        fns = self.cache_fns

        def record(x, t, c):
            raw, carry["taps"] = fns[0](x, t, c)
            return raw

        def reuse(x, t, c):
            return fns[1](x, t, c, carry["taps"])

        if not self.spatial_active:
            return {True: self._denoise_fn(cond, uncond, record),
                    False: self._denoise_fn(cond, uncond, reuse)}
        from ..ops.spatialcache import CODE_REFRESH, CODE_REUSE, CODE_SPATIAL

        def record_ref(x, t, c):
            raw, carry["taps"], carry["ref"] = fns.record_ref(x, t, c)
            return raw

        def spatial(x, t, c):
            raw, carry["taps"], carry["ref"] = fns.spatial(x, t, c, carry["taps"], carry["ref"])
            return raw

        return {CODE_REFRESH: self._denoise_fn(cond, uncond, record_ref),
                CODE_SPATIAL: self._denoise_fn(cond, uncond, spatial),
                CODE_REUSE: self._denoise_fn(cond, uncond, reuse)}

    def _step_denoisers(self, cond, uncond, num_steps: int):
        """One `denoise` per step of the trajectory. Uncached: the plain one
        for every step. Cached: the step's mode from the plan's host row
        (flags, or codes under a composed plan), each mode's denoiser
        reading and writing one carry of taps (and the score reference).
        A multi-evaluation sampler step (Heun, RK4) calls its denoiser
        several times: on a refresh step each call records again, on a
        cached step each reuses the newest taps. Step 0 always refreshes,
        so the carry starts empty; this replaces the JAX engine's
        ``cache_taps_init`` / ``cache_carry_init``, whose zeros exist only to
        give ``lax.scan`` a carry shape."""
        if not self.cache_active:
            return [self._denoise_fn(cond, uncond)] * num_steps
        modes = self._mode_denoisers(cond, uncond, {})
        if not self.spatial_active:
            return [modes[bool(f)] for f in self.cache_plan.flags(num_steps)]
        return [modes[int(c)] for c in self.cache_plan.step_codes(num_steps)]

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
        or [N, T, R, R, C] with a `sequence_length`. With a codec, R and C
        are the pixels' (the trajectory runs at R / its downscale factor in
        its latent channels) and the result is decoded; inpainting's reference
        is encoded (its posterior mean) and the mask resized to the latent
        grid.

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
        codec = self.autoencoder
        if codec is not None:
            resolution = resolution // codec.downscale_factor
            channels = codec.latent_channels
        if sequence_length is not None:
            shape = (num_samples, sequence_length, resolution, resolution, channels)
        else:
            shape = (num_samples, resolution, resolution, channels)
        inpaint = inpaint_reference is not None
        if inpaint:
            if codec is not None:
                inpaint_reference = codec.encode(torch.as_tensor(inpaint_reference).to(
                    dev, torch.float32))
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
        x0 = self.run_loop(x, steps, noise, cond, uncond,
                           (mask, known) if inpaint else None)
        if codec is not None:
            x0 = codec.decode(x0)
        return clip_images(x0)

    generate_images = generate_samples

    def run_loop(self, x: torch.Tensor, steps: torch.Tensor, noise: NoiseSource,
                 cond: Optional[torch.Tensor] = None, uncond: Optional[torch.Tensor] = None,
                 inpaint: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """The trajectory from `x` over `steps` (on the device), then the
        terminal denoise, a plain model call at the last step value; returns
        x0 before the codec and the clip. `inpaint`: (mask, known). Nothing
        here reads a value back from the card."""
        denoisers = self._step_denoisers(cond, uncond, len(steps) - 1)
        state = self.sampler.init_state(x)
        for i, denoise in enumerate(denoisers):
            x, state = self.sampler.step(denoise, x, steps[i], steps[i + 1], noise,
                                         state, self.schedule, i)
            if inpaint is not None:
                mask, known = inpaint
                known_t = self.schedule.add_noise(known, noise.normal(known.shape),
                                                  steps[i + 1].expand(x.shape[0]))
                x = mask * x + (1.0 - mask) * known_t
        x0, _ = self._denoise_fn(cond, uncond)(x, steps[-1])
        if inpaint is not None:
            mask, known = inpaint
            x0 = mask * x0 + (1.0 - mask) * known
        return x0

    # -- serving programs ------------------------------------------------------
    # Builders for the serving engine's continuous-batching rounds
    # (serving/engine.py), which owns the program cache and its hit and miss
    # counters. The batch axis holds R rows of k samples each (a request's
    # num_samples). Per round the engine uploads one [round_steps, 4, R*k]
    # tensor `meta`: each sample's t_cur, t_next, global step index and live
    # flag (1 while the row has steps left), and passes `live`, the same
    # flags per row on the host, for the draws. A step past a row's last
    # keeps its carry (x, sampler state, cache carry) unchanged.

    def trajectory_inputs(self, num_steps: int, start: Optional[float] = None,
                          end: float = 0.0) -> Tuple[torch.Tensor, float]:
        """Host-side per-request constants of the serving programs:
        ([num_steps, 2] f32 (t_cur, t_next) pairs on the CPU, the terminal
        step value), the spacing the solo loop steps through."""
        steps = get_timestep_spacing(self.timestep_spacing, num_steps, self.schedule.timesteps,
                                     start, end, schedule=self.schedule)
        return torch.stack([steps[:-1], steps[1:]], dim=1), float(steps[-1])

    def _round(self, round_steps: int, step_denoise):
        """The loop every chunk program shares: `step_denoise(i)` is step
        i's denoiser over the whole batch."""
        sampler, schedule = self.sampler, self.schedule

        def run(x, noise, meta, live, state):
            for i in range(round_steps):
                noise.live = live[i]
                x_n, s_n = sampler.step(step_denoise(i), x, meta[i, 0], meta[i, 1], noise,
                                        state, schedule, meta[i, 2])
                act = meta[i, 3] > 0
                x = torch.where(bcast_right(act, x.ndim), x_n, x)
                state = select_rows(act, s_n, state)
            return x, state

        return run

    def make_chunk_program(self, round_steps: int):
        """One round: advance every row by up to `round_steps` of ITS OWN
        trajectory, one model call per step over the whole batch (with CFG,
        [cond; uncond] stacked as in the solo loop).

        program(x, noise, meta, live, cond, uncond, state) -> (x, state)
          x       [R*k, ...]    the rows' carries
          noise   RowNoise       each row's own draws
          meta    [round_steps, 4, R*k] on the device (see above)
          live    [round_steps][R] host bools
          cond, uncond  [R*k, ...] or None
          state   the sampler's state, every leaf [R*k, ...]
        """
        @torch.inference_mode()
        def program(x, noise, meta, live, cond, uncond, state):
            denoise = self._denoise_fn(cond, uncond)
            return self._round(round_steps, lambda i: denoise)(x, noise, meta, live, state)

        return program

    def make_cached_chunk_program(self, round_steps: int):
        """A round under a `CachePlan` or a `ComposedPlan` (the timestep
        cache, or timestep x spatial):

        program(x, noise, meta, live, conds, carries, state, modes)
          conds    per real row, its (cond, uncond) at its solo batch
          carries  per real row, its cache carry (a dict of taps)
          modes    [round_steps] host ints: under a `CachePlan` 1 refresh
                   (record), 0 reuse; under a `ComposedPlan` its codes
                   (CODE_REFRESH / CODE_SPATIAL / CODE_REUSE), the score
                   reference riding each row's carry beside its taps

        The spatial step's token scores average over its batch, so each row
        runs its own model calls, at its solo batch (k, or 2k with CFG), with
        its own carry; the sampler's math still runs over the whole batch. A
        row only calls the model on its live steps (a dead step would
        overwrite its carry), and a step's mode is the round's, shared by
        every row, as in the JAX engine."""
        @torch.inference_mode()
        def program(x, noise, meta, live, conds, carries, state, modes):
            k = x.shape[0] // len(live[0])
            rows = [self._mode_denoisers(c, u, carry) for (c, u), carry in zip(conds, carries)]

            def step_denoise(i):
                def denoise(x_all, t_all):
                    x0s, epss = [], []
                    for j, row in enumerate(rows):
                        sl = slice(j * k, (j + 1) * k)
                        if live[i][j]:
                            x0, eps = row[modes[i]](x_all[sl], t_all[sl])
                        else:
                            x0 = eps = torch.zeros_like(x_all[sl])
                        x0s.append(x0)
                        epss.append(eps)
                    pad = x_all.shape[0] - len(rows) * k
                    if pad:
                        x0s.append(torch.zeros_like(x_all[:pad]))
                        epss.append(torch.zeros_like(x_all[:pad]))
                    return torch.cat(x0s), torch.cat(epss)
                return denoise

            return self._round(round_steps, step_denoise)(x, noise, meta, live, state)

        return program

    def make_terminal_program(self):
        """The solo loop's terminal denoise for rows whose trajectory just
        ended, each at its OWN terminal step value (spacings of different
        NFE need not end on the same value): program(x, t_term, cond,
        uncond) -> x0 before the codec and the clip."""
        @torch.inference_mode()
        def program(x, t_term, cond, uncond):
            x0, _ = self._denoise_fn(cond, uncond)(x, t_term)
            return x0

        return program


__all__ = ["DiffusionSampler", "GivenNoise", "NoiseSource", "RowNoise", "Sampler",
           "get_timestep_spacing", "select_rows"]
