"""Validation: a sample grid from the EMA params (counterpart of
``flaxdiff_tpu/trainer/validation.py``): 8 samples, 200 steps of
``EulerAncestralSampler`` with guidance 3.0, from a generator of seed 42,
then the given metrics (``metrics/``: PSNR, SSIM, FID) against a batch of
real images, each one's best tracked with its direction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import make_generator
from ..metrics import EvaluationMetric, MetricTracker
from ..samplers import DiffusionSampler, EulerAncestralSampler, Sampler
from ..utils import denormalize_images


@dataclasses.dataclass
class ValidationConfig:
    num_samples: int = 8
    diffusion_steps: int = 200
    guidance_scale: float = 3.0
    resolution: int = 64
    channels: int = 3
    sequence_length: Optional[int] = None   # video when set
    seed: int = 42


class Validator:
    """Generates samples from given params of `model` (the EMA copy, from
    ``DiffusionTrainer.get_params()``) through the port's sampler; with a
    codec the grid is decoded (``resolution`` and ``channels`` are the
    pixels')."""

    def __init__(self, model: torch.nn.Module, schedule, transform,
                 config: Optional[ValidationConfig] = None, sampler: Optional[Sampler] = None,
                 device=None, autoencoder=None, metrics: Sequence[EvaluationMetric] = ()):
        self.config = config if config is not None else ValidationConfig()
        self.metrics = list(metrics)
        self.tracker = MetricTracker()
        self.model = model
        self._params: Mapping[str, torch.Tensor] = {}
        self.sampler = DiffusionSampler(
            model_fn=lambda x, t, cond: torch.func.functional_call(self.model, self._params,
                                                                   (x, t, cond)),
            schedule=schedule, transform=transform,
            sampler=sampler if sampler is not None else EulerAncestralSampler(),
            guidance_scale=self.config.guidance_scale, device=device, autoencoder=autoencoder)

    def run(self, params: Mapping[str, torch.Tensor],
            conditioning: Optional[torch.Tensor] = None,
            unconditional: Optional[torch.Tensor] = None,
            batch: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """A validation grid from `params` (name -> tensor, the model's
        parameters replaced for the calls), scored by each metric against
        `batch` (real images under "sample"): {"samples": [N, R, R, C] numpy
        in [-1, 1], "metrics": {name: value}, "improved": {name: new best}}."""
        cfg = self.config
        self._params = params
        try:
            samples = self.sampler.generate_samples(
                num_samples=cfg.num_samples, resolution=cfg.resolution,
                diffusion_steps=cfg.diffusion_steps,
                generator=make_generator(cfg.seed, self.sampler.device),
                sequence_length=cfg.sequence_length, channels=cfg.channels,
                conditioning=conditioning, unconditional=unconditional)
        finally:
            self._params = {}
        samples = samples.float().cpu().numpy()
        results, improved = {}, {}
        for metric in self.metrics:
            value = float(metric.function(samples, batch))
            results[metric.name] = value
            improved[metric.name] = self.tracker.update(metric.name, value,
                                                        metric.higher_is_better)
        return {"samples": samples, "metrics": results, "improved": improved}

    @staticmethod
    def to_uint8(samples: np.ndarray) -> np.ndarray:
        """[-1, 1] floats -> uint8 images for logging."""
        return denormalize_images(torch.as_tensor(samples)).numpy()
