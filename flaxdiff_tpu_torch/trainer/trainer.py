"""A minimal diffusion trainer (counterpart of the step-driving part of
``flaxdiff_tpu/trainer/trainer.py``): it owns the train state and a seeded
``torch.Generator`` on the device, draws each step's noise, timesteps and
CFG-dropout mask there, and runs the step. The fit loop, checkpoints,
telemetry and meshes come later.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, make_generator, resolve_device
from ..predictors import PredictionTransform
from ..schedulers.common import NoiseSchedule
from .train_state import AdamW, TrainState
from .train_step import TrainStepConfig, make_train_step


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    uncond_prob: float = 0.12
    ema_decay: float = 0.999
    normalize: bool = True
    weighted_loss: bool = True
    gate_nonfinite: bool = True
    seed: int = 0                      # of the default generator


class DiffusionTrainer:
    """model(x, t, cond) -> raw output, with f32 parameters (its compute
    dtype is its own); it is moved to ``device`` (CUDA unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, model: nn.Module, optimizer: AdamW, schedule: NoiseSchedule,
                 transform: PredictionTransform, config: TrainerConfig = TrainerConfig(),
                 null_cond: Optional[torch.Tensor] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.config = config
        self.schedule = schedule.to(self.device)
        self.state = TrainState(model.to(self.device), optimizer, config.ema_decay)
        self.generator = make_generator(config.seed, self.device) if generator is None \
            else generator
        null = None if null_cond is None else torch.as_tensor(null_cond).to(self.device)
        self._step = make_train_step(
            self.schedule, transform,
            TrainStepConfig(uncond_prob=config.uncond_prob, ema_decay=config.ema_decay,
                            normalize=config.normalize, weighted_loss=config.weighted_loss),
            null_cond=null, gate_nonfinite=config.gate_nonfinite)

    def train_step(self, batch: Mapping[str, "torch.Tensor | np.ndarray"]) -> torch.Tensor:
        """One step on {"sample": [B, H, W, C], "cond": optional [B, L, D]};
        returns the loss as a tensor on the device (no host sync)."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items() if v is not None}
        x = batch["sample"]
        gen, dev = self.generator, self.device
        noise = torch.randn(x.shape, generator=gen, device=dev)
        t = self.schedule.sample_timesteps(gen, x.shape[0])
        uncond_mask = torch.rand(x.shape[0], generator=gen, device=dev) < self.config.uncond_prob
        return self._step(self.state, batch, noise, t, uncond_mask)

    def get_params(self, use_ema: bool = True) -> dict[str, torch.Tensor]:
        """Parameter name -> tensor: the EMA copy, or the live parameters."""
        flat = self.state.ema if use_ema and self.state.ema is not None else self.state.params
        return {name: t.detach() for name, t in self.state.views(flat).items()}
