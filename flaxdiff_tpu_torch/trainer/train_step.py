"""The diffusion train step (counterpart of ``flaxdiff_tpu/trainer/train_step.py``).

normalize -> CFG dropout splice -> forward diffusion -> weighted MSE in f32
-> gradients -> AdamW -> EMA -> elementwise non-finite gate. The JAX step
draws its noise, timesteps and dropout mask from a key folded with the step;
here the step takes them as arguments, so a test can hand both the same
draws and ``DiffusionTrainer`` draws them from a ``torch.Generator``.

Not ported: fp16 loss scaling, the numerics aux, the loss ring and the
gate counter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

from ..predictors import PredictionTransform
from ..schedulers.common import NoiseSchedule, bcast_right
from ..utils import cfg_uncond_splice, normalize_images
from .train_state import TrainState

Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    uncond_prob: float = 0.12          # CFG dropout
    ema_decay: float = 0.999
    normalize: bool = True             # uint8 (x - 127.5) / 127.5 inside the step
    weighted_loss: bool = True         # the schedule's loss weights


def make_loss_builder(schedule: NoiseSchedule, transform: PredictionTransform,
                      config: TrainStepConfig = TrainStepConfig(),
                      null_cond: Optional[torch.Tensor] = None) -> Callable:
    """``build(batch, noise, t, uncond_mask) -> loss_fn(model)``, as
    ``_make_loss_builder`` (train_step.py:45-109) but with the draws given.
    Batch: {"sample": [B, H, W, C] uint8 or float, "cond": optional [B, L, D]
    text context}; null_cond: the [1, L, D] null context CFG dropout puts in
    place of a dropped sample's."""

    def build(batch: Batch, noise: torch.Tensor, t: torch.Tensor,
              uncond_mask: Optional[torch.Tensor] = None):
        x0 = batch["sample"]
        x0 = normalize_images(x0) if config.normalize else x0.float()
        cond = batch.get("cond")
        if cond is not None and null_cond is not None and config.uncond_prob > 0:
            if uncond_mask is None:
                raise ValueError("CFG dropout needs an uncond_mask draw")
            cond = cfg_uncond_splice(cond, null_cond, uncond_mask)
        x_t, target = transform.forward(schedule, x0, noise, t)
        t_f = t.float()
        c_in = bcast_right(transform.input_scale(schedule, t), x_t.ndim)
        x_in, t_in = schedule.transform_inputs(x_t * c_in, t_f)
        weights = schedule.loss_weights(t) if config.weighted_loss else torch.ones_like(t_f)

        def loss_fn(model: Callable) -> torch.Tensor:
            raw = model(x_in, t_in, cond).float()
            pred = transform.transform_output(x_t, t_f, raw, schedule)
            per_sample = ((pred - target) ** 2).mean(dim=tuple(range(1, pred.ndim)))
            return (per_sample * weights).mean()

        return loss_fn

    return build


def make_train_step(schedule: NoiseSchedule, transform: PredictionTransform,
                    config: TrainStepConfig = TrainStepConfig(),
                    null_cond: Optional[torch.Tensor] = None,
                    gate_nonfinite: bool = False) -> Callable:
    """``step(state, batch, noise, t, uncond_mask) -> loss``: one update of
    ``state`` in place. With ``gate_nonfinite`` a non-finite element of the
    new params, moments or EMA keeps its old value (``_finite_only_gate``)."""
    build = make_loss_builder(schedule, transform, config, null_cond)

    def train_step(state: TrainState, batch: Batch, noise: torch.Tensor, t: torch.Tensor,
                   uncond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = build(batch, noise, t, uncond_mask)(state.model)
        state.apply_gradients(state.grads(loss), config.ema_decay, gate_nonfinite)
        return loss.detach()

    return train_step
