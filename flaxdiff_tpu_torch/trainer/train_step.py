"""The diffusion train step (counterpart of ``flaxdiff_tpu/trainer/train_step.py``).

normalize -> the codec's encode (latent diffusion, the codec frozen) -> CFG
dropout splice -> forward diffusion -> weighted MSE in f32
-> gradients (of the scaled loss under a float16 loss scale) -> the
optimizer chain -> the loss scale's restore -> EMA -> the loss ring -> the
non-finite gate (elementwise, or the monitored step's global verdict) and
its counter. The JAX step draws its noise, timesteps and dropout mask from a
key folded with the step; here the step takes them as arguments, so a test
can hand both the same draws and ``DiffusionTrainer`` draws them from a
``torch.Generator``. With a codec the posterior sample's noise is one more
such draw (the JAX step's ``vae_key``, the fourth of the step's keys).

With a ``NumericsConfig`` the step is the monitored twin: it also returns
the health aux (``telemetry/numerics.py``).

Under a mesh (the state's) the step fills the module's params from the fsdp
slices first, its gradients are the slice of their mean over the data x
fsdp ranks (``TrainState.grads``), the loss scale's verdict is one for the
world, and the returned loss is the global batch's mean, all-reduced on the
device with no host read.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

from ..predictors import PredictionTransform
from ..schedulers.common import NoiseSchedule, bcast_right
from ..telemetry.numerics import (NumericsConfig, module_segments, numerics_aux,
                                  tree_nonfinite_count)
from ..typing import Policy
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
                      null_cond: Optional[torch.Tensor] = None,
                      policy: Optional[Policy] = None, autoencoder=None) -> Callable:
    """``build(batch, noise, t, uncond_mask, vae_noise) -> loss_fn(model)``,
    as ``_make_loss_builder`` (train_step.py:45-109) but with the draws given.
    Batch: {"sample": [B, (T,) H, W, C] uint8 or float, "cond": optional
    [B, L, D] text context}; null_cond: the [1, L, D] null context CFG dropout
    puts in place of a dropped sample's; `policy`: the network's input goes in
    its compute dtype (the model casts its parameters to its own dtype).
    `autoencoder`: the normalized sample is encoded without gradients, the
    posterior sampled with `vae_noise` (of the posterior mean's shape; its
    mean without), and `noise` has the latent's shape."""

    def build(batch: Batch, noise: torch.Tensor, t: torch.Tensor,
              uncond_mask: Optional[torch.Tensor] = None,
              vae_noise: Optional[torch.Tensor] = None):
        x0 = batch["sample"]
        x0 = normalize_images(x0) if config.normalize else x0.float()
        if autoencoder is not None:
            with torch.no_grad():
                x0 = autoencoder.encode(x0, vae_noise)
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

        x_net = x_in if policy is None else policy.cast_to_compute(x_in)

        def loss_fn(model: Callable) -> torch.Tensor:
            raw = model(x_net, t_in, cond).float()
            pred = transform.transform_output(x_t, t_f, raw, schedule)
            per_sample = ((pred - target) ** 2).mean(dim=tuple(range(1, pred.ndim)))
            return (per_sample * weights).mean()

        return loss_fn

    return build


def make_train_step(schedule: NoiseSchedule, transform: PredictionTransform,
                    config: TrainStepConfig = TrainStepConfig(),
                    null_cond: Optional[torch.Tensor] = None,
                    gate_nonfinite: bool = False, policy: Optional[Policy] = None,
                    numerics: Optional[NumericsConfig] = None, autoencoder=None) -> Callable:
    """``step(state, batch, noise, t, uncond_mask, vae_noise) -> loss`` (with
    `numerics`: ``(loss, aux)``): one update of ``state`` in place
    (train_step.py:242-301).

    With ``state.dynamic_scale`` the gradients are those of ``scale * loss``
    divided by the scale in f32, one verdict says whether all of them are
    finite, the scale moves by flax's rules and the update is kept out of
    the params and optimizer state where the verdict is False. The plain
    step with ``gate_nonfinite`` keeps the old value of every non-finite
    element of the new params, optimizer state and EMA
    (``_finite_only_gate``); the monitored step gates, when
    ``gate_nonfinite`` or ``numerics.skip_nonfinite``, on one verdict that
    every gradient and the loss are finite (``_nonfinite_gate``), and its aux
    then has ``skipped``."""
    build = make_loss_builder(schedule, transform, config, null_cond, policy, autoencoder)

    def train_step(state: TrainState, batch: Batch, noise: torch.Tensor, t: torch.Tensor,
                   uncond_mask: Optional[torch.Tensor] = None,
                   vae_noise: Optional[torch.Tensor] = None):
        if numerics is not None and state.mesh is not None:
            raise ValueError("the monitored step's norms over a sharded state are not ported "
                             "(ROADMAP.md A12's second half)")
        loss_fn = build(batch, noise, t, uncond_mask, vae_noise)
        scale, finite = state.dynamic_scale, None
        state.gather_params()
        if scale is not None:
            scaled = loss_fn(state.model) * scale.scale
            grads = state.grads(scaled) / scale.scale
            loss = state.mean_over_batch(scaled.detach() / scale.scale)
            finite = state.all_ranks(torch.isfinite(grads).all())
            scale.update(finite)
        else:
            loss = loss_fn(state.model)
            grads = state.grads(loss)
            loss = state.mean_over_batch(loss.detach())
        if numerics is None:
            state.apply_gradients(grads, config.ema_decay, gate_nonfinite, finite=finite,
                                  loss=loss)
            return loss
        before = state.params.clone()
        verdict = None
        if numerics.skip_nonfinite or gate_nonfinite:
            verdict = (tree_nonfinite_count(grads) == 0) & torch.isfinite(loss)
        state.apply_gradients(grads, config.ema_decay, finite=finite, loss=loss, verdict=verdict)
        aux = numerics_aux(loss, grads, before, state.params,
                           module_segments(state.layout) if numerics.per_module else None)
        if verdict is not None:
            aux["skipped"] = (~verdict).float()
        return loss, aux

    return train_step
