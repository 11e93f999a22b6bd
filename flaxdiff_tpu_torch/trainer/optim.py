"""The training CLI's optimizer chain (counterpart of ``train.py:456-503``):
``optax.chain(clip_by_global_norm(max_norm), adam|adamw|lamb(schedule))``,
optionally inside ``optax.MultiSteps(every_k_schedule=k)``, over the train
state's flat f32 buffers.

optax's order of operations is kept: the global-norm clip, Adam's moments
and bias corrections at the incremented count, adamw's decoupled weight
decay, lamb's per-leaf trust ratio, then the learning rate, a schedule
evaluated at the optimizer's count BEFORE the increment (so a warmup from 0
makes the first update exactly zero). The clip is a select on the device,
never a host read. ``TrainState.apply_gradients`` runs the chain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: a linear ramp from
    `init_value` to `peak_value` over `warmup_steps`, then a cosine decay to
    `end_value` by `decay_steps` (the warmup included), in f32 as optax
    computes it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    f32 = np.float32
    # Python-float constants round to f32 where they meet an f32 array, as
    # JAX's weak types do
    rise, peak = f32(init_value - peak_value), f32(peak_value)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(rise * frac + peak)
        c = min(f32(count - warmup_steps), cos_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / cos_steps))
        return float(peak * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` with its defaults: decoupled weight decay on every
    parameter, at optax's 1e-4 (torch's own AdamW defaults to 1e-2).
    ``weight_decay=0`` is ``optax.adam``; ``trust_ratio=True`` scales each
    parameter's update by ||p|| / ||u|| after the weight decay (1 where
    either norm is 0), which is ``optax.lamb``. `learning_rate` is a float
    or a schedule of the optimizer's count."""

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    trust_ratio: bool = False

    def lr(self, count: int) -> float:
        """The learning rate of the update made at `count` earlier updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else lr


def adam(learning_rate: Union[float, Schedule], **kwargs) -> AdamW:
    return AdamW(learning_rate, weight_decay=0.0, **kwargs)


def adamw(learning_rate: Union[float, Schedule], **kwargs) -> AdamW:
    return AdamW(learning_rate, **kwargs)


def lamb(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.0) -> AdamW:
    """``optax.lamb`` with its defaults: scale_by_adam (eps 1e-6), the
    weight decay (0), the trust ratio per parameter, then the learning
    rate. Each torch parameter of the flat layout is one flax leaf (the
    converter only reshapes, transposes and flips, which keep a norm), so
    the per-parameter norms are optax's per-leaf ones."""
    return AdamW(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 trust_ratio=True)


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    """``optax.clip_by_global_norm``: ``select(norm < max_norm, g,
    g / norm * max_norm)``. The flat gradient buffer has the tree's global
    norm, so one vector norm is the whole reduction."""

    max_norm: float

    def __call__(self, grads: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(grads)
        return torch.where(norm < self.max_norm, grads, grads / norm * self.max_norm)


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    return ClipByGlobalNorm(max_norm)


@dataclasses.dataclass(frozen=True)
class Chain:
    """Gradient transforms applied in order, then the Adam update."""

    transforms: Tuple[ClipByGlobalNorm, ...]
    adam: AdamW


def chain(*transforms) -> Chain:
    """``optax.chain``: any gradient transforms, the Adam update last."""
    *pre, last = transforms
    if not isinstance(last, AdamW) or any(isinstance(t, AdamW) for t in pre):
        raise TypeError("chain takes gradient transforms and one AdamW, last")
    return Chain(tuple(pre), last)


@dataclasses.dataclass(frozen=True)
class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with its default
    running mean: each micro-step folds its gradients into the accumulator,
    ``acc + (g - acc) / (n + 1)``, and runs the inner chain on it, but only
    the k-th (the emit step) keeps the chain's state and applies its update;
    the others leave the params unchanged and reset nothing. The train state
    keeps the accumulator and the mini-step as part of the optimizer state."""

    inner: Union[AdamW, Chain]
    every_k: int

    def __post_init__(self):
        if self.every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {self.every_k}")


Optimizer = Union[AdamW, Chain, MultiSteps]


def as_chain(tx: Optimizer) -> Chain:
    """The chain a (possibly accumulating) optimizer runs."""
    if isinstance(tx, MultiSteps):
        tx = tx.inner
    return tx if isinstance(tx, Chain) else Chain((), tx)


def every_k(tx: Optimizer) -> int:
    """Micro-steps per update: MultiSteps' k, else 1."""
    return tx.every_k if isinstance(tx, MultiSteps) else 1

