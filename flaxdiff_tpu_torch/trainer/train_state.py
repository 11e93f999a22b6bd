"""Train state (counterpart of ``flaxdiff_tpu/trainer/train_state.py``): the
module's parameters, an f32 EMA copy, the AdamW moments and the step.

The parameters live in one flat f32 buffer that every parameter of the
module views, and the EMA and both moments are flat buffers of the same
layout. The optimizer update, the EMA and the non-finite gate are then a
few elementwise ops over four tensors, not a few per parameter, as the JAX
step fuses them into one program.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` with its defaults: decoupled weight decay on every
    parameter, at optax's 1e-4 (torch's own AdamW defaults to 1e-2)."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4


class TrainState:
    """Params (a flat f32 buffer the module's parameters view), EMA, AdamW
    moments and the step, which is also AdamW's bias-correction count."""

    def __init__(self, model: nn.Module, tx: AdamW, ema_decay: Optional[float] = 0.999):
        params = list(model.named_parameters())
        if any(p.dtype != torch.float32 for _, p in params):
            raise TypeError("the train state keeps f32 parameters")
        self.model, self.tx = model, tx
        self.layout = []          # (name, offset, shape)
        offset = 0
        for name, p in params:
            self.layout.append((name, offset, p.shape))
            offset += p.numel()
        self.params = torch.cat([p.detach().reshape(-1) for _, p in params])
        for (_, p), (_, off, shape) in zip(params, self.layout):
            p.data = self.params[off:off + p.numel()].view(shape)
        self.exp_avg = torch.zeros_like(self.params)
        self.exp_avg_sq = torch.zeros_like(self.params)
        self.ema = self.params.clone() if ema_decay is not None else None
        self.step = 0

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Parameter name -> its view of a flat buffer of this layout."""
        return {name: flat[off:off + shape.numel()].view(shape)
                for name, off, shape in self.layout}

    def flatten(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """A flat buffer of this layout from name -> tensor."""
        return torch.cat([torch.as_tensor(tensors[name], dtype=torch.float32).reshape(-1)
                          for name, _, _ in self.layout]).to(self.params.device)

    def grads(self, loss: torch.Tensor) -> torch.Tensor:
        """d loss / d params as one flat buffer (zeros where unused)."""
        params = [p for p in self.model.parameters()]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(params, grads)])

    def apply_gradients(self, grads: torch.Tensor, ema_decay: Optional[float],
                        gate_nonfinite: bool = False) -> None:
        """One AdamW step in optax's order of operations, then the EMA
        ``ema * decay + params * (1 - decay)`` over the new params
        (train_state.py:71-86). With ``gate_nonfinite`` every element of the
        params, moments and EMA whose new value is not finite keeps its old
        one (train_step.py:154 ``_finite_only_gate``); the step advances
        either way."""
        tx, step = self.tx, self.step + 1
        # f32 bias corrections, as optax computes 1 - decay ** count
        bc1 = float(1.0 - torch.tensor(tx.b1) ** step)
        bc2 = float(1.0 - torch.tensor(tx.b2) ** step)
        mu = (1.0 - tx.b1) * grads + tx.b1 * self.exp_avg
        nu = (1.0 - tx.b2) * (grads * grads) + tx.b2 * self.exp_avg_sq
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + tx.eps) + tx.weight_decay * self.params
        params = self.params + update * (-tx.learning_rate)
        pairs = [(self.params, params), (self.exp_avg, mu), (self.exp_avg_sq, nu)]
        if self.ema is not None and ema_decay is not None:
            pairs.append((self.ema, self.ema * ema_decay + params * (1.0 - ema_decay)))
        for old, new in pairs:
            old.copy_(torch.where(torch.isfinite(new), new, old) if gate_nonfinite else new)
        self.step = step
