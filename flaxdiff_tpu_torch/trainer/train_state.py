"""Train state (counterpart of ``flaxdiff_tpu/trainer/train_state.py``): the
module's parameters, an f32 EMA copy, the Adam moments and the step.

The parameters live in one flat f32 buffer that every parameter of the
module views, and the EMA and both moments are flat buffers of the same
layout. The optimizer update, the EMA and the non-finite gate are then a
few elementwise ops over four tensors, not a few per parameter, as the JAX
step fuses them into one program.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from .optim import AdamW, Optimizer, as_chain

__all__ = ["AdamW", "TrainState"]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt, correctly rounded as XLA's is. torch's vectorised CPU sqrt
    is an ulp off in ~0.6% of values, so CPU tensors take it in f64 (exact
    after the one rounding to f32); CUDA's sqrt is IEEE."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


class TrainState:
    """Params (a flat f32 buffer the module's parameters view), EMA, Adam
    moments and the step, which is also the optimizer's count: Adam's bias
    corrections and the learning-rate schedule read it. `tx` is an
    ``AdamW`` or a ``Chain`` of gradient transforms ending in one
    (``trainer/optim.py``)."""

    def __init__(self, model: nn.Module, tx: Optimizer, ema_decay: Optional[float] = 0.999):
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
        """One update of the optimizer chain in optax's order of operations
        (the chain's transforms, Adam at the incremented count, the decoupled
        weight decay, the learning rate at the count before it), then the EMA
        ``ema * decay + params * (1 - decay)`` over the new params
        (train_state.py:71-86). With ``gate_nonfinite`` every element of the
        params, moments and EMA whose new value is not finite keeps its old
        one (train_step.py:154 ``_finite_only_gate``); the step advances
        either way."""
        chain, step = as_chain(self.tx), self.step + 1
        for transform in chain.transforms:
            grads = transform(grads)
        tx = chain.adam
        # f32 bias corrections, as optax computes 1 - decay ** count
        bc1 = float(1.0 - torch.tensor(tx.b1) ** step)
        bc2 = float(1.0 - torch.tensor(tx.b2) ** step)
        mu = (1.0 - tx.b1) * grads + tx.b1 * self.exp_avg
        nu = (1.0 - tx.b2) * (grads * grads) + tx.b2 * self.exp_avg_sq
        update = (mu / bc1) / (_sqrt(nu / bc2) + tx.eps)
        if tx.weight_decay:
            update = update + tx.weight_decay * self.params
        params = self.params + update * (-tx.lr(self.step))
        pairs = [(self.params, params), (self.exp_avg, mu), (self.exp_avg_sq, nu)]
        if self.ema is not None and ema_decay is not None:
            pairs.append((self.ema, self.ema * ema_decay + params * (1.0 - ema_decay)))
        for old, new in pairs:
            old.copy_(torch.where(torch.isfinite(new), new, old) if gate_nonfinite else new)
        self.step = step

    def buffers(self) -> dict[str, Optional[torch.Tensor]]:
        """The flat buffers by name: what a checkpoint or a snapshot holds."""
        return {"params": self.params, "ema": self.ema, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    def state_dict(self) -> dict[str, Any]:
        """Params, EMA, both moments, the step and the layout ([name, shape]
        per parameter, in buffer order), the tensors as they are (no copy)."""
        return {**self.buffers(), "step": self.step,
                "layout": [[name, list(shape)] for name, _, shape in self.layout]}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` into this state's buffers in place (the
        module's parameters stay views of them). Raises when the layout,
        a buffer's size or the EMA's presence differs."""
        layout = [[name, list(shape)] for name, _, shape in self.layout]
        saved = [[name, list(shape)] for name, shape in state["layout"]]
        if saved != layout:
            diff = next(((a, b) for a, b in zip(saved, layout) if a != b),
                        (len(saved), len(layout)))
            raise ValueError(f"checkpoint layout differs from the model's: {diff}")
        for name, buf in self.buffers().items():
            src = state[name]
            if (buf is None) != (src is None):
                raise ValueError(f"{name}: the checkpoint has {'no ' * (src is None)}{name}, "
                                 f"the state {'none' if buf is None else 'one'}")
            if buf is not None:
                if src.shape != buf.shape:
                    raise ValueError(f"{name}: shape {tuple(src.shape)}, want {tuple(buf.shape)}")
                buf.copy_(src)
        self.step = int(state["step"])
