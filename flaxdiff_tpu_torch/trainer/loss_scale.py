"""Dynamic loss scaling for float16 compute (counterpart of
``flax.training.dynamic_scale.DynamicScale``, which the JAX trainer keeps
for a float16 policy, ``flaxdiff_tpu/trainer/trainer.py:335-339``).

The train step differentiates ``scale * loss``, divides the f32 gradients
by the scale and takes one finiteness verdict over all of them; the scale
then follows flax's rules: after ``growth_interval`` finite steps in a row
it grows by ``growth_factor`` (``fin_steps`` is compared BEFORE its
increment and resets on growth), and a non-finite step multiplies it by
``backoff_factor`` and resets ``fin_steps``. The step itself restores the
params and the optimizer state of a non-finite step
(``TrainState.apply_gradients``). The scale and the count live on the
device, so a step never waits for the verdict.

This is not ``torch.amp.GradScaler``: that one grows after
``growth_interval`` finite steps counted after the increment and skips the
optimizer's step itself.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).tiny)


class DynamicScale:
    """The loss scale and its count of finite steps, as device scalars
    (f32 and int32); flax's defaults."""

    def __init__(self, growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, fin_steps: int = 0, scale: float = 65536.0,
                 minimum_scale: Optional[float] = F32_TINY, device=None):
        self.growth_factor, self.backoff_factor = growth_factor, backoff_factor
        self.growth_interval, self.minimum_scale = growth_interval, minimum_scale
        self.scale = torch.tensor(scale, dtype=torch.float32, device=device)
        self.fin_steps = torch.tensor(fin_steps, dtype=torch.int32, device=device)

    def to(self, device) -> "DynamicScale":
        self.scale, self.fin_steps = self.scale.to(device), self.fin_steps.to(device)
        return self

    def update(self, finite: torch.Tensor) -> None:
        """The next scale and fin_steps from this step's verdict (a bool
        scalar on the device), in place (dynamic_scale.py:146-158)."""
        grow = self.fin_steps == self.growth_interval
        fin_scale = torch.where(grow & finite,
                                torch.clamp(self.scale * self.growth_factor, max=F32_MAX),
                                self.scale)
        inf_scale = self.scale * self.backoff_factor
        if self.minimum_scale is not None:
            inf_scale = torch.clamp(inf_scale, min=self.minimum_scale)
        new_fin = torch.where(grow | ~finite, torch.zeros_like(self.fin_steps),
                              self.fin_steps + 1)
        self.scale.copy_(torch.where(finite, fin_scale, inf_scale))
        self.fin_steps.copy_(new_fin)

    def buffers(self) -> dict[str, torch.Tensor]:
        return {"loss_scale": self.scale, "loss_scale_fin_steps": self.fin_steps}
