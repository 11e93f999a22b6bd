"""Small tensor helpers (counterpart of parts of ``flaxdiff_tpu/utils.py``)."""
from __future__ import annotations

import torch


def clip_images(x: torch.Tensor, clip_min: float = -1.0, clip_max: float = 1.0) -> torch.Tensor:
    return torch.clamp(x, clip_min, clip_max)
