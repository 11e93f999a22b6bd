"""Small tensor helpers (counterpart of parts of ``flaxdiff_tpu/utils.py``)."""
from __future__ import annotations

import torch


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> f32 [-1, 1] (flaxdiff_tpu/utils.py:66)."""
    return (x.float() - 127.5) / 127.5


def denormalize_images(x: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> uint8 [0, 255] (flaxdiff_tpu/utils.py:71)."""
    return torch.clamp(x * 127.5 + 127.5, 0, 255).to(torch.uint8)


def clip_images(x: torch.Tensor, clip_min: float = -1.0, clip_max: float = 1.0) -> torch.Tensor:
    return torch.clamp(x, clip_min, clip_max)


def cfg_uncond_splice(emb: torch.Tensor, uncond: torch.Tensor,
                      uncond_mask: torch.Tensor) -> torch.Tensor:
    """CFG dropout: where uncond_mask[b] is True, sample b's conditioning
    becomes the (broadcast) null embedding, as a ``where`` select
    (flaxdiff_tpu/utils.py:101)."""
    if uncond_mask.shape[0] != emb.shape[0]:
        raise ValueError(f"uncond_mask batch {uncond_mask.shape[0]} != "
                         f"embedding batch {emb.shape[0]}")
    mask = uncond_mask.reshape((emb.shape[0],) + (1,) * (emb.ndim - 1))
    return torch.where(mask, uncond.to(emb.dtype).expand(emb.shape), emb)
