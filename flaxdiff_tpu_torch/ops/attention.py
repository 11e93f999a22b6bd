"""Attention dispatch over [B, L, H, D] tensors (the JAX package's BTNH layout).

Counterpart of ``flaxdiff_tpu/ops/attention.py`` ``dot_product_attention``.
The Hopper kernel takes any sequence length, so there is no ``seq >= 128``
threshold. It takes head dims of 32, 64, 128 and 256, and any multiple of
64 above 256 (the wide kernels); any other head dim is zero-padded to the
next of them, as the reference pads to a multiple of 128 lanes
(``_maybe_pad_head_dim``): the zero channels add exactly 0 to every logit
and to the output channels sliced away. So every head dim runs, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention, padded_head_dim

BACKENDS = ("auto", "flash", "xla")


def eager_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Explicit attention math (the JAX package's ``_xla_attention``):
    f32 scores and softmax, probabilities cast back to the input dtype for
    the product with v. (The JAX package's ``force_fp32_for_softmax`` has
    no effect there: its scores are f32 either way, through
    ``preferred_element_type``; the port has no such flag.)"""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          backend: str = "auto", scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Multi-head attention. ``auto`` and ``flash`` run the flash kernel on
    CUDA tensors (its plain version on the CPU), a head dim the kernels do
    not take zero-padded to the next they do on every device
    (``padded_head_dim``); ``xla`` runs the explicit math. Both compute the
    softmax in f32."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; known: {BACKENDS}")
    if backend == "xla":
        return eager_attention(q, k, v, scale)
    d = q.shape[-1]
    width = padded_head_dim(d)
    if width == d:
        return flash_attention(q, k, v, scale=scale)
    # the true head dim's scale; F.pad and the slice carry dq, dk, dv back
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q, k, v = (F.pad(t, (0, width - d)) for t in (q, k, v))
    return flash_attention(q, k, v, scale=scale, model_head_dim=d)[..., :d]
