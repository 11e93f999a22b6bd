"""Attention dispatch over [B, L, H, D] tensors (the JAX package's BTNH layout).

Counterpart of ``flaxdiff_tpu/ops/attention.py`` ``dot_product_attention``.
The Hopper kernel takes any sequence length, so there is no ``seq >= 128``
threshold. It takes head dims of 32, 64, 128 and 256, and any multiple of
64 above 256 (the wide kernels); any other head dim is zero-padded to the
next of them, as the reference pads to a multiple of 128 lanes
(``_maybe_pad_head_dim``): the zero channels add exactly 0 to every logit
and to the output channels sliced away. So every head dim runs, as in the
reference.

The JAX package's other backends are taken too (``dot_product_attention``'s
``backend``): ``"ring"`` and ``"ulysses"`` run sequence-parallel attention
over the active mesh's seq dim (``parallel/``) on the flash kernels, where
``_seq_parallel_gate`` opens, and ``"auto"`` elsewhere; ``"performer"`` runs
FAVOR+ linear attention; ``"prebuilt"`` names the JAX package's vendor TPU
kernel, which the port has not, and warns and runs ``"xla"``, as the JAX
package does on any device without it.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention, padded_head_dim

BACKENDS = ("auto", "flash", "xla", "ring", "ulysses", "performer", "prebuilt")


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


def _seq_parallel_gate(q: torch.Tensor, k: torch.Tensor, need_head_divisible: bool = False):
    """(mesh, seq dim name) when sequence-parallel attention applies to
    these shapes under the active mesh, else None (the JAX package's gate,
    shared by ``"ring"`` and ``"ulysses"``): a seq dim of more than one
    rank, equal q and kv lengths (self-attention; cross-attention's short
    context stays whole), a sequence the seq dim divides, and for Ulysses
    heads it divides. The JAX gate also asks that the global batch divide
    the data dim; a rank here holds its data x fsdp block of the global
    batch's rows, so the global batch always does."""
    from ..parallel.context import get_active_mesh, get_seq_axis, seq_parallel_active
    if not (seq_parallel_active() and q.shape[1] == k.shape[1]):
        return None
    from ..parallel.mesh import axis_size
    mesh, seq_axis = get_active_mesh(), get_seq_axis()
    n = axis_size(mesh, seq_axis)
    if q.shape[1] % n != 0:
        return None
    if need_head_divisible and q.shape[2] % n != 0:
        return None
    return mesh, seq_axis


def _warn_prebuilt_fallback() -> None:
    warnings.warn("backend='prebuilt' names the JAX package's prebuilt TPU kernel, which the "
                  "port does not have; running the xla attention math", stacklevel=3)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          backend: str = "auto", scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Multi-head attention. ``auto`` and ``flash`` run the flash kernel on
    CUDA tensors (its plain version on the CPU), a head dim the kernels do
    not take zero-padded to the next they do on every device
    (``padded_head_dim``); ``xla`` runs the explicit math. Both compute the
    softmax in f32. ``ring`` and ``ulysses`` run the flash kernels
    sequence-parallel over the active mesh where the gate opens (else
    ``auto``), ``performer`` FAVOR+ with its cached seed-0 projection, and
    ``prebuilt`` warns and runs ``xla``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; known: {BACKENDS}")
    if backend == "performer":
        from .linear_attention import favor_attention
        return favor_attention(q, k, v, scale=scale)
    gate = None
    if backend in ("ring", "ulysses"):
        gate = _seq_parallel_gate(q, k, need_head_divisible=backend == "ulysses")
        if gate is None:
            backend = "auto"
    if backend == "prebuilt":
        _warn_prebuilt_fallback()
        backend = "xla"
    if backend == "xla":
        return eager_attention(q, k, v, scale)
    d = q.shape[-1]
    width = padded_head_dim(d)
    if width != d:
        # the true head dim's scale; F.pad and the slice carry dq, dk, dv back
        scale = 1.0 / math.sqrt(d) if scale is None else scale
        q, k, v = (F.pad(t, (0, width - d)) for t in (q, k, v))
    if gate is not None:
        from ..parallel import ring_self_attention, ulysses_self_attention
        attend = ring_self_attention if backend == "ring" else ulysses_self_attention
        out = attend(q, k, v, gate[0], seq_axis=gate[1], scale=scale, model_head_dim=d)
    elif width == d:
        return flash_attention(q, k, v, scale=scale)
    else:
        out = flash_attention(q, k, v, scale=scale, model_head_dim=d)
    return out if width == d else out[..., :d]
