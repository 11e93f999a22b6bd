"""Attention modules (counterpart of ``flaxdiff_tpu/models/attention.py``).

q/k/v are [B, L, H*D] projections viewed as [B, L, H, D]; the flash kernel
takes that view through its strides. Norms are f32 LayerNorms with eps 1e-6
(flax's default), feeding projections in the compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.fused_adaln import fused_geglu
from .common import Dense


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=f32)``: f32 math and output, eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)


class AttentionLayer(nn.Module):
    """Multi-head self/cross attention over [B, L, C] (or [B, H, W, C])."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 4,
                 dim_head: int = 64, backend: str = "auto", dtype=None, device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.backend = backend
        self.to_q = Dense(query_dim, inner, dtype, device)
        self.to_k = Dense(context_dim, inner, dtype, device)
        self.to_v = Dense(context_dim, inner, dtype, device)
        self.to_out = Dense(inner, query_dim, dtype, device)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = x.shape
        if x.ndim == 4:
            x = x.reshape(shape[0], -1, shape[-1])
        context = x if context is None else context
        heads = lambda t: t.view(t.shape[0], t.shape[1], self.heads, self.dim_head)
        q, k, v = heads(self.to_q(x)), heads(self.to_k(context)), heads(self.to_v(context))
        out = dot_product_attention(q, k, v, backend=self.backend)
        out = self.to_out(out.reshape(out.shape[0], out.shape[1], -1))
        return out.reshape(shape)


class GEGLUFeedForward(nn.Module):
    """GEGLU-gated MLP; the gate is the FIRST half of the packed projection."""

    def __init__(self, dim_out: int, mult: int = 4, dtype=None, device=None):
        super().__init__()
        inner = dim_out * mult
        self.proj_in = Dense(dim_out, inner * 2, dtype, device)
        self.proj_out = Dense(inner, dim_out, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(fused_geglu(self.proj_in(x)))


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention -> cross-attention -> GEGLU feed-forward. A
    cross-only block (the UNet's middle block) has one attention, ``attn1``,
    over the context and no ``attn2``
    (flaxdiff_tpu/models/attention.py:242-245, :289)."""

    def __init__(self, dim: int, context_dim: Optional[int], heads: int = 4,
                 dim_head: int = 64, backend: str = "auto", dtype=None,
                 cross_only: bool = False, device=None):
        super().__init__()
        if cross_only and context_dim is None:
            raise ValueError("a cross-only block needs a context_dim")
        attn = lambda ctx: AttentionLayer(dim, ctx, heads, dim_head, backend, dtype, device)
        self.cross_only = cross_only
        self.norm1 = LayerNorm(dim, device=device)
        self.attn1 = attn(context_dim if cross_only else None)
        if context_dim is not None and not cross_only:
            self.norm2 = LayerNorm(dim, device=device)
            self.attn2 = attn(context_dim)
        else:
            self.norm2 = self.attn2 = None
        self.norm3 = LayerNorm(dim, device=device)
        self.ff = GEGLUFeedForward(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cross_only and context is None:
            raise ValueError("a cross-only block needs a context")
        x = x + self.attn1(self.norm1(x), context if self.cross_only else None)
        if self.attn2 is not None and context is not None:
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TransformerBlock(nn.Module):
    """Optional in/out projection + residual around `depth` basic blocks."""

    def __init__(self, dim: int, context_dim: Optional[int], heads: int = 4,
                 dim_head: int = 64, depth: int = 1, backend: str = "auto", dtype=None,
                 use_projection: bool = False, use_self_and_cross: bool = True,
                 device=None):
        super().__init__()
        inner = heads * dim_head
        width = inner if use_projection else dim
        self.proj_in = Dense(dim, inner, dtype, device) if use_projection else None
        self.proj_out = (Dense(inner, dim, dtype, device, init_scale=0.0)
                         if use_projection else None)
        cross_only = not use_self_and_cross and context_dim is not None
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                width, context_dim, heads, dim_head, backend, dtype, cross_only, device))
        self.depth = depth

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x
        h = x.reshape(x.shape[0], -1, x.shape[-1])
        if self.proj_in is not None:
            h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        if self.proj_out is not None:
            h = self.proj_out(h)
        return h.reshape(residual.shape) + residual
