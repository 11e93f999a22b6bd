"""Shared transformer layers: patch embedding, RoPE, AdaLN-Zero
(counterpart of ``flaxdiff_tpu/models/vit_common.py``).

Module and attribute names follow the flax modules, so a parameter tree
converts name for name (``convert.state_dict_from_flax``). These layers
keep flax's default initializer, lecun normal (``init_mode="fan_in"``), where
the JAX modules do, not the UNet's fan-avg law. RoPE is rotate-half with
[S, D/2] tables applied in the [B, S, H, D] layout; the tables and the 2D
sin-cos table are built once per shape and device.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.fused_adaln import fused_ln_modulate2, ln_stats
from .common import ConvLayer, Dense, FourierEmbedding, TimeProjection
from .sfc import build_2d_sincos_pos_embed, scan_indices, sfc_patchify


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=f32)`` with scale and bias: f32 statistics
    in the fast-variance form, ``(x - mean) * (rstd * scale) + bias``."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, rstd = ln_stats(x, self.eps)
        return (x.float() - mean[..., None]) * (rstd[..., None] * self.weight) + self.bias


class PatchEmbedding(nn.Module):
    """Non-overlapping conv patchify: [B, H, W, C] -> [B, N, D]."""

    def __init__(self, in_channels: int, patch_size: int, embedding_dim: int, dtype=None,
                 device=None):
        super().__init__()
        self.patch_size, self.embedding_dim = patch_size, embedding_dim
        self.proj = ConvLayer(in_channels, embedding_dim, (patch_size, patch_size), patch_size,
                              dtype, device, init_mode="fan_in")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch size {p}")
        return self.proj(x).reshape(b, -1, self.embedding_dim)


class PositionalEncoding(nn.Module):
    """Learned additive positional table, N(0, 0.02^2) at init."""

    def __init__(self, max_len: int, embedding_dim: int, device=None):
        super().__init__()
        self.pos_encoding = nn.Parameter(
            torch.randn(1, max_len, embedding_dim, device=device) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        if n > self.pos_encoding.shape[1]:
            raise ValueError(f"sequence {n} exceeds max_len {self.pos_encoding.shape[1]}")
        return x + self.pos_encoding[:, :n].to(x.dtype)


# --- rotary position embedding ----------------------------------------------------

def rope_frequencies(dim: int, seq_len: int, base: float = 10000.0, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [seq_len, dim / 2] in f32, position = index."""
    if dim % 2:
        raise ValueError(f"RoPE head dim must be even, got {dim}")
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def identity_rope(dim: int, seq_len: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos = 1, sin = 0: RoPE as a no-op, for scan orders whose sequence
    index is not a 2D position."""
    shape = (seq_len, dim // 2)
    return (torch.ones(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on [B, S, H, D] with tables [S, D/2], in f32, cast
    back to x's dtype."""
    cos = torch.cat([cos, cos], dim=-1)[None, :, None, :]
    sin = torch.cat([sin, sin], dim=-1)[None, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


@functools.lru_cache(maxsize=32)
def scan_rope(dim_head: int, seq_len: int, scan_order: str, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables for a scan order: the real frequencies for raster, the
    identity for hilbert and zigzag. Made outside inference mode, as
    ``sfc.scan_permutation``. Shared: callers do not write them."""
    with torch.inference_mode(False):
        if scan_order == "raster":
            return rope_frequencies(dim_head, seq_len, device=device)
        return identity_rope(dim_head, seq_len, device=device)


class RoPEAttention(nn.Module):
    """Multi-head attention with rotary embeddings on q and k, over [B, L, C];
    self-attention unless a context is given."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, backend: str = "auto",
                 dtype=None, context_dim: Optional[int] = None, device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head, self.backend = heads, dim_head, backend
        dense = lambda i, o: Dense(i, o, dtype, device, init_mode="fan_in")
        self.to_q = dense(query_dim, inner)
        self.to_k = dense(context_dim, inner)
        self.to_v = dense(context_dim, inner)
        self.to_out = dense(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        context = x if context is None else context
        heads = lambda t: t.view(t.shape[0], t.shape[1], self.heads, self.dim_head)
        q, k, v = heads(self.to_q(x)), heads(self.to_k(context)), heads(self.to_v(context))
        if freqs_cis is None:
            # sized to the longer sequence, so a longer context keeps its positions
            cos, sin = rope_frequencies(self.dim_head, max(q.shape[1], k.shape[1]),
                                        device=x.device)
        else:
            cos, sin = freqs_cis
        q = apply_rope(q, cos[:q.shape[1]], sin[:q.shape[1]])
        k = apply_rope(k, cos[:k.shape[1]], sin[:k.shape[1]])
        out = dot_product_attention(q, k, v, backend=self.backend)
        return self.to_out(out.reshape(out.shape[0], out.shape[1], -1))


# --- embed and conditioning -------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _pos_table(dim: int, hp: int, wp: int, scan_order: str, device: torch.device
               ) -> torch.Tensor:
    """The 2D sin-cos table [N, dim] f32, permuted into the scan order;
    made outside inference mode, as ``sfc.scan_permutation``."""
    pos = build_2d_sincos_pos_embed(dim, hp, wp)
    idx = scan_indices(scan_order, hp, wp)
    if idx is not None:
        pos = pos[idx]
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(pos)).to(device)


class ScanPatchEmbed(nn.Module):
    """Patch embedding with a scan order. raster: the conv patch embed;
    hilbert and zigzag: raw patches in scan order through a Dense (a conv
    does not compose with a reorder after it). The 2D sin-cos table,
    permuted into the scan order, is added in the tokens' dtype. Returns
    (tokens [B, N, D], the inverse permutation or None)."""

    def __init__(self, in_channels: int, patch_size: int, embedding_dim: int,
                 scan_order: str = "raster", dtype=None, device=None):
        super().__init__()
        scan_indices(scan_order, 1, 1)
        self.patch_size, self.embedding_dim = patch_size, embedding_dim
        self.scan_order = scan_order
        if scan_order == "raster":
            self.patch_embed = PatchEmbedding(in_channels, patch_size, embedding_dim, dtype,
                                              device)
        else:
            self.scan_proj = Dense(patch_size * patch_size * in_channels, embedding_dim, dtype,
                                   device, init_mode="fan_in")

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        _, h, w, _ = x.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        if self.scan_order == "raster":
            inv_idx = None
            tokens = self.patch_embed(x)
        else:
            raw, inv_idx = sfc_patchify(x, p, self.scan_order)
            tokens = self.scan_proj(raw)
        pos = _pos_table(self.embedding_dim, hp, wp, self.scan_order, tokens.device)
        return tokens + pos[None].to(tokens.dtype), inv_idx


class TimeTextEmbedding(nn.Module):
    """The pooled conditioning vector: a Fourier time embedding through an
    MLP ratio times wider f32 TimeProjection and a Dense back, plus the
    mean over tokens of the projected text context."""

    def __init__(self, features: int, mlp_ratio: int = 4, context_dim: Optional[int] = None,
                 dtype=None, device=None):
        super().__init__()
        self.t_fourier = FourierEmbedding(features, device)
        self.t_proj = TimeProjection(features, features * mlp_ratio, None, device)
        self.t_out = Dense(features * mlp_ratio, features, dtype, device, init_mode="fan_in")
        self.text_proj = (Dense(context_dim, features, dtype, device, init_mode="fan_in")
                          if context_dim is not None else None)

    def forward(self, temb: torch.Tensor, textcontext: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cond = self.t_out(self.t_proj(self.t_fourier(temb)))
        if textcontext is not None:
            if self.text_proj is None:
                raise ValueError("a text context needs context_dim at construction")
            cond = cond + self.text_proj(textcontext).mean(dim=1)
        return cond


# --- AdaLN-Zero -----------------------------------------------------------------

def plain_layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm(use_scale=False, use_bias=False, dtype=f32)``:
    the parameter-free norm of the unfused epilogues, f32 out."""
    mean, rstd = ln_stats(x, eps)
    return (x.float() - mean[..., None]) * rstd[..., None]


def modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """DiT modulation: x (1 + scale) + shift."""
    return x * (1.0 + scale) + shift


class AdaLNParams(nn.Module):
    """Zero-initialised projection of the conditioning vector [B, D] (or
    [B, 1, D]) to six modulation vectors [B, 1, 6 D]."""

    def __init__(self, features: int, dtype=None, device=None):
        super().__init__()
        self.ada_proj = Dense(features, 6 * features, dtype, device, init_scale=0.0)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        if conditioning.ndim == 2:
            conditioning = conditioning[:, None, :]
        return self.ada_proj(conditioning)


class AdaLNZero(nn.Module):
    """One parameter-free LayerNorm, two modulated views from one pass of the
    LayerNorm + modulate kernel: returns (x_attn, gate_attn, x_mlp,
    gate_mlp). The projection splits as s_mlp, b_mlp, g_mlp, s_attn, b_attn,
    g_attn; the MLP pair is clipped to +-10 before the kernel, as in JAX."""

    def __init__(self, features: int, dtype=None, norm_epsilon: float = 1e-5, device=None):
        super().__init__()
        self.params = AdaLNParams(features, dtype, device)
        self.norm_epsilon = norm_epsilon

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor):
        s_mlp, b_mlp, g_mlp, s_attn, b_attn, g_attn = self.params(conditioning).chunk(6, dim=-1)
        s_mlp = torch.clamp(s_mlp, -10.0, 10.0)
        b_mlp = torch.clamp(b_mlp, -10.0, 10.0)
        x_attn, x_mlp = fused_ln_modulate2(x, s_attn, b_attn, s_mlp, b_mlp, self.norm_epsilon)
        return x_attn, g_attn, x_mlp, g_mlp
