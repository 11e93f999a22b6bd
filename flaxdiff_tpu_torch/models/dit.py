"""Diffusion Transformer with RoPE and AdaLN-Zero
(counterpart of ``flaxdiff_tpu/models/dit.py``).

``SimpleDiT``: patch tokens in raster, Hilbert or zigzag order, the 2D
sin-cos table, a pooled time + text conditioning vector, ``num_layers``
``DiTBlock``s and an f32 LayerNorm + projection back to patches. Each block
modulates two parameter-free LayerNorms and gates two residuals with
AdaLN-Zero, through the LayerNorm + modulate and gated-residual kernels (the
JAX package's ``fused_epilogues`` path, its default). Torch needs the input
widths up front: ``in_channels`` and ``context_dim`` (None: no text context).

Not ported yet: ``cache_mode`` (the training-free caches) and ``remat``; the
unfused epilogues, ``use_gating=False`` and other activations have no
caller.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_adaln import fused_gate_residual, fused_ln_modulate
from ..typing import resolve_dtype
from .common import Dense
from .sfc import sfc_unpatchify, unpatchify
from .vit_common import (AdaLNParams, LayerNorm, RoPEAttention, ScanPatchEmbed,
                         TimeTextEmbedding, scan_rope)


class DiTBlock(nn.Module):
    """Gated RoPE self-attention and a gated MLP, both modulated by
    AdaLN-Zero. The projection splits as s_mlp, b_mlp, g_mlp, s_attn,
    b_attn, g_attn."""

    def __init__(self, features: int, num_heads: int, mlp_ratio: int = 4, backend: str = "auto",
                 dtype=None, norm_epsilon: float = 1e-5, device=None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} not divisible by {num_heads} heads")
        self.norm_epsilon = norm_epsilon
        self.ada = AdaLNParams(features, dtype, device)
        self.attn = RoPEAttention(features, num_heads, features // num_heads, backend, dtype,
                                  device=device)
        self.mlp_in = Dense(features, features * mlp_ratio, dtype, device, init_mode="fan_in")
        self.mlp_out = Dense(features * mlp_ratio, features, dtype, device, init_mode="fan_in")

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor,
                freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        s_mlp, b_mlp, g_mlp, s_attn, b_attn, g_attn = self.ada(conditioning).chunk(6, dim=-1)
        h = fused_ln_modulate(x, s_attn, b_attn, self.norm_epsilon)
        x = fused_gate_residual(x, g_attn, self.attn(h, freqs_cis=freqs_cis))
        h = fused_ln_modulate(x, s_mlp, b_mlp, self.norm_epsilon)
        # jax.nn.gelu's default, the tanh form
        h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))
        return fused_gate_residual(x, g_mlp, h)


class SimpleDiT(nn.Module):
    def __init__(self, output_channels: int = 3, patch_size: int = 16, emb_features: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 backend: str = "auto", dtype=None, norm_epsilon: float = 1e-5,
                 learn_sigma: bool = False, remat: bool = False, use_hilbert: bool = False,
                 use_zigzag: bool = False, in_channels: int = 3,
                 context_dim: Optional[int] = None, device: DeviceLike = None):
        super().__init__()
        if use_hilbert and use_zigzag:
            raise ValueError("use_hilbert and use_zigzag are mutually exclusive")
        if remat:
            raise NotImplementedError("remat is not ported yet (ROADMAP queue A8)")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.scan_order = "hilbert" if use_hilbert else "zigzag" if use_zigzag else "raster"
        self.output_channels, self.patch_size = output_channels, patch_size
        self.emb_features, self.num_heads = emb_features, num_heads
        self.num_layers, self.learn_sigma = num_layers, learn_sigma
        self.embed = ScanPatchEmbed(in_channels, patch_size, emb_features, self.scan_order,
                                    dtype=dtype, device=device)
        self.cond = TimeTextEmbedding(emb_features, mlp_ratio, context_dim, dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", DiTBlock(emb_features, num_heads, mlp_ratio, backend,
                                                   dtype, norm_epsilon, device))
        self.final_norm = LayerNorm(emb_features, norm_epsilon, device)
        out_dim = patch_size ** 2 * output_channels * (2 if learn_sigma else 1)
        self.final_proj = Dense(emb_features, out_dim, torch.float32, device, init_scale=0.0)

    def head(self, x: torch.Tensor, temb: torch.Tensor, textcontext: Optional[torch.Tensor] = None):
        """Everything before the trunk: (tokens, conditioning, RoPE tables,
        inverse scan permutation or None)."""
        p = self.patch_size
        tokens, inv_idx = self.embed(x)
        cond = self.cond(temb, textcontext)
        freqs = scan_rope(self.emb_features // self.num_heads, (x.shape[1] // p) * (x.shape[2] // p),
                          self.scan_order, x.device)
        return tokens, cond, freqs, inv_idx

    def tail(self, tokens: torch.Tensor, inv_idx: Optional[np.ndarray], height: int,
             width: int) -> torch.Tensor:
        """Everything after the trunk: f32 norm and projection, the
        log-variance half dropped with ``learn_sigma``, unpatchify."""
        tokens = self.final_proj(self.final_norm(tokens))
        if self.learn_sigma:
            tokens = tokens.chunk(2, dim=-1)[0]
        p, c = self.patch_size, self.output_channels
        if inv_idx is not None:
            return sfc_unpatchify(tokens, inv_idx, p, height, width, c)
        return unpatchify(tokens, p, height, width, c)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None,
                cache_mode: Optional[str] = None, **cache_args) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        if cache_mode is not None or cache_args:
            raise NotImplementedError("cache_mode is not ported yet (ROADMAP queue A9, the "
                                      "training-free caches)")
        tokens, cond, freqs, inv_idx = self.head(x, temb, textcontext)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block_{i}")(tokens, cond, freqs)
        return self.tail(tokens, inv_idx, x.shape[1], x.shape[2])

    def load_flax_params(self, params: Mapping, fourier_freqs: Optional[np.ndarray] = None
                         ) -> "SimpleDiT":
        """Load a flax parameter tree of the JAX ``SimpleDiT`` (see
        ``convert.dit_state_dict_from_flax``); without ``fourier_freqs`` the
        port's table of the JAX draws stays."""
        from ..convert import dit_state_dict_from_flax
        state = dit_state_dict_from_flax(params, fourier_freqs)
        if fourier_freqs is None:
            state["cond.t_fourier.freqs"] = self.cond.t_fourier.freqs
        self.load_state_dict(state, strict=True)
        return self
