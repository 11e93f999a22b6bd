"""Multi-modal DiT and its hierarchical U (counterpart of
``flaxdiff_tpu/models/mmdit.py``).

- ``MMAdaLNZero``: separate zero-initialised projections of the time and the
  (mean-pooled) text conditioning, summed into the six AdaLN-Zero vectors;
  the MLP pair clipped to +-10; both modulated views from one pass of the
  LayerNorm + modulate kernel (two views), or JAX's unfused composition with
  ``fused_epilogues=False``.
- ``MMDiTBlock``: gated RoPE self-attention and a gated MLP.
- ``SimpleMMDiT``: a flat stack of them over raster or Hilbert patch tokens;
  RoPE follows the token sequence in both orders.
- ``HierarchicalMMDiT``: fine -> coarse stages joined by ``PatchMerging``,
  back up by ``PatchExpanding`` with fused skips; per-stage conditioning
  projected from one base at the coarsest width, per-stage RoPE. Its Hilbert
  mode only swaps the embedding (raw patches + Dense): tokens stay row-major
  throughout, so merging groups true 2D neighbours.

Module names follow the flax modules. Torch needs ``in_channels`` and
``context_dim`` (default 768, CLIP's width) up front; both models require a
text context.
``precision`` and ``force_fp32_for_softmax`` are accepted and have no
effect.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_adaln import fused_ln_modulate2
from ..typing import gelu, resolve_activation, resolve_dtype, resolve_precision
from .common import Dense, FourierEmbedding, TimeProjection, lecun_dense
from .dit import CACHE_NOT_PORTED, gate_residual
from .sfc import patchify, sfc_patchify, sfc_unpatchify, unpatchify
from .vit_common import (LayerNorm, PatchEmbedding, RoPEAttention, modulate, plain_layer_norm,
                         scan_rope)


class MMAdaLNZero(nn.Module):
    """Returns (x_attn, gate_attn, x_mlp, gate_mlp). The summed projection
    splits as s_mlp, b_mlp, g_mlp, s_attn, b_attn, g_attn."""

    def __init__(self, features: int, dtype=None, norm_epsilon: float = 1e-5,
                 fused_epilogues: bool = True, device=None):
        super().__init__()
        zero = lambda: Dense(features, 6 * features, dtype, device, init_scale=0.0)
        self.ada_t_proj, self.ada_text_proj = zero(), zero()
        self.norm_epsilon, self.fused = norm_epsilon, fused_epilogues

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, text_emb: torch.Tensor):
        if t_emb.ndim == 2:
            t_emb = t_emb[:, None, :]
        # sequence-shaped text is always pooled: a token's position in the
        # prompt has nothing to do with an image token's
        text_emb = (text_emb[:, None, :] if text_emb.ndim == 2
                    else text_emb.mean(dim=1, keepdim=True))
        params = self.ada_t_proj(t_emb) + self.ada_text_proj(text_emb)
        s_mlp, b_mlp, g_mlp, s_attn, b_attn, g_attn = params.chunk(6, dim=-1)
        s_mlp = torch.clamp(s_mlp, -10.0, 10.0)
        b_mlp = torch.clamp(b_mlp, -10.0, 10.0)
        if self.fused:
            x_attn, x_mlp = fused_ln_modulate2(x, s_attn, b_attn, s_mlp, b_mlp,
                                               self.norm_epsilon)
            return x_attn, g_attn, x_mlp, g_mlp
        norm_x = plain_layer_norm(x, self.norm_epsilon)
        return modulate(norm_x, s_attn, b_attn), g_attn, modulate(norm_x, s_mlp, b_mlp), g_mlp


class MMDiTBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, mlp_ratio: int = 4, backend: str = "auto",
                 dtype=None, norm_epsilon: float = 1e-5, activation: Callable = gelu,
                 fused_epilogues: bool = True, device=None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} not divisible by {num_heads} heads")
        self.activation, self.fused = activation, fused_epilogues
        self.ada = MMAdaLNZero(features, dtype, norm_epsilon, fused_epilogues, device)
        self.attn = RoPEAttention(features, num_heads, features // num_heads, backend, dtype,
                                  device=device)
        self.mlp_in = lecun_dense(features, features * mlp_ratio, dtype, device)
        self.mlp_out = lecun_dense(features * mlp_ratio, features, dtype, device)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor, text_emb: torch.Tensor,
                freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        x_attn, g_attn, x_mlp, g_mlp = self.ada(x, t_emb, text_emb)
        x = gate_residual(x, g_attn, self.attn(x_attn, freqs_cis=freqs_cis), self.fused)
        h = self.mlp_out(self.activation(self.mlp_in(x_mlp)))
        return gate_residual(x, g_mlp, h, self.fused)


def _time_text(model: nn.Module, d: int, mlp_ratio: int, context_dim: int, text_name: str,
               dtype, device) -> None:
    """The time and text embeddings at width `d`, at the model's top level
    as in flax: Fourier time features through a ``mlp_ratio`` times wider
    MLP and a Dense back (``t_fourier``, ``t_proj``, ``t_out``), and the text
    context projected token by token."""
    model.t_fourier = FourierEmbedding(d, device)
    model.t_proj = TimeProjection(d, d * mlp_ratio, None, device)
    model.t_out = lecun_dense(d * mlp_ratio, d, dtype, device)
    model.add_module(text_name, lecun_dense(context_dim, d, dtype, device))


def _need_context(textcontext, name: str) -> None:
    if textcontext is None:
        raise ValueError(f"{name} requires textcontext")


class SimpleMMDiT(nn.Module):
    def __init__(self, output_channels: int = 3, patch_size: int = 16, emb_features: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 backend: str = "auto", dtype=None, precision: Optional[str] = None,
                 force_fp32_for_softmax: bool = True, norm_epsilon: float = 1e-5,
                 learn_sigma: bool = False, use_hilbert: bool = False,
                 activation: Union[str, Callable] = "gelu", fused_epilogues: bool = True,
                 in_channels: int = 3, context_dim: int = 768, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        activation = resolve_activation(activation)
        self.output_channels, self.patch_size = output_channels, patch_size
        self.emb_features, self.num_heads, self.num_layers = emb_features, num_heads, num_layers
        self.learn_sigma, self.use_hilbert = learn_sigma, use_hilbert
        p, d = patch_size, emb_features
        if use_hilbert:
            self.scan_proj = lecun_dense(p * p * in_channels, d, dtype, device)
        else:
            self.patch_embed = PatchEmbedding(in_channels, p, d, dtype, device)
        _time_text(self, d, mlp_ratio, context_dim, "text_proj", dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", MMDiTBlock(d, num_heads, mlp_ratio, backend, dtype,
                                                     norm_epsilon, activation, fused_epilogues,
                                                     device))
        self.final_norm = LayerNorm(d, norm_epsilon, device)
        out_dim = p * p * output_channels * (2 if learn_sigma else 1)
        self.final_proj = Dense(d, out_dim, torch.float32, device, init_scale=0.0)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None,
                cache_mode: Optional[str] = None, **cache_args) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        _need_context(textcontext, "SimpleMMDiT")
        if cache_mode is not None or cache_args:
            raise NotImplementedError(CACHE_NOT_PORTED)
        _, h, w, _ = x.shape
        p = self.patch_size
        inv_idx = None
        if self.use_hilbert:
            raw, inv_idx = sfc_patchify(x, p, "hilbert")
            tokens = self.scan_proj(raw)
        else:
            tokens = self.patch_embed(x)
        t_emb = self.t_out(self.t_proj(self.t_fourier(temb)))
        text_emb = self.text_proj(textcontext)
        # RoPE over the sequence in either order (the Hilbert curve's
        # distances, as in the reference)
        freqs = scan_rope(self.emb_features // self.num_heads, tokens.shape[1], "raster",
                          x.device)
        for i in range(self.num_layers):
            tokens = getattr(self, f"block_{i}")(tokens, t_emb, text_emb, freqs)
        tokens = self.final_proj(self.final_norm(tokens))
        if self.learn_sigma:
            tokens = tokens.chunk(2, dim=-1)[0]
        c = self.output_channels
        if inv_idx is not None:
            return sfc_unpatchify(tokens, inv_idx, p, h, w, c)
        return unpatchify(tokens, p, h, w, c)


class PatchMerging(nn.Module):
    """Swin-style 2x2 merge of row-major tokens: [B, hp wp, C] ->
    [B, hp wp / 4, out], a LayerNorm over the 4 C merged features, then a
    Dense."""

    def __init__(self, in_features: int, out_features: int, merge_size: int = 2, dtype=None,
                 norm_epsilon: float = 1e-5, device=None):
        super().__init__()
        m = merge_size
        self.merge_size, self.out_features = m, out_features
        self.norm = LayerNorm(m * m * in_features, norm_epsilon, device)
        self.projection = lecun_dense(m * m * in_features, out_features, dtype, device)

    def forward(self, x: torch.Tensor, hp: int, wp: int):
        b, n, c = x.shape
        m = self.merge_size
        if n != hp * wp or hp % m or wp % m:
            raise ValueError(f"cannot merge {n} tokens as {hp}x{wp} by {m}")
        x = x.reshape(b, hp // m, m, wp // m, m, c).permute(0, 1, 3, 2, 4, 5)
        x = self.projection(self.norm(x.reshape(b, hp // m, wp // m, m * m * c)))
        return x.reshape(b, (hp // m) * (wp // m), self.out_features), hp // m, wp // m


class PatchExpanding(nn.Module):
    """The inverse of ``PatchMerging``: a Dense to m m out features, a
    LayerNorm over them, then each token spread over its m x m cell."""

    def __init__(self, in_features: int, out_features: int, expand_size: int = 2, dtype=None,
                 norm_epsilon: float = 1e-5, device=None):
        super().__init__()
        m = expand_size
        self.expand_size, self.out_features = m, out_features
        self.projection = lecun_dense(in_features, m * m * out_features, dtype, device)
        self.norm = LayerNorm(m * m * out_features, norm_epsilon, device)

    def forward(self, x: torch.Tensor, hp: int, wp: int):
        b, n, _ = x.shape
        m, o = self.expand_size, self.out_features
        if n != hp * wp:
            raise ValueError(f"token count {n} != {hp}x{wp}")
        x = self.norm(self.projection(x)).reshape(b, hp, wp, m, m, o).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hp * m * wp * m, o), hp * m, wp * m


class HierarchicalMMDiT(nn.Module):
    def __init__(self, output_channels: int = 3, base_patch_size: int = 8,
                 emb_features: Sequence[int] = (512, 768, 1024),
                 num_layers: Sequence[int] = (4, 4, 14), num_heads: Sequence[int] = (8, 12, 16),
                 mlp_ratio: int = 4, backend: str = "auto", dtype=None,
                 precision: Optional[str] = None, force_fp32_for_softmax: bool = True,
                 norm_epsilon: float = 1e-5, learn_sigma: bool = False,
                 use_hilbert: bool = False, activation: Union[str, Callable] = "gelu",
                 fused_epilogues: bool = True, in_channels: int = 3, context_dim: int = 768,
                 device: DeviceLike = None):
        super().__init__()
        if not len(emb_features) == len(num_layers) == len(num_heads):
            raise ValueError("per-stage config lengths must match")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        activation = resolve_activation(activation)
        self.emb_features, self.num_heads = tuple(emb_features), tuple(num_heads)
        self.num_layers = tuple(num_layers)
        self.output_channels, self.patch_size = output_channels, base_patch_size
        self.learn_sigma, self.use_hilbert = learn_sigma, use_hilbert
        p, widths = base_patch_size, self.emb_features
        n = len(widths)
        if use_hilbert:
            self.scan_proj = lecun_dense(p * p * in_channels, widths[0], dtype, device)
        else:
            self.patch_embed = PatchEmbedding(in_channels, p, widths[0], dtype, device)
        base = widths[-1]
        _time_text(self, base, mlp_ratio, context_dim, "text_proj_base", dtype, device)
        for s in range(n):
            self.add_module(f"t_stage_{s}", lecun_dense(base, widths[s], dtype, device))
            self.add_module(f"text_stage_{s}", lecun_dense(base, widths[s], dtype, device))
        block = lambda s: MMDiTBlock(widths[s], num_heads[s], mlp_ratio, backend, dtype,
                                     norm_epsilon, activation, fused_epilogues, device)
        for s in range(n):
            for i in range(num_layers[s]):
                self.add_module(f"enc_s{s}_b{i}", block(s))
            if s < n - 1:
                self.add_module(f"merge_{s}", PatchMerging(widths[s], widths[s + 1], dtype=dtype,
                                                           norm_epsilon=norm_epsilon,
                                                           device=device))
        for s in range(n - 2, -1, -1):
            self.add_module(f"expand_{s}", PatchExpanding(widths[s + 1], widths[s], dtype=dtype,
                                                          norm_epsilon=norm_epsilon,
                                                          device=device))
            self.add_module(f"fuse_norm_{s}", LayerNorm(2 * widths[s], norm_epsilon, device))
            self.add_module(f"fuse_dense_{s}", lecun_dense(2 * widths[s], widths[s], dtype, device))
            for i in range(num_layers[s]):
                self.add_module(f"dec_s{s}_b{i}", block(s))
        self.final_norm = LayerNorm(widths[0], norm_epsilon, device)
        out_dim = p * p * output_channels * (2 if learn_sigma else 1)
        self.final_proj = Dense(widths[0], out_dim, torch.float32, device, init_scale=0.0)

    def _stage(self, prefix: str, s: int, h: torch.Tensor, t_emb, text_emb) -> torch.Tensor:
        freqs = scan_rope(self.emb_features[s] // self.num_heads[s], h.shape[1], "raster",
                          h.device)
        for i in range(self.num_layers[s]):
            h = getattr(self, f"{prefix}_s{s}_b{i}")(h, t_emb, text_emb, freqs)
        return h

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        _need_context(textcontext, "HierarchicalMMDiT")
        n = len(self.emb_features)
        _, h, w, _ = x.shape
        p = self.patch_size
        coarsest = p * 2 ** (n - 1)
        if h % coarsest or w % coarsest:
            raise ValueError(f"image {h}x{w} not divisible by coarsest patch {coarsest}")
        tokens = self.scan_proj(patchify(x, p)) if self.use_hilbert else self.patch_embed(x)
        t_base = self.t_out(self.t_proj(self.t_fourier(temb)))
        text_base = self.text_proj_base(textcontext)
        t_embs = [getattr(self, f"t_stage_{s}")(t_base) for s in range(n)]
        text_embs = [getattr(self, f"text_stage_{s}")(text_base) for s in range(n)]

        skips = []
        hp, wp = h // p, w // p
        for s in range(n):
            tokens = self._stage("enc", s, tokens, t_embs[s], text_embs[s])
            skips.append(tokens)
            if s < n - 1:
                tokens, hp, wp = getattr(self, f"merge_{s}")(tokens, hp, wp)
        for s in range(n - 2, -1, -1):
            tokens, hp, wp = getattr(self, f"expand_{s}")(tokens, hp, wp)
            tokens = getattr(self, f"fuse_norm_{s}")(torch.cat([tokens, skips[s]], dim=-1))
            tokens = getattr(self, f"fuse_dense_{s}")(tokens)
            tokens = self._stage("dec", s, tokens, t_embs[s], text_embs[s])
        tokens = self.final_proj(self.final_norm(tokens))
        if self.learn_sigma:
            tokens = tokens.chunk(2, dim=-1)[0]
        return unpatchify(tokens, p, h, w, self.output_channels)
