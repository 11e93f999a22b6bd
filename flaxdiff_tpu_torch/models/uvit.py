"""U-shaped vision transformers, UViT and SimpleUDiT (counterpart of
``flaxdiff_tpu/models/uvit.py``).

- ``UViT``: patch tokens plus a learned positional table, the time token and
  the projected text tokens concatenated into one sequence, symmetric
  down/mid/up ``TransformerBlock``s with concatenated skips fused by a
  Dense, a zero-initialised projection of the patch tokens back to pixels,
  and an optional residual convolution stage over [input; prediction].
- ``SimpleUDiT``: the same U of ``DiTBlock``s (RoPE + AdaLN-Zero) over scan
  ordered patch tokens, conditioned on the pooled time + text vector.

Module names follow the flax modules, so ``convert.state_dict_from_flax``
is a rename. Torch needs the input widths up front: ``in_channels`` and
``context_dim`` (None: no text context). ``precision`` and
``force_fp32_for_softmax`` are accepted and have no effect.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import resolve_activation, resolve_dtype, resolve_precision
from .attention import TransformerBlock
from .common import ConvLayer, Dense, FourierEmbedding, TimeProjection, lecun_dense
from .dit import CACHE_NOT_PORTED, DiTBlock
from .sfc import sfc_patchify, sfc_unpatchify, unpatchify
from .vit_common import (LayerNorm, PatchEmbedding, PositionalEncoding, ScanPatchEmbed,
                         TimeTextEmbedding, scan_rope)


class UViT(nn.Module):
    def __init__(self, output_channels: int = 3, patch_size: int = 16, emb_features: int = 768,
                 num_layers: int = 12, num_heads: int = 12, use_projection: bool = False,
                 use_self_and_cross: bool = False, backend: str = "auto",
                 force_fp32_for_softmax: bool = True,
                 activation: Union[str, Callable] = "swish", dtype=None,
                 precision: Optional[str] = None, add_residualblock_output: bool = False,
                 norm_epsilon: float = 1e-5, use_hilbert: bool = False,
                 max_image_size: int = 512, in_channels: int = 3,
                 context_dim: Optional[int] = None, device: DeviceLike = None):
        super().__init__()
        if num_layers % 2:
            raise ValueError("num_layers must be even for the U structure")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        self.activation = resolve_activation(activation)
        self.output_channels, self.patch_size = output_channels, patch_size
        self.num_layers, self.use_hilbert = num_layers, use_hilbert
        self.add_residualblock_output = add_residualblock_output
        p, d = patch_size, emb_features
        if use_hilbert:
            self.scan_proj = lecun_dense(p * p * in_channels, d, dtype, device)
        else:
            self.patch_embed = PatchEmbedding(in_channels, p, d, dtype, device)
        self.pos_enc = PositionalEncoding((max_image_size // p) ** 2, d, device)
        self.t_fourier = FourierEmbedding(d, device)
        self.t_proj = TimeProjection(d, d, None, device)
        self.text_proj = lecun_dense(context_dim, d, dtype, device) if context_dim else None
        # the blocks see no context: their sequence holds the text tokens
        block = lambda: TransformerBlock(
            d, None, heads=num_heads, dim_head=d // num_heads, backend=backend, dtype=dtype,
            use_projection=use_projection, use_self_and_cross=use_self_and_cross,
            device=device)
        half = num_layers // 2
        for i in range(half):
            self.add_module(f"down_{i}", block())
        self.mid = block()
        for i in range(half):
            self.add_module(f"up_fuse_{i}", lecun_dense(2 * d, d, dtype, device))
            self.add_module(f"up_{i}", block())
        self.final_norm = LayerNorm(d, norm_epsilon, device)
        self.final_proj = Dense(d, p * p * output_channels, torch.float32, device,
                                init_scale=0.0)
        if add_residualblock_output:
            self.final_conv1 = ConvLayer(in_channels + output_channels, 64, (3, 3), 1, dtype,
                                         device)
            self.final_conv_norm = LayerNorm(64, norm_epsilon, device)
            self.final_conv2 = ConvLayer(64, output_channels, (3, 3), 1, torch.float32, device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        b, h, w, _ = x.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        inv_idx = None
        if self.use_hilbert:
            raw, inv_idx = sfc_patchify(x, p, "hilbert")
            tokens = self.scan_proj(raw)
        else:
            tokens = self.patch_embed(x)
        tokens = self.pos_enc(tokens)
        t_emb = self.t_proj(self.t_fourier(temb))
        seq = [tokens, t_emb[:, None, :].to(tokens.dtype)]
        if textcontext is not None:
            if self.text_proj is None:
                raise ValueError("a text context needs context_dim at construction")
            seq.append(self.text_proj(textcontext).to(tokens.dtype))
        hid = torch.cat(seq, dim=1)

        half = self.num_layers // 2
        skips = []
        for i in range(half):
            hid = getattr(self, f"down_{i}")(hid)
            skips.append(hid)
        hid = self.mid(hid)
        for i in range(half):
            hid = getattr(self, f"up_fuse_{i}")(torch.cat([hid, skips.pop()], dim=-1))
            hid = getattr(self, f"up_{i}")(hid)

        patches = self.final_proj(self.final_norm(hid)[:, :hp * wp])
        c = self.output_channels
        img = (sfc_unpatchify(patches, inv_idx, p, h, w, c) if inv_idx is not None
               else unpatchify(patches, p, h, w, c))
        if self.add_residualblock_output:
            img = torch.cat([x.to(img.dtype), img], dim=-1)
            img = self.activation(self.final_conv_norm(self.final_conv1(img)))
            img = self.final_conv2(img)
        return img


class SimpleUDiT(nn.Module):
    def __init__(self, output_channels: int = 3, patch_size: int = 16, emb_features: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 backend: str = "auto", dtype=None, precision: Optional[str] = None,
                 force_fp32_for_softmax: bool = True, norm_epsilon: float = 1e-5,
                 use_hilbert: bool = False, use_zigzag: bool = False,
                 fused_epilogues: bool = True, in_channels: int = 3,
                 context_dim: Optional[int] = None, device: DeviceLike = None):
        super().__init__()
        if num_layers % 2:
            raise ValueError("num_layers must be even for the U structure")
        if use_hilbert and use_zigzag:
            raise ValueError("use_hilbert and use_zigzag are mutually exclusive")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        self.scan_order = "hilbert" if use_hilbert else "zigzag" if use_zigzag else "raster"
        self.output_channels, self.patch_size = output_channels, patch_size
        self.emb_features, self.num_heads, self.num_layers = emb_features, num_heads, num_layers
        d = emb_features
        self.embed = ScanPatchEmbed(in_channels, patch_size, d, self.scan_order, dtype=dtype,
                                    device=device)
        self.cond = TimeTextEmbedding(d, mlp_ratio, context_dim, dtype, device)
        block = lambda: DiTBlock(d, num_heads, mlp_ratio, backend, dtype, norm_epsilon, device,
                                 fused_epilogues=fused_epilogues)
        half = num_layers // 2
        for i in range(half):
            self.add_module(f"down_{i}", block())
        self.mid = block()
        for i in range(half):
            self.add_module(f"up_fuse_{i}", lecun_dense(2 * d, d, dtype, device))
            self.add_module(f"up_{i}", block())
        self.final_norm = LayerNorm(d, norm_epsilon, device)
        self.final_proj = Dense(d, patch_size ** 2 * output_channels, torch.float32, device,
                                init_scale=0.0)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None,
                cache_mode: Optional[str] = None, **cache_args) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        if cache_mode is not None or cache_args:
            raise NotImplementedError(CACHE_NOT_PORTED)
        _, h, w, _ = x.shape
        p = self.patch_size
        tokens, inv_idx = self.embed(x)
        cond = self.cond(temb, textcontext)
        freqs = scan_rope(self.emb_features // self.num_heads, (h // p) * (w // p),
                          self.scan_order, x.device)
        half = self.num_layers // 2
        skips = []
        for i in range(half):
            tokens = getattr(self, f"down_{i}")(tokens, cond, freqs)
            skips.append(tokens)
        tokens = self.mid(tokens, cond, freqs)
        for i in range(half):
            tokens = getattr(self, f"up_fuse_{i}")(torch.cat([tokens, skips.pop()], dim=-1))
            tokens = getattr(self, f"up_{i}")(tokens, cond, freqs)
        tokens = self.final_proj(self.final_norm(tokens))
        c = self.output_channels
        if inv_idx is not None:
            return sfc_unpatchify(tokens, inv_idx, p, h, w, c)
        return unpatchify(tokens, p, h, w, c)
