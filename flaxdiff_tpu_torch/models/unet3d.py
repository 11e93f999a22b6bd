"""3D (video) UNet (counterpart of ``flaxdiff_tpu/models/unet3d.py``).

The input is a clip [B, F, H, W, C]. Frames fold into the batch for every
spatial layer (the residual blocks run the fused GroupNorm + SiLU kernels,
the spatial transformer the flash and GEGLU kernels); the time embedding
and the text context repeat per frame (``repeat_interleave``, as
``jnp.repeat``). Each level block adds two temporal layers over the frame
axis:

- ``TemporalConvLayer``: three (GroupNorm, SiLU, (3, 1, 1) convolution)
  stages, the last convolution zero-initialised, so a fresh layer is the
  identity. Its GroupNorms reduce each group over the whole clip (F, H, W),
  as flax's GroupNorm does on the 5D tensor.
- ``TemporalAttention``: GroupNorm over the clip, then RoPE self-attention
  whose tokens are the F frames of each of the B*H*W pixels (head dim
  ``max(C // heads, 1)``, padded by the dispatch to what the flash kernels
  take; 320 runs the wide kernels), its output projection zero-initialised.

Module names follow the flax tree, so ``convert.state_dict_from_flax``
converts it name for name; the (3, 1, 1, I, O) kernels become
[O, I, 3, 1, 1]. As with the 2D UNet, torch needs ``in_channels`` and
``context_dim`` up front. ``remat`` recomputes each level block's
activations in the backward pass (``nn.remat`` in JAX).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import resolve_activation, resolve_dtype, resolve_precision
from .attention import TransformerBlock
from .common import (ConvLayer, Downsample, FourierEmbedding, GroupNorm, ResidualBlock,
                     TimeProjection, Upsample, _variance_scaling_, compute_dtype, remat_call)
from .vit_common import RoPEAttention


class TemporalConv(nn.Module):
    """``nn.Conv(features, (3, 1, 1), padding=((1, 1), (0, 0), (0, 0)))`` over
    a clip [B, F, H, W, C]: a convolution over the frames alone, computed
    channels-last as one matmul of the three frame-shifted inputs side by
    side (no layout change around it). The weight is [O, I, 3, 1, 1];
    lecun normal, or zeros with ``zero``."""

    def __init__(self, in_features: int, features: int, dtype=None, device=None,
                 zero: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 1, 1, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        _variance_scaling_(self.weight, in_features * 3, features * 3, 0.0 if zero else 1.0,
                           "fan_in")

    def forward(self, x5: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x5)
        f = x5.shape[1]
        xp = F.pad(x5.to(dt), (0, 0, 0, 0, 0, 0, 1, 1))
        cols = torch.cat([xp[:, k:k + f] for k in range(3)], dim=-1)   # [..., (k, I)]
        w = self.weight[..., 0, 0].permute(0, 2, 1).reshape(self.weight.shape[0], -1)
        return F.linear(cols, w.to(dt), self.bias.to(dt))


class TemporalConvLayer(nn.Module):
    """Three (GroupNorm over the clip, SiLU, temporal conv) stages, the last
    conv zero-initialised, plus the input; over [B*F, H, W, C] given F."""

    def __init__(self, channels: int, features: int, norm_groups: int = 8, dtype=None,
                 device=None):
        super().__init__()
        widths = ((channels, features), (features, channels), (channels, channels))
        for i, (cin, cout) in enumerate(widths, start=1):
            self.add_module(f"t{i}_norm", GroupNorm(cin, norm_groups, device=device))
            self.add_module(f"t{i}_conv", TemporalConv(cin, cout, dtype, device, zero=i == 3))

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        bf, h, w, c = x.shape
        x5 = x.reshape(bf // num_frames, num_frames, h, w, c)
        h5 = x5
        for i in (1, 2, 3):
            h5 = getattr(self, f"t{i}_conv")(F.silu(getattr(self, f"t{i}_norm")(h5)))
        return (x5 + h5).reshape(bf, h, w, c)


class TemporalAttention(nn.Module):
    """GroupNorm over the clip, then RoPE self-attention over the frames of
    each pixel (tokens [B*H*W, F, C]); the output projection starts at zero,
    so a fresh layer is the identity."""

    def __init__(self, features: int, heads: int = 4, norm_groups: int = 8,
                 backend: str = "auto", dtype=None, device=None):
        super().__init__()
        self.norm = GroupNorm(features, norm_groups, device=device)
        self.attn = RoPEAttention(features, heads, max(features // heads, 1), backend, dtype,
                                  device=device)
        nn.init.zeros_(self.attn.to_out.weight)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        bf, h, w, c = x.shape
        b = bf // num_frames
        x5 = x.reshape(b, num_frames, h, w, c)
        # [B, F, H, W, C] -> [B*H*W, F, C], contiguous for the kernels' strides
        tokens = self.norm(x5).permute(0, 2, 3, 1, 4).reshape(b * h * w, num_frames, c)
        tokens = self.attn(tokens)
        h5 = tokens.reshape(b, h, w, num_frames, c).permute(0, 3, 1, 2, 4)
        return (x5 + h5).reshape(bf, h, w, c)


class UNet3DBlock(nn.Module):
    """Spatial residual block -> temporal conv -> with attention, spatial
    transformer (self + cross to the text) -> temporal attention."""

    def __init__(self, in_features: int, features: int, emb_features: int, heads: int = 4,
                 use_attention: bool = False, norm_groups: int = 8, backend: str = "auto",
                 dtype=None, context_dim: Optional[int] = None,
                 activation: Callable = F.silu, device=None):
        super().__init__()
        self.res = ResidualBlock(in_features, features, emb_features, norm_groups, dtype,
                                 device, activation)
        self.temp_conv = TemporalConvLayer(features, features, norm_groups, dtype, device)
        self.use_attention = use_attention
        if use_attention:
            self.spatial_attn = TransformerBlock(features, context_dim, heads=heads,
                                                 dim_head=features // heads, backend=backend,
                                                 dtype=dtype, use_projection=True,
                                                 device=device)
            self.temporal_attn = TemporalAttention(features, heads, norm_groups, backend,
                                                   dtype, device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, context: Optional[torch.Tensor],
                num_frames: int) -> torch.Tensor:
        x = self.temp_conv(self.res(x, temb), num_frames)
        if self.use_attention:
            x = self.temporal_attn(self.spatial_attn(x, context), num_frames)
        return x


class UNet3D(nn.Module):
    """Text-conditional video UNet over [B, F, H, W, C]; returns
    [B, F, H, W, output_channels] in f32.

    ``down_block_additional_residuals`` (one per skip) and
    ``mid_block_additional_residual`` are ControlNet-style additions to the
    skips and the middle block's output."""

    def __init__(self, output_channels: int = 3, emb_features: int = 256,
                 feature_depths: Sequence[int] = (64, 128, 256),
                 attention_levels: Sequence[bool] = (False, True, True),
                 num_res_blocks: int = 2, heads: int = 4, norm_groups: int = 8,
                 backend: str = "auto", dtype=None, precision: Optional[str] = None,
                 activation: Union[str, Callable] = "swish", remat: bool = False,
                 in_channels: int = 3, context_dim: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        self.activation = resolve_activation(activation)
        self.feature_depths = tuple(feature_depths)
        self.attention_levels = tuple(attention_levels)
        self.num_res_blocks = num_res_blocks
        self.remat = remat
        levels = len(self.feature_depths)

        def block(name, cin, cout, attn):
            self.add_module(name, UNet3DBlock(cin, cout, emb_features, heads, attn, norm_groups,
                                              backend, dtype, context_dim, self.activation,
                                              device))

        self.t_fourier = FourierEmbedding(emb_features, device)
        self.t_proj = TimeProjection(emb_features, emb_features, device=device)
        ch = self.feature_depths[0]
        self.conv_in = ConvLayer(in_channels, ch, (3, 3), 1, dtype, device, init_mode="fan_in")
        skip_ch = [ch]
        for i, feats in enumerate(self.feature_depths):
            for j in range(num_res_blocks):
                block(f"down_{i}_{j}", ch, feats, self.attention_levels[i])
                ch = feats
                skip_ch.append(ch)
            if i < levels - 1:
                self.add_module(f"downsample_{i}", Downsample(ch, feats, dtype, device))
                skip_ch.append(feats)
        block("mid", ch, self.feature_depths[-1], True)
        ch = self.feature_depths[-1]
        for i, feats in enumerate(reversed(self.feature_depths)):
            level = levels - 1 - i
            for j in range(num_res_blocks + 1):
                block(f"up_{i}_{j}", ch + skip_ch.pop(), feats, self.attention_levels[level])
                ch = feats
            if level > 0:
                self.add_module(f"upsample_{i}", Upsample(ch, feats, dtype, device))
        self.norm_out = GroupNorm(ch, norm_groups, device=device)
        self.conv_out = ConvLayer(ch, output_channels, (3, 3), 1, torch.float32, device,
                                  init_scale=0.0)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.ndim != 5:
            raise ValueError(f"UNet3D expects [B,F,H,W,C], got {tuple(x.shape)}")
        b, f, h, w, c = x.shape
        blk = lambda name: functools.partial(remat_call, getattr(self, name), self.remat)
        levels = len(self.feature_depths)
        t = self.t_proj(self.t_fourier(temb))
        tf = t.repeat_interleave(f, dim=0)
        ctx = None if textcontext is None else textcontext.repeat_interleave(f, dim=0)
        hidden = self.conv_in(x.reshape(b * f, h, w, c))
        skips = [hidden]
        for i in range(levels):
            for j in range(self.num_res_blocks):
                hidden = blk(f"down_{i}_{j}")(hidden, tf, ctx, f)
                skips.append(hidden)
            if i < levels - 1:
                hidden = getattr(self, f"downsample_{i}")(hidden)
                skips.append(hidden)
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(skips):
                raise ValueError(f"expected {len(skips)} additional residuals, got "
                                 f"{len(down_block_additional_residuals)}")
            skips = [s + r for s, r in zip(skips, down_block_additional_residuals)]
        hidden = blk("mid")(hidden, tf, ctx, f)
        if mid_block_additional_residual is not None:
            hidden = hidden + mid_block_additional_residual
        for i in range(levels):
            for j in range(self.num_res_blocks + 1):
                hidden = torch.cat([hidden, skips.pop()], dim=-1)
                hidden = blk(f"up_{i}_{j}")(hidden, tf, ctx, f)
            if i < levels - 1:
                hidden = getattr(self, f"upsample_{i}")(hidden)
        out = self.conv_out(self.activation(self.norm_out(hidden)))
        return out.reshape(b, f, h, w, out.shape[-1])
